"""mfu.train: the model FLOPs of the window's PPO iterations (rollout
forwards of both towers and the frozen sort agent, forward and backward of
every sample in every epoch) over the window's time, as % of the card's
f32 peak.  The traced run's window is timed as the untraced one is: the
learner's spans come after it."""

from portbench.lib import readers


def read(r):
    p = r.params
    per_it = r.work.train_iteration_flops(
        p["variant"], p["n_envs"], p["n_steps"], p["n_epochs"],
        bool(p.get("sort_agent")))
    return readers.mfu(r, per_it * r.window["iterations"],
                       r.window["seconds"])
