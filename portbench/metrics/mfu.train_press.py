"""mfu.train_press: the model FLOPs of the window's press iterations
(rollout forwards of both towers and of the frozen sort agent's pi, forward
and backward of every sample in every epoch) over the window's time, as %
of the card's f32 peak."""

from portbench.lib import readers


def read(r):
    p = r.params
    per_it = r.work.train_iteration_flops(
        p["variant"], p["n_envs"], p["n_steps"], p["n_epochs"],
        bool(p.get("sort_agent")))
    return readers.mfu(r, per_it * r.window["iterations"],
                       r.window["seconds"])
