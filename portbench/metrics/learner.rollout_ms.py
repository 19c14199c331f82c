"""learner.rollout_ms: the mean of the synchronised ``collect_rollout``
span per PPO iteration, over the iterations that follow a traced run's
window, in ms."""

from portbench.lib import readers


def read(r):
    return readers.mean_ms(r, "collect_rollout")
