"""learner.rollout_policy_us: the mean host time of the policy in a
rollout step (the program span ``rollout.policy``: masks, key split,
sample) over the traced slice, in us."""

from portbench.lib import program_spans


def read(r):
    return program_spans.mean_us("rollout.policy")
