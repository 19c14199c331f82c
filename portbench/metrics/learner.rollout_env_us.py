"""learner.rollout_env_us: the mean host time of the autoreset env step
in a rollout step (the program span ``rollout.env``) over the traced
slice, in us."""

from portbench.lib import program_spans


def read(r):
    return program_spans.mean_us("rollout.env")
