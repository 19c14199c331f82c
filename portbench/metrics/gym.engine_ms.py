"""gym.engine_ms: the mean host time of the engine call inside a Gym step
(the program span ``env.engine``) over the traced slice, in ms."""

from portbench.lib import program_spans


def read(r):
    us = program_spans.mean_us("env.engine")
    return None if us is None else us / 1e3
