"""gym.read_wait_ms: the host's time in counted device-to-host reads (the
program span ``rng.host_read``: the wait for the device and the copy)
inside ``env.step`` and ``env.action_masks``, per ``env.step`` of the
traced slice, in ms."""

from portbench.lib import program_spans


def read(r):
    n = program_spans.count("env.step")
    if not n:
        return None
    us = program_spans.total_us_within(
        "rng.host_read", ("env.step", "env.action_masks"))
    return us / n / 1e3
