"""idle_share.gym: the share of the traced Gym steps' time with nothing on
the device, in %."""

from portbench.lib import readers


def read(r):
    return readers.idle_share(r)
