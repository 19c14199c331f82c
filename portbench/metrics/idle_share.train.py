"""idle_share.train: the share of the traced iterations' time with nothing
on the device, in %."""

from portbench.lib import readers


def read(r):
    return readers.idle_share(r)
