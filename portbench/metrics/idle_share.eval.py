"""idle_share.eval: the share of the traced slice's time with nothing on
the device, in %."""

from portbench.lib import readers


def read(r):
    return readers.idle_share(r)
