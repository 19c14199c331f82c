"""idle_share.train_press: the share of the traced press iterations' time
with nothing on the device, in %."""

from portbench.lib import readers


def read(r):
    return readers.idle_share(r)
