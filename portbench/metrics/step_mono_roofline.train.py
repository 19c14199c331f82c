"""step_mono_roofline.train: kernel 1's frozen bound over its device time
in the traced iterations, in %."""

from portbench.lib import readers


def read(r):
    return readers.roofline(r, "step_mono")
