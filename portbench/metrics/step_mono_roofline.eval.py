"""step_mono_roofline.eval: kernel 1's frozen bound over its device time in
the traced slice (Rule-Based, PPO Monolith), in %."""

from portbench.lib import readers


def read(r):
    return readers.roofline(r, "step_mono")
