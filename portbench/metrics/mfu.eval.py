"""mfu.eval: the agents' forward FLOPs of the window's passes over the
window's time, as % of the card's f32 peak."""

from portbench.lib import readers


def read(r):
    return readers.mfu(r, r.window["flops"], r.window["seconds"])
