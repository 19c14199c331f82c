"""sort_material_roofline.eval: kernel 2's frozen bound over its device
time in the traced slice (Random, PPO Sort-Only, PPO Modular), in %."""

from portbench.lib import readers


def read(r):
    return readers.roofline(r, "sort_material")
