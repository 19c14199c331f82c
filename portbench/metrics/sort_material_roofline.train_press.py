"""sort_material_roofline.train_press: kernel 2's frozen bound over its
device time in the traced press iterations (one launch a rollout step,
inside the rollout graph), in %."""

from portbench.lib import readers


def read(r):
    return readers.roofline(r, "sort_material")
