"""kernels_per_env_step.train: device operations per batched env step of
the traced iterations, the update's included."""

from portbench.lib import readers


def read(r):
    return readers.ops_per_step(r)
