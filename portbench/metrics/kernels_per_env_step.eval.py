"""kernels_per_env_step.eval: device operations per lockstep step of the
traced slice (the same steps of each policy)."""

from portbench.lib import readers


def read(r):
    return readers.ops_per_step(r)
