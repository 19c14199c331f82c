"""kernels_per_env_step.gym: device operations per Gym step (its
action_masks() and step()) of the traced slice."""

from portbench.lib import readers


def read(r):
    return readers.ops_per_step(r)
