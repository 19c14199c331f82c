"""kernels_per_env_step.train_press: device operations per batched env
step of the traced press iterations (the frozen-sort step, its eager
autoreset, the policy, the update's share)."""

from portbench.lib import readers


def read(r):
    return readers.ops_per_step(r)
