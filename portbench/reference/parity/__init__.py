"""The parity engine's plain version, the reference of the gym cell.

Frozen copies of the port's ``core/{rng,state,dynamics,step,
reward_tables}.py``: NumPy's PCG64 streams with u64 held in int64, the
plant's dynamics in float64, bit for bit the port's parity engine (and so
the MARL-SortingEnv reference) on either device.
``set_float`` switches the engine's float type, for the control that
computes the reference in float32.
"""

from __future__ import annotations

import torch


def set_float(dtype: torch.dtype) -> None:
    """Compute the engine's floats in ``dtype``: ``torch.float64`` as the
    configuration states, ``torch.float32`` for the control."""
    from . import dynamics, rng, state, step
    for mod in (dynamics, rng, state, step):
        mod.F64 = dtype
    dynamics._CONSTS.clear()
    dynamics._sorting_table_on.cache_clear()
