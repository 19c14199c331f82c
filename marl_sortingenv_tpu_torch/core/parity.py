"""The bit-exact parity engine under the names the learner takes from an
engine module (``learn/ppo.py``'s ``ENGINES``), the names ``core/fastb.py``
and ``core/fast.py`` offer: the steps of ``core/step.py``, the autoreset
wrapper of ``core/wrappers.py``, the masks and observations of
``core/dynamics.py`` and a seeded ``reset_batch``."""

from __future__ import annotations

import numpy as np

from ..config.config import SimConfig
from .dynamics import (get_mono_obs, get_press_obs, get_sort_obs,
                       monolith_action_masks, press_action_masks)
from .state import EnvState, reset
from .step import step_mono_external, step_press, step_sort
from .wrappers import with_autoreset

__all__ = ["get_mono_obs", "get_press_obs", "get_sort_obs",
           "monolith_action_masks", "press_action_masks", "reset_batch",
           "step_mono_external", "step_press", "step_sort", "with_autoreset"]


def reset_batch(cfg: SimConfig, seed0: int, n: int,
                device="cuda") -> EnvState:
    """``n`` fresh envs, of seeds seed0, seed0 + 1, ..., seed0 + n - 1."""
    return reset(cfg, np.arange(seed0, seed0 + n), device=device)
