"""``Env_3_Monolith`` driven by external actions, on the parity engine's
plain version: what the port's Gymnasium drop-in returns for each
``reset(seed=...)`` and ``step(action)``, computed afresh."""

from __future__ import annotations

import numpy as np
import torch

from .. import config as C
from . import dynamics as D
from . import state as S
from . import step as ST


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class MonolithEnv:
    """One env: ``reset(seed) -> (obs, mask)``, ``step(action) -> (obs,
    reward, terminated, truncated, mask)``; obs f32[29], mask bool[22]
    (the press mask twice, as ``monolith_action_masks``)."""

    def __init__(self, cfg: C.SimConfig, device="cpu"):
        self.cfg, self.device = cfg, torch.device(device)
        self.state = None

    def _mask(self) -> np.ndarray:
        m = _np(D.press_action_masks(self.cfg, self.state)[0]).astype(bool)
        return np.concatenate([m, m])

    def reset(self, seed: int):
        self.state = S.reset(self.cfg, seed, self.device)
        obs = _np(D.get_mono_obs(self.cfg, self.state)[0])
        return obs.astype(np.float32), self._mask()

    def step(self, action: int):
        act = torch.full((1,), int(action), dtype=torch.int32,
                         device=self.device)
        self.state, out = ST.step_mono_external(self.cfg, self.state, act,
                                                True)
        obs = _np(out.obs[0]).astype(np.float32)
        return (obs, float(out.reward[0]), bool(out.terminated[0]), False,
                self._mask())
