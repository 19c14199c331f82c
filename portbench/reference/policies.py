"""The 5-policy evaluation's plain version: a frozen copy of the port's
``eval/harness.py::policy_steps`` and ``policy_totals`` on the fastb
engine's plain version.  Each policy's episodes reset from ``seed0`` and
step ``steps`` times in lockstep without autoreset; an episode's total is
its f32 rewards summed over the steps in f64 on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fastb as FB
from . import mlp
from ._device import resolve_device
from .config import SimConfig

POLICY_KEYS = ["Random", "Rule-Based", "PPO Sort-Only", "PPO Modular",
               "PPO Monolith"]


def policy_steps(cfg: SimConfig, policy: str, num_episodes: int,
                 steps: int, sort_params=None, press_params=None,
                 mono_params=None, use_action_masking: bool = True,
                 seed0: int = 1, device="cuda"):
    """The step outputs, one per step, of ``num_episodes`` lockstep
    episodes of one policy of ``POLICY_KEYS``."""
    dev = resolve_device(device)
    m = use_action_masking
    if policy == "Random":
        step = lambda s: FB.step_mono_random(cfg, s, m)  # noqa: E731
    elif policy == "Rule-Based":
        step = lambda s: FB.step_mono_rule(cfg, s)  # noqa: E731
    elif policy == "PPO Sort-Only":
        step = lambda s: FB.step_mono_model(  # noqa: E731
            cfg, s, sort_params, None, m)
    elif policy == "PPO Modular":
        step = lambda s: FB.step_mono_model(  # noqa: E731
            cfg, s, sort_params, press_params, m)
    elif policy == "PPO Monolith":
        if mono_params is None:
            raise ValueError("the PPO Monolith policy needs mono_params")
    else:
        raise ValueError(f"unknown policy {policy!r}")

    st = FB.reset_batch(cfg, seed0, num_episodes, device=dev)
    with torch.no_grad():
        if policy != "PPO Monolith":
            for _ in range(steps):
                st, out = step(st)
                yield out
            return
        # the monolith agent acts on the last observation, its logits
        # masked iff masking is on
        obs = FB.get_mono_obs(cfg, st)
        for _ in range(steps):
            logits = mono_params.policy_logits(obs)
            if m:
                logits = mlp.masked_logits(
                    logits, FB.monolith_action_masks(cfg, st))
            st, out = FB.step_mono_external(cfg, st,
                                            FB.agent_argmax(logits), m)
            obs = out.obs
            yield out


def policy_totals(cfg: SimConfig, policy: str, num_episodes: int,
                  steps: int, sort_params=None, press_params=None,
                  mono_params=None, use_action_masking: bool = True,
                  seed0: int = 1, device="cuda") -> np.ndarray:
    """Each episode's summed reward, f64[num_episodes], for one policy."""
    rewards = torch.stack([out.reward for out in policy_steps(
        cfg, policy, num_episodes, steps, sort_params, press_params,
        mono_params, use_action_masking, seed0, device)])
    return np.asarray(rewards.cpu().numpy(), np.float64).sum(axis=0)
