"""Gym-contract validation — the reference runs SB3's ``check_env`` on
every training env (``training.py:18,71``).  SB3 is not a dependency
here, so this standalone checker validates the same contract on the host
wrappers: space shapes/dtypes, reset/step signatures and return
structure, observation containment, mask well-formedness, determinism of
seeded resets.

The port's copy of ``marl_sortingenv_tpu.utils.env_checker`` (NumPy
only)."""

from __future__ import annotations

import numpy as np


def check_env(env, n_steps: int = 10, seed: int = 0) -> None:
    """Raises AssertionError on contract violations."""
    obs, info = env.reset(seed=seed)
    assert isinstance(info, dict), "reset info must be a dict"
    obs = np.asarray(obs)
    shape = tuple(env.observation_space.shape)
    assert obs.shape == shape, (obs.shape, shape)
    assert obs.dtype == np.float32, obs.dtype

    n_actions = env.action_space.n
    if hasattr(env, "action_masks"):
        mask = np.asarray(env.action_masks())
        assert mask.shape == (n_actions,), mask.shape
        assert mask.dtype == bool
        assert mask.any(), "mask must always allow at least one action"

    # seeded determinism
    obs2, _ = env.reset(seed=seed)
    np.testing.assert_array_equal(obs, np.asarray(obs2))

    for t in range(n_steps):
        if hasattr(env, "action_masks"):
            valid = np.flatnonzero(env.action_masks())
            action = int(valid[t % len(valid)])
        else:
            action = t % n_actions
        out = env.step(action)
        assert len(out) == 5, "step must return (obs, r, term, trunc, info)"
        obs, reward, terminated, truncated, info = out
        obs = np.asarray(obs)
        assert obs.shape == shape
        assert np.isfinite(reward)
        assert isinstance(terminated, (bool, np.bool_))
        assert isinstance(truncated, (bool, np.bool_))
        assert isinstance(info, dict)
        lo = np.asarray(env.observation_space.low, np.float32)
        hi = np.asarray(env.observation_space.high, np.float32)
        assert (obs >= lo - 1e-6).all() and (obs <= hi + 1e-6).all(), (
            "observation out of bounds")
