"""``test_env`` — signature-compatible port of reference
``src/testing.py:12-85``, operating on the host Gymnasium wrappers
(``marl_sortingenv_tpu_torch.envs``).

The port of ``marl_sortingenv_tpu.testing``: a model is an
``models.mlp.ActorCritic`` (its ``predict_deterministic`` on the env's
device), or an SB3-style object with ``.predict``.  As in the reference,
the ``action=None, mode=...`` calling convention only works with
``Env_3_Monolith`` (Env_1/Env_2 step signatures take the action
directly).  An episode that ends renders its dashboard, which needs
matplotlib."""

from __future__ import annotations

import numpy as np
import torch

from .models import mlp


def test_env(env=None, tag="", save=False, title="", steps=50, dir="./img/",
             seed=None, show=False, stats=True, mode="model", model=None,
             use_action_masking=True):
    """Run one evaluation episode; returns (cumulative_reward_from_logs,
    action_sequence)."""
    if env is None:
        raise ValueError("Environment must be provided")

    obs, info = env.reset(seed=seed)
    action_sequence = []
    cumulative_reward = 0.0

    for i in range(steps):
        action = None
        if mode == "model" and model is not None:
            if isinstance(model, mlp.ActorCritic):
                dev = next(model.parameters()).device
                mask = None
                if use_action_masking and hasattr(env, "action_masks"):
                    mask = torch.as_tensor(env.action_masks(), device=dev)
                with torch.no_grad():
                    a = model.predict_deterministic(
                        torch.as_tensor(np.asarray(obs), device=dev), mask)
                action = int(a)
            else:  # object with .predict (SB3-style)
                if use_action_masking and hasattr(env, "action_masks"):
                    action, _ = model.predict(
                        obs, deterministic=True,
                        action_masks=env.action_masks())
                else:
                    action, _ = model.predict(obs, deterministic=True)
                action = int(action)

        obs, reward, done, _, info = env.step(
            action=action, mode=mode, use_action_masking=use_action_masking)
        cumulative_reward += reward
        action_sequence.append(info.get("action", action))

        if done:
            if stats:
                print(f"\n---- Testing Results - {mode} ----")
                print(f"🏁 Epoch ended after {i + 1} steps.")
            env.render(save=save, log_dir=dir,
                       filename=f"{tag}_env_simulation", title=title,
                       show=show, checksum=stats, steps_test=steps)
            total = float(np.sum(env.reward_data["Total"]))
            if stats:
                print(f"👑 Total Reward: {total:.2f}")
            break

    if env.reward_data.get("Total"):
        final_cumulative = float(np.sum(env.reward_data["Total"]))
    else:
        final_cumulative = cumulative_reward
    return final_cumulative, action_sequence
