"""Evaluation harness: the 5-policy benchmark protocol on the fast engines.

The port of ``run_engine_benchmark`` of ``marl_sortingenv_tpu.eval.harness``
(Random, Rule-Based, PPO Sort-Only, PPO Modular, PPO Monolith on the
monolith env, ``num_episodes`` lockstep instances from ``seed0``) on the
batch-last ``fastb`` engine or its batch-first view ``fast``.  The agents
are ``ActorCritic`` modules, the port's stand-in for the JAX package's
parameter pytrees.  The fast engines draw from threefry streams, so a
policy's mean and std over the episodes are what compare with the parity
protocol, not single episodes.

The rest of the JAX harness runs the bit-exact parity engine, which is not
ported yet: ``run_episode``, ``benchmark_seed_all``, ``run_model_benchmark``
and ``compare_engine_drift`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..config.config import SimConfig
from ..core import fast as FE
from ..core import fastb as FB
from ..models import mlp

POLICY_KEYS = ["Random", "Rule-Based", "PPO Sort-Only", "PPO Modular",
               "PPO Monolith"]


def _todo(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md {item})")


def run_episode(*args, **kw):
    _todo("harness.run_episode (the parity engine)", "Queue 1, items 5-6")


def benchmark_seed_all(*args, **kw):
    _todo("harness.benchmark_seed_all (the parity engine)",
          "Queue 1, items 5-6")


def run_model_benchmark(*args, **kw):
    _todo("harness.run_model_benchmark (the parity engine)",
          "Queue 1, items 5-6")


def compare_engine_drift(*args, **kw):
    _todo("harness.compare_engine_drift (the parity engine)",
          "Queue 1, items 5-6")


def policy_steps(cfg: SimConfig, policy: str, engine: str = "fastb",
                 num_episodes: int = 10, steps: int = 200,
                 sort_params=None, press_params=None, mono_params=None,
                 use_action_masking: bool = True, seed0: int = 1,
                 device="cuda"):
    """The step outputs, one per step, of ``num_episodes`` lockstep
    episodes of one policy of ``POLICY_KEYS`` on ``engine``: the episodes
    reset from ``seed0`` and step ``steps`` times without autoreset."""
    mod = {"fast": FE, "fastb": FB}[engine]
    dev = resolve_device(device)
    m = use_action_masking
    if policy == "Random":
        step = lambda s: mod.step_mono_random(cfg, s, m)  # noqa: E731
    elif policy == "Rule-Based":
        step = lambda s: mod.step_mono_rule(cfg, s)  # noqa: E731
    elif policy == "PPO Sort-Only":
        step = lambda s: mod.step_mono_model(  # noqa: E731
            cfg, s, sort_params, None, m)
    elif policy == "PPO Modular":
        step = lambda s: mod.step_mono_model(  # noqa: E731
            cfg, s, sort_params, press_params, m)
    elif policy == "PPO Monolith":
        if mono_params is None:
            raise ValueError("the PPO Monolith policy needs mono_params")
    else:
        raise ValueError(f"unknown policy {policy!r}")

    st = mod.reset_batch(cfg, seed0, num_episodes, device=dev)
    with torch.no_grad():
        if policy != "PPO Monolith":
            for _ in range(steps):
                st, out = step(st)
                yield out
            return
        # the monolith agent acts on the last observation, its logits
        # masked iff masking is on, as the JAX harness's scan does
        obs = mod.get_mono_obs(cfg, st)
        for _ in range(steps):
            logits = mono_params.policy_logits(obs)
            if m:
                logits = mlp.masked_logits(
                    logits, mod.monolith_action_masks(cfg, st))
            st, out = mod.step_mono_external(cfg, st,
                                             FB.agent_argmax(logits), m)
            obs = out.obs
            yield out


def policy_totals(cfg: SimConfig, policy: str, engine: str = "fastb",
                  num_episodes: int = 10, steps: int = 200,
                  sort_params=None, press_params=None, mono_params=None,
                  use_action_masking: bool = True, seed0: int = 1,
                  device="cuda") -> np.ndarray:
    """Each episode's summed reward, f64[num_episodes], for one policy
    (``policy_steps``).  The rewards stay on the device until the end and
    are summed over the steps in f64 on the host, as the JAX harness sums
    its scanned rewards."""
    rewards = torch.stack([out.reward for out in policy_steps(
        cfg, policy, engine, num_episodes, steps, sort_params, press_params,
        mono_params, use_action_masking, seed0, device)])
    return np.asarray(rewards.cpu().numpy(), np.float64).sum(axis=0)


def run_engine_benchmark(cfg: SimConfig, engine: str = "fastb",
                         num_episodes: int = 10, steps: int = 200,
                         sort_params=None, press_params=None,
                         mono_params=None, use_action_masking: bool = True,
                         include_random: bool = True, seed0: int = 1,
                         device="cuda"):
    """The 5-policy protocol on ``engine`` ('fastb' or 'fast'): returns
    ``{policy: {"mean", "std"}}`` over ``num_episodes`` lockstep episodes of
    ``steps`` steps (population std).  Random is left out unless
    ``include_random``, the monolith agent unless ``mono_params`` is
    given."""
    if engine not in ("fast", "fastb"):
        raise ValueError(f"unknown engine {engine!r}")
    summary = {}
    for key in POLICY_KEYS:
        if (key == "Random" and not include_random) or (
                key == "PPO Monolith" and mono_params is None):
            continue
        totals = policy_totals(
            cfg, key, engine, num_episodes, steps, sort_params,
            press_params, mono_params, use_action_masking, seed0, device)
        summary[key] = {"mean": float(totals.mean()),
                        "std": float(totals.std())}
    return summary
