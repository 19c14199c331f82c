"""One Gymnasium env stepped as a MaskablePPO loop: the generator of the
``gym_*`` mixes.

Parameters: ``env`` (a class of ``envs.py``), ``slice_steps`` (steps in
the traced slice), ``check_episodes`` (episodes the check replays) and
``limits``.
The env takes the configuration's ``max_steps``, ``noise_sorting`` and
``balesize``.

The client draws each action uniformly from ``action_masks()`` with a
NumPy ``Generator`` seeded from the run's seed, standing in for the
agent, and resets with the next seed of its own when an episode ends.
One sample is ``action_masks()`` plus ``step(action)``, by the host's
clock (``step`` returns host arrays, so it has waited for the card).
Every step's action and outputs are kept; the check draws episodes from
the seed and replays them on the reference engine on the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.lib.cell import Check, Window
from portbench.lib.trace import Spans


class Episode:
    """One episode as the client saw it: the reset's seed and obs, then per
    step the mask read before the action, the action and ``(obs, reward,
    terminated, truncated)``."""

    def __init__(self, seed, obs):
        self.seed, self.obs0 = seed, obs
        self.masks, self.actions, self.outs = [], [], []


def same_step(a, b) -> bool:
    """Two ``(obs, reward, terminated, truncated)``, every value exact."""
    return (np.array_equal(a[0], b[0]) and a[1] == b[1] and a[2] == b[2]
            and a[3] == b[3])


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.cell.traffic
        self.sim = ctx.cell.config["sim"]
        (self.env_seed, self.base, self.client_seed, self.warm_seed,
         self.draw_seed) = ctx.sub_seeds(5)
        self.spans = Spans(sync=False)
        self.launches, self.slice_steps = [], 0
        self.episodes = []

    def setup(self):
        from marl_sortingenv_tpu_torch import envs
        s = self.sim
        self.env = getattr(envs, self.p["env"])(
            max_steps=s["max_steps"], seed=self.env_seed,
            noise_sorting=s["noise_sorting"], balesize=s["balesize"],
            device=self.ctx.device)
        # one whole episode on seeds of its own, so that every kernel the
        # loop meets has been loaded
        rng = np.random.default_rng(self.warm_seed)
        self.env.reset(seed=self.warm_seed)
        for _ in range(s["max_steps"]):
            a = int(rng.choice(np.flatnonzero(self.env.action_masks())))
            _, _, term, trunc, _ = self.env.step(a)
            if term or trunc:
                break
        self.rng = np.random.default_rng(self.client_seed)

    def _reset(self):
        seed = self.base + len(self.episodes)
        obs, _ = self.env.reset(seed=seed)
        self.episodes.append(Episode(seed, obs))
        return self.episodes[-1]

    def window(self, seconds: float) -> Window:
        from marl_sortingenv_tpu_torch.core import rng as R
        env, samples = self.env, []
        syncs0 = R.HOST_SYNCS
        t_start = time.perf_counter()
        ep = self._reset()
        while True:
            t0 = time.perf_counter()
            mask = env.action_masks()
            t1 = time.perf_counter()
            a = int(self.rng.choice(np.flatnonzero(mask)))
            t2 = time.perf_counter()
            obs, r, term, trunc, _ = env.step(a)
            t3 = time.perf_counter()
            samples.append((t1 - t0) + (t3 - t2))
            ep.masks.append(mask)
            ep.actions.append(a)
            ep.outs.append((obs, r, term, trunc))
            if t3 - t_start >= seconds:
                break
            if term or trunc:
                ep = self._reset()
        secs = time.perf_counter() - t_start
        ms = np.asarray(samples) * 1e3
        return Window(
            metrics={"gym_step_ms.p95": float(np.percentile(ms, 95))},
            attempted=len(samples), failed=0,
            facts={"seconds": secs, "steps": len(samples), "step_ms": ms,
                   "host_syncs": R.HOST_SYNCS - syncs0})

    def traced_slice(self):
        env, rng = self.env, np.random.default_rng(self.warm_seed)
        env.reset(seed=self.warm_seed)
        for _ in range(self.p["slice_steps"]):
            with self.spans.span("action_masks"):
                mask = env.action_masks()
            a = int(rng.choice(np.flatnonzero(mask)))
            with self.spans.span("step"):
                _, _, term, trunc, _ = env.step(a)
            if term or trunc:
                with self.spans.span("reset"):
                    env.reset(seed=self.warm_seed)
        self.slice_steps = self.p["slice_steps"]

    def release(self):
        self.env = None
        if self.ctx.device == "cuda":
            torch.cuda.empty_cache()

    def drawn(self) -> list:
        rng = np.random.default_rng(self.draw_seed)
        k = min(self.p["check_episodes"], len(self.episodes))
        return sorted(int(i) for i in rng.choice(len(self.episodes), k,
                                                 replace=False))

    def replay(self, ep: Episode, float64: bool = True) -> int:
        """Steps of ``ep`` (its reset counted as one) whose outputs the
        reference does not give; with ``float64`` off the reference
        computes in float32 (the control)."""
        from portbench.reference import config as RC
        from portbench.reference import parity
        from portbench.reference.parity.env import MonolithEnv
        s = self.sim
        parity.set_float(torch.float64 if float64 else torch.float32)
        try:
            ref = MonolithEnv(RC.load_config(
                max_steps=s["max_steps"], noise_sorting=s["noise_sorting"],
                balesize=s["balesize"]), device="cpu")
            obs, mask = ref.reset(ep.seed)
            apart = int(not (np.array_equal(obs, ep.obs0)
                             and np.array_equal(mask, ep.masks[0])))
            for t, a in enumerate(ep.actions):
                *out, mask = ref.step(a)
                ok = same_step(out, ep.outs[t])
                if t + 1 < len(ep.masks):
                    ok = ok and np.array_equal(mask, ep.masks[t + 1])
                apart += int(not ok)
            return apart
        finally:
            parity.set_float(torch.float64)

    def check(self) -> list:
        apart = sum(self.replay(self.episodes[i]) for i in self.drawn())
        return [Check("steps_apart", float(apart),
                      self.p["limits"]["steps_apart"])]
