"""The 5-policy evaluation, pass after pass: the generator of the
``eval_*`` mixes.

Parameters: ``episodes`` (lockstep episodes per policy), ``steps`` (per
episode, no autoreset), ``policies`` (in order, of Random, Rule-Based,
PPO Sort-Only, PPO Modular, PPO Monolith), ``masked``, ``slice_steps``
(steps of each policy in the traced slice), ``check_totals`` (the
policies whose episode totals the check compares), ``check_episodes`` and
``check_steps`` (the episodes drawn, and the first steps of each, whose
step outputs the check compares for every policy) and ``limits``.

A pass runs every policy once through ``eval.harness.policy_totals`` on
``fastb``, with the configuration's agents, its episodes reset from their
own seed; the window runs whole passes.  While the window runs, the
steps that ``policy_totals`` draws from ``harness.policy_steps`` pass
through unchanged, and of the first ``check_steps`` of each policy the
drawn episodes' rows of every output are kept, for one pass drawn from
the seed (uniformly, as the passes come).  The check runs the reference
over that pass: each policy's first steps, the ``check_totals`` policies
to the end, and counts the (policy, step, episode) outputs that differ
and the episodes whose total differs.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench.lib.cell import Check, Window
from portbench.lib.trace import Spans

AGENTS = ("sort", "press", "mono")


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.cell.traffic
        self.sim = ctx.cell.config["sim"]
        self.base, self.warm_seed, self.draw_seed = ctx.sub_seeds(3)
        self.spans = Spans(sync=False)
        self.launches, self.slice_steps = [], 0
        self.passes = []
        self.kept = None          # (pass, {policy: [outputs per step]})

    def _totals(self, policy: str, seed0: int):
        from marl_sortingenv_tpu_torch.eval import harness
        p = self.p
        return harness.policy_totals(
            self.cfg, policy, "fastb", p["episodes"], p["steps"],
            *self.agents, p["masked"], seed0, self.ctx.device)

    def setup(self):
        from marl_sortingenv_tpu_torch.config.config import load_config
        from marl_sortingenv_tpu_torch.eval import harness
        from marl_sortingenv_tpu_torch.models import mlp
        dev, p = self.ctx.device, self.p
        self.cfg = load_config(**self.sim)
        self.agents = [mlp.load_npz(self.ctx.agent_path(a), device=dev
                                    ).requires_grad_(False) for a in AGENTS]
        for policy in p["policies"]:
            gen = harness.policy_steps(
                self.cfg, policy, "fastb", p["episodes"], p["steps"],
                *self.agents, p["masked"], self.warm_seed, dev)
            for _ in range(2):
                next(gen).reward.sum().item()
            gen.close()

    def _rows(self):
        """The episodes whose step outputs the check compares."""
        rng = np.random.default_rng(self.draw_seed)
        return np.sort(rng.choice(self.p["episodes"],
                                  self.p["check_episodes"], replace=False))

    @contextlib.contextmanager
    def _captured(self, into: dict):
        """``harness.policy_steps`` yields its outputs unchanged, and
        keeps in ``into[policy]`` the drawn rows of the first
        ``check_steps`` of them."""
        from marl_sortingenv_tpu_torch.eval import harness
        saved, k, n = harness.policy_steps, self.p["check_steps"], \
            self.p["episodes"]
        idx = torch.as_tensor(self.rows, device=self.ctx.device)

        def steps(cfg, policy, *a, **kw):
            kept = into.setdefault(policy, [])
            for i, out in enumerate(saved(cfg, policy, *a, **kw)):
                if i < k:
                    kept.append(None if out.obs.shape[0] != n else
                                tuple(x.index_select(0, idx) for x in out))
                yield out
        harness.policy_steps = steps
        try:
            yield
        finally:
            harness.policy_steps = saved

    def window(self, seconds: float) -> Window:
        p = self.p
        self.rows = self._rows()
        draw = np.random.default_rng(self.draw_seed + 1)
        t0 = time.perf_counter()
        while True:
            j, kept = len(self.passes), {}
            with self._captured(kept):
                self.passes.append({pol: self._totals(pol, self.base + j)
                                    for pol in p["policies"]})
            if draw.random() * (j + 1) < 1.0:
                self.kept = (j, kept)
            if time.perf_counter() - t0 >= seconds:
                break
        secs = time.perf_counter() - t0
        from portbench.work import counts
        k = len(self.passes)
        steps = k * len(p["policies"]) * p["episodes"] * p["steps"]
        flops = k * p["steps"] * sum(
            counts.eval_step_flops(pol, p["episodes"]) for pol in
            p["policies"])
        return Window(metrics={"eval_env_steps_per_s": steps / secs},
                      attempted=k * len(p["policies"]) * p["episodes"],
                      failed=0,
                      facts={"seconds": secs, "passes": k,
                             "env_steps": steps, "flops": flops})

    def traced_slice(self):
        from marl_sortingenv_tpu_torch.eval import harness
        from marl_sortingenv_tpu_torch.ops import sort_cuda, step_cuda
        p, n = self.p, self.p["episodes"]
        variant = {"Rule-Based": "rule", "PPO Monolith": "external"}
        self.launches = []
        for policy in p["policies"]:
            n0 = step_cuda.LAUNCHES, sort_cuda.LAUNCHES
            with self.spans.span(policy):
                gen = harness.policy_steps(
                    self.cfg, policy, "fastb", n, p["steps"], *self.agents,
                    p["masked"], self.warm_seed, self.ctx.device)
                for _ in range(p["slice_steps"]):
                    next(gen)
                gen.close()
            self.launches += [
                ("step_mono", variant.get(policy, "external"), n,
                 step_cuda.LAUNCHES - n0[0]),
                ("sort_material", None, n, sort_cuda.LAUNCHES - n0[1])]
        self.slice_steps = p["slice_steps"] * len(p["policies"])

    def release(self):
        self.agents = None
        if self.ctx.device == "cuda":
            torch.cuda.empty_cache()

    def reference_pass(self, seed0: int, tf32: bool = False):
        """The reference over one pass: each policy's first
        ``check_steps`` outputs at the drawn rows, and the totals of the
        ``check_totals`` policies.  With ``tf32`` the agents' products run
        in TF32 (the control)."""
        from portbench.reference import config as RC
        from portbench.reference import mlp as RM
        from portbench.reference import policies as RP
        p, dev = self.p, self.ctx.device
        cfg = RC.load_config(**self.sim)
        agents = [RM.load_npz(self.ctx.agent_path(a), device=dev
                              ).requires_grad_(False) for a in AGENTS]
        idx = torch.as_tensor(self.rows, device=dev)
        outs, totals = {}, {}
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            for policy in p["policies"]:
                full = policy in p["check_totals"]
                gen = RP.policy_steps(cfg, policy, p["episodes"], p["steps"],
                                      *agents, p["masked"], seed0, dev)
                kept, rewards = [], []
                for i, out in enumerate(gen):
                    if i < p["check_steps"]:
                        kept.append(tuple(x.index_select(0, idx)
                                          for x in out))
                    elif not full:
                        break
                    rewards.append(out.reward)
                gen.close()
                outs[policy] = kept
                if full:
                    totals[policy] = np.asarray(
                        torch.stack(rewards).cpu().numpy(),
                        np.float64).sum(axis=0)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before
        return outs, totals

    def check(self) -> list:
        j, outs = self.kept
        ref_outs, ref_totals = self.reference_pass(self.base + j)
        return compare(outs, self.passes[j], ref_outs, ref_totals, self.p)


def steps_apart(prog: list, ref: list) -> int:
    """The (step, episode) pairs of one policy at which any output
    differs; a step the program did not give, or gave at another batch,
    counts whole."""
    apart = 0
    for i, want in enumerate(ref):
        got = prog[i] if i < len(prog) else None
        if got is None:
            apart += want[0].shape[0]
            continue
        differ = torch.zeros(want[0].shape[0], dtype=torch.bool)
        for a, b in zip(got, want):
            d = (a.cpu() != b.cpu()).reshape(b.shape[0], -1).any(dim=1)
            differ |= d
        apart += int(differ.sum())
    return apart


def compare(outs: dict, totals: dict, ref_outs: dict, ref_totals: dict,
            p: dict) -> list:
    """The numbers compared, with their limits (the mix's ``limits``)."""
    steps = sum(steps_apart(outs.get(pol, []), ref_outs[pol])
                for pol in ref_outs)
    episodes = sum(int(np.sum(totals[pol] != ref_totals[pol]))
                   for pol in ref_totals)
    return [Check("steps_apart", float(steps), p["limits"]["steps_apart"]),
            Check("episodes_apart", float(episodes),
                  p["limits"]["episodes_apart"])]
