"""PPO training, iteration after iteration: the generator of the
``train_*`` mixes.

Parameters (``portbench/traffic/<mix>.json``): ``variant`` (the agent
trained: sort, press or mono), ``n_envs``, ``n_steps``, ``batch_size``,
``n_epochs``, ``shuffle_block``, ``sort_agent`` (the configuration's agent
that drives the sorter of the press env, or null), ``check_iterations``
(the first iterations the reference follows), ``span_iterations``
(iterations after a traced run's window, each call into the learner
inside a synchronised span), ``slice_iterations`` (the traced slice) and
``limits`` (of the numbers compared, set from the
readings in ``PERF.md``).

Set-up builds one train state from the seed, as
``ppo.init_train_state`` does, and drives it through the first
``check_iterations`` iterations with the window's own call; the window
goes on from there.  The check runs the reference learner over the same
iterations from the same seeds and compares each iteration's loss, the
first iteration's gradients as Adam holds them (its first moment) and
the parameters' change, leaf by leaf.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench.lib.cell import Check, Window
from portbench.lib.trace import Spans

# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone: left out of the change
GRAD_FLOOR = 1e-3


def _flat(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).cpu() for p in
                      model.parameters()])


def _leaves(flat: torch.Tensor, shapes) -> list:
    out, i = [], 0
    for shp in shapes:
        k = int(np.prod(shp))
        out.append(flat[i:i + k].double())
        i += k
    return out


class Record:
    """What the first iterations produced: each loss, Adam's first moment
    after the first, the parameters before and after."""

    def __init__(self, losses, mu1, p0, p_end, shapes):
        self.losses, self.mu1 = losses, mu1
        self.p0, self.p_end, self.shapes = p0, p_end, shapes


def first_iterations(it, ts, k: int):
    """Drive ``ts`` through ``k`` iterations of ``it``: (the state after,
    the Record)."""
    p0 = _flat(ts.params)
    shapes = [tuple(p.shape) for p in ts.params.parameters()]
    losses, mu1 = [], None
    for i in range(k):
        ts, stats = it(ts)
        losses.append(float(stats["loss"]))
        if i == 0:
            mu1 = ts.opt_state.mu.detach().cpu().clone()
    return ts, Record(losses, mu1, p0, _flat(ts.params), shapes)


def _worst_leaf(prog: list, ref: list, keep=None) -> float:
    """The largest gap between the two sides' leaf norms, each over the
    larger of the reference leaf's norm and the median leaf's."""
    rn = [float(torch.linalg.vector_norm(r)) for r in ref]
    pn = [float(torch.linalg.vector_norm(p)) for p in prog]
    med = float(np.median(rn))
    idx = range(len(rn)) if keep is None else keep
    return max(abs(pn[i] - rn[i]) / max(rn[i], med, 1e-30) for i in idx)


def compare(prog: Record, ref: Record, limits: dict) -> list:
    """The numbers compared, with their limits (the mix's ``limits``)."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog.losses, ref.losses))
    g_p, g_r = (_leaves(r.mu1, r.shapes) for r in (prog, ref))
    grad = _worst_leaf(g_p, g_r)
    rn = [float(torch.linalg.vector_norm(r)) for r in g_r]
    med = float(np.median(rn))
    keep = [i for i, x in enumerate(rn) if x >= GRAD_FLOOR * med]
    d_p, d_r = (_leaves(r.p_end - r.p0, r.shapes) for r in (prog, ref))
    change = _worst_leaf(d_p, d_r, keep)
    return [Check("loss", loss, limits["loss"]),
            Check("grad", grad, limits["grad"]),
            Check("change", change, limits["change"])]


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.cell.traffic
        self.sim = ctx.cell.config["sim"]
        self.learn_seed, self.env_seed = ctx.sub_seeds(2)
        self.spans = Spans(sync=True)
        self.launches, self.slice_steps = [], 0

    # -- the program ------------------------------------------------------
    def _program(self):
        from marl_sortingenv_tpu_torch.config.config import load_config
        from marl_sortingenv_tpu_torch.learn import ppo
        from marl_sortingenv_tpu_torch.models import mlp
        p, dev = self.p, self.ctx.device
        cfg = load_config(**self.sim)
        pcfg = ppo.PPOConfig(n_steps=p["n_steps"], batch_size=p["batch_size"],
                             n_epochs=p["n_epochs"],
                             shuffle_block=p["shuffle_block"])
        spec = ppo.spec_for(p["variant"], engine="fastb")
        sort = None
        if p.get("sort_agent"):
            sort = mlp.load_npz(self.ctx.agent_path(p["sort_agent"]),
                                device=dev).requires_grad_(False)
        ts = ppo.init_train_state(cfg, pcfg, spec, p["n_envs"],
                                  seed=self.learn_seed,
                                  env_seed0=self.env_seed, device=dev)
        return ppo.make_train_iteration(cfg, pcfg, spec, sort), ts

    def program_record(self):
        """The program's state after the first iterations, and their
        Record."""
        it, ts = self._program()
        self.it = it
        return first_iterations(it, ts, self.p["check_iterations"])

    def setup(self):
        self.ts, self.prog = self.program_record()

    def _sync(self):
        if self.ctx.device == "cuda":
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def _spanned(self, spans: Spans):
        """``collect_rollout`` and ``ppo_update`` inside spans, as
        ``make_train_iteration``'s iteration looks them up."""
        from marl_sortingenv_tpu_torch.learn import ppo
        saved = ppo.collect_rollout, ppo.ppo_update

        def wrap(name, fn):
            def inner(*a, **kw):
                with spans.span(name):
                    return fn(*a, **kw)
            return inner
        ppo.collect_rollout = wrap("collect_rollout", saved[0])
        ppo.ppo_update = wrap("ppo_update", saved[1])
        try:
            yield
        finally:
            ppo.collect_rollout, ppo.ppo_update = saved

    def window(self, seconds: float) -> Window:
        k = 0
        self._sync()
        t0 = time.perf_counter()
        while True:
            self.ts, _ = self.it(self.ts)
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        secs = time.perf_counter() - t0
        if self.ctx.trace:
            # after the window, so that its time is the untraced one
            with self._spanned(self.spans):
                for _ in range(self.p["span_iterations"]):
                    self.ts, _ = self.it(self.ts)
        p = self.p
        samples = k * p["n_envs"] * p["n_steps"]
        return Window(metrics={"train_samples_per_s": samples / secs},
                      attempted=k, failed=0,
                      facts={"seconds": secs, "iterations": k,
                             "samples": samples})

    def traced_slice(self):
        from marl_sortingenv_tpu_torch.ops import sort_cuda, step_cuda
        n0 = step_cuda.LAUNCHES, sort_cuda.LAUNCHES
        with self._spanned(Spans(sync=False)):
            for _ in range(self.p["slice_iterations"]):
                self.ts, _ = self.it(self.ts)
        n, k = self.p["n_envs"], self.p["slice_iterations"]
        self.slice_steps = k * self.p["n_steps"]
        self.launches = [
            ("step_mono", "external", n, step_cuda.LAUNCHES - n0[0]),
            ("sort_material", None, n, sort_cuda.LAUNCHES - n0[1])]

    def release(self):
        self.ts = self.it = None
        if self.ctx.device == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ----------------------------------------------------
    def reference_record(self, tf32: bool = False) -> Record:
        """The reference learner over the same first iterations; with
        ``tf32`` its products run in TF32 (the control)."""
        from portbench.reference import config as RC
        from portbench.reference import learner as RL
        from portbench.reference import mlp as RM
        p, dev = self.p, self.ctx.device
        cfg = RC.load_config(**self.sim)
        pcfg = RL.PPOConfig(n_steps=p["n_steps"], batch_size=p["batch_size"],
                            n_epochs=p["n_epochs"],
                            shuffle_block=p["shuffle_block"])
        spec = RL.spec_for(p["variant"])
        sort = None
        if p.get("sort_agent"):
            sort = RM.load_npz(self.ctx.agent_path(p["sort_agent"]),
                               device=dev).requires_grad_(False)
        ts = RL.init_train_state(cfg, pcfg, spec, p["n_envs"],
                                 seed=self.learn_seed,
                                 env_seed0=self.env_seed, device=dev)
        it = RL.make_train_iteration(cfg, pcfg, spec, sort)
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            return first_iterations(it, ts, p["check_iterations"])[1]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before

    def check(self) -> list:
        return compare(self.prog, self.reference_record(),
                       self.p["limits"])
