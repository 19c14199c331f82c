"""The port's bit-exact parity engine (marl_sortingenv_tpu_torch/core/
{state,dynamics,step}.py) against the JAX package's, on the CPU: every
monolith step variant at 4 seeds x 60 steps (the episode runs on past
max_steps, as the JAX step allows), every state leaf and every StepOut
field bitwise equal, dtypes and shapes included (the port's u64 leaves
compare as their bit patterns, ``state.to_numpy``).

The tuned agents' f32 forwards round differently in PyTorch and XLA, so
an agent's argmax may pick another action where its two largest logits
lie within ARGMAX_RTOL of each other.  ``lockstep`` accepts a differing
action only there (``ArgmaxLog`` records every argmax of the step),
compares the other envs, and carries on from the JAX state; any other
difference fails.  No categorical draw lies on this path: the random
fallbacks draw from PCG64 and MT19937, which are exact.

This file holds the external, rule and model steps; the legacy-random,
policy and agent steps are in test_torch_parity_agents.py, and the sort
and press steps, the wrappers and the noise-0.05 config in
test_torch_parity_steps.py (each file stays under a minute on one
worker).
"""
import numpy as np
import pytest
import torch

import jax

from marl_sortingenv_tpu.config.config import load_config as jload
from marl_sortingenv_tpu.core import state as JS
from marl_sortingenv_tpu.core import step as JST
from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import state as S
from marl_sortingenv_tpu_torch.core import step as ST
from test_torch_fastb_model import agent, jax_agent

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

SEEDS = np.arange(1, 5)
STEPS = 60
ARGMAX_RTOL = 1e-5
N_ACT = {"sort": 2, "press": 11, "mono": 22}


def actions(kind, steps=STEPS, n=len(SEEDS), seed=3):
    return np.random.default_rng(seed).integers(
        0, N_ACT[kind], (steps, n)).astype(np.int32)


class ArgmaxLog:
    """Records the logits of every agent argmax (``step.agent_argmax``)."""

    def __init__(self, monkeypatch):
        self.rows = []
        real = ST.agent_argmax

        def hook(logits):
            self.rows.append(logits.detach().clone())
            return real(logits)
        monkeypatch.setattr(ST, "agent_argmax", hook)

    def near_tie(self, env: int) -> bool:
        for logits in self.rows:
            top = torch.topk(logits[env], 2).values.double()
            if top[0] - top[1] <= ARGMAX_RTOL * max(abs(float(top[0])), 1.0):
                return True
        return False


def _port_leaves(st):
    if isinstance(st, tuple) and not hasattr(st, "_fields"):
        names, vals = [], []
        for part in st:
            names += [n for n, _ in S.named_leaves(part)]
            vals += S.to_numpy(part)
        return names, vals
    return [n for n, _ in S.named_leaves(st)], S.to_numpy(st)


def assert_state_equal(sj, st, tag, envs=None):
    names, got = _port_leaves(st)
    want = jax.tree.leaves(sj)
    assert len(want) == len(got), tag
    for nm, a, b in zip(names, want, got):
        a = np.asarray(a)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (tag, nm)
        if envs is not None:
            a, b = a[envs], b[envs]
        assert np.array_equal(a, b), f"{tag}: state.{nm} differs"


def assert_out_equal(oj, ot, tag, envs=None):
    for f in ST.StepOut._fields:
        a, b = np.asarray(getattr(oj, f)), getattr(ot, f).numpy()
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (tag, f)
        if envs is not None:
            a, b = a[envs], b[envs]
        assert np.array_equal(a, b), f"{tag}: out.{f} differs"


def lockstep(step_j, step_t, sj, st, steps, acts=None, log=None):
    """Step both engines side by side, comparing every leaf and output
    after each step; see the module docstring for differing actions.
    Returns (near-tie splits, whether an episode ended)."""
    ties, ended = 0, False
    for t in range(steps):
        a = None if acts is None else acts[t]
        if log is not None:
            log.rows.clear()
        sj, oj = step_j(sj, a)
        st, ot = step_t(st, None if a is None else torch.from_numpy(a))
        split = np.flatnonzero(np.asarray(oj.action) != ot.action.numpy())
        for env in split:
            assert log is not None and log.near_tie(env), (
                f"step {t}, env {env}: action {np.asarray(oj.action)[env]} "
                f"(JAX) vs {int(ot.action[env])} with no near-tie")
        keep = np.setdiff1d(np.arange(len(SEEDS)), split)
        assert_state_equal(sj, st, f"step {t}", keep)
        assert_out_equal(oj, ot, f"step {t}", keep)
        if split.size:
            ties += split.size
            st = S.from_numpy(jax.tree.leaves(sj), device="cpu")
        ended |= bool(np.asarray(oj.terminated).any())
    return ties, ended


def jax_step(cfg, fn):
    """The JAX package's step ``fn(cfg, s, a) -> (s, out)`` vmapped and
    jitted, as ``(s, a) -> (s, out)`` (``a`` None for none)."""
    with_a = jax.jit(jax.vmap(lambda s, a: fn(cfg, s, a)))
    without = jax.jit(jax.vmap(lambda s: fn(cfg, s, None)))
    return lambda s, a: without(s) if a is None else with_a(s, a)


def run_case(monkeypatch, cfg_kw, j_fn, t_fn, kind=None, steps=STEPS):
    cfg_j, cfg_t = jload(**cfg_kw), load_config(**cfg_kw)
    log = ArgmaxLog(monkeypatch)
    ties, _ = lockstep(jax_step(cfg_j, j_fn),
                       lambda s, a: t_fn(cfg_t, s, a),
                       JS.reset(cfg_j, SEEDS),
                       S.reset(cfg_t, SEEDS, device="cpu"), steps,
                       None if kind is None else actions(kind, steps), log)
    print(f"near-tie splits: {ties}")
    return ties


def test_reset_matches_jax():
    cfg_j, cfg_t = jload(), load_config()
    seeds = np.array([0, 1, 7, 2**31 - 1, 10**9])
    assert_state_equal(JS.reset(cfg_j, seeds),
                       S.reset(cfg_t, seeds, device="cpu"), "reset")
    st = S.reset(cfg_t, seeds, device="cpu")
    back = S.from_numpy(S.to_numpy(st), device="cpu")
    assert_state_equal(JS.reset(cfg_j, seeds), back, "round trip")


@pytest.mark.parametrize("masked", [True, False])
def test_external(monkeypatch, masked):
    run_case(monkeypatch, {},
             lambda c, s, a: JST.step_mono_external(c, s, a, masked),
             lambda c, s, a: ST.step_mono_external(c, s, a, masked), "mono")


def test_rule(monkeypatch):
    run_case(monkeypatch, {}, lambda c, s, a: JST.step_mono_rule(c, s),
             lambda c, s, a: ST.step_mono_rule(c, s))


# each agent with and without, masking on and off
MODEL_CASES = [((None, None), True), (("sort", None), False),
               ((None, "press"), False), (("sort", "press"), True)]


@pytest.mark.parametrize("agents,masked", MODEL_CASES)
def test_model(monkeypatch, agents, masked):
    jp = [None if a is None else jax_agent(a) for a in agents]
    tp = [None if a is None else agent(a) for a in agents]
    run_case(monkeypatch, {},
             lambda c, s, a: JST.step_mono_model(c, s, *jp, masked, True),
             lambda c, s, a: ST.step_mono_model(c, s, *tp, masked, True))
