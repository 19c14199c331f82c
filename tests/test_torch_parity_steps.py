"""The port's parity engine against the JAX package's on the CPU, as in
test_torch_parity_engine.py: the sorting env's step and the pressing
env's step (the rule or the tuned frozen sort agent on the sort side,
masked or sanitized) at 4 seeds x 60 steps; the wrappers
(``core/wrappers.py``) at 4 seeds x 25 steps with max_steps 20, across an
episode's end: ``with_autoreset`` of the rule step, and
``with_autoreset`` of ``with_overflow_termination`` at a container
capacity small enough that envs overflow (monolith and press
variants).  Every leaf and output bitwise but at counted argmax
near-ties of the agent.  The noise-0.05 config is in
test_torch_parity_configs.py.
"""
import pytest
import torch

import jax

from marl_sortingenv_tpu.config.config import load_config as jload
from marl_sortingenv_tpu.core import state as JS
from marl_sortingenv_tpu.core import step as JST
from marl_sortingenv_tpu.core import wrappers as JW
from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import state as S
from marl_sortingenv_tpu_torch.core import step as ST
from marl_sortingenv_tpu_torch.core import wrappers as W
from test_torch_fastb_model import agent, jax_agent
from test_torch_parity_engine import SEEDS, actions, lockstep, run_case

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)


def test_sort(monkeypatch):
    run_case(monkeypatch, {}, JST.step_sort, ST.step_sort, "sort")


@pytest.mark.parametrize("with_agent", [False, True])
@pytest.mark.parametrize("masked", [True, False])
def test_press(monkeypatch, with_agent, masked):
    jp = jax_agent("sort") if with_agent else None
    tp = agent("sort") if with_agent else None
    run_case(monkeypatch, {},
             lambda c, s, a: JST.step_press(c, s, a, jp, masked),
             lambda c, s, a: ST.step_press(c, s, a, tp, masked), "press")


def _wrapped(wrappers, cfg, fn, variant):
    f = wrappers.with_overflow_termination(cfg, fn, variant)
    return wrappers.with_autoreset(cfg, lambda c, s, a: f(s, a))


@pytest.mark.parametrize("variant", ["mono", "press"])
def test_overflow_termination_and_autoreset(monkeypatch, variant):
    kw = dict(max_steps=20, container_capacity=240)
    cfg_j, cfg_t = jload(**kw), load_config(**kw)
    fns = {"mono": (JST.step_mono_external, ST.step_mono_external),
           "press": (JST.step_press, ST.step_press)}[variant]
    step_j = jax.jit(jax.vmap(_wrapped(JW, cfg_j, fns[0], variant)))
    step_t = _wrapped(W, cfg_t, fns[1], variant)
    ended = []
    real = W._reset_where

    def spy(cfg, st, done):
        ended.append(done.clone())
        return real(cfg, st, done)
    monkeypatch.setattr(W, "_reset_where", spy)
    _, crossed = lockstep(step_j, step_t, JS.reset(cfg_j, SEEDS),
                          S.reset(cfg_t, SEEDS, device="cpu"), 25,
                          actions(variant, 25))
    assert crossed
    # an overflow ended an episode before max_steps did
    assert any(bool(d.any()) for d in ended[:19])


def test_autoreset_rule(monkeypatch):
    kw = dict(max_steps=20)
    cfg_j, cfg_t = jload(**kw), load_config(**kw)
    step_j = jax.jit(jax.vmap(JW.with_autoreset(
        cfg_j, lambda c, s, a: JST.step_mono_rule(c, s))))
    step_t = W.with_autoreset(cfg_t, lambda c, s, a: ST.step_mono_rule(c, s))
    _, crossed = lockstep(lambda s, a: step_j(s, jax.numpy.zeros(len(SEEDS))),
                          step_t, JS.reset(cfg_j, SEEDS),
                          S.reset(cfg_t, SEEDS, device="cpu"), 25)
    assert crossed


def test_rollout_stacks_steps():
    """``rollout`` is ``batched_step`` applied along the actions, its
    outputs stacked [T, N]; ``rollout_policy`` feeds the policy the
    press masks and the previous obs."""
    cfg = load_config(max_steps=5)
    acts = torch.from_numpy(actions("mono", 7))
    st0 = S.reset(cfg, SEEDS, device="cpu")
    st_r, outs = W.rollout(cfg, ST.step_mono_external, st0, acts)
    st, step = st0, W.batched_step(cfg, ST.step_mono_external)
    for t in range(7):
        st, out = step(st, acts[t])
        assert torch.equal(outs.reward[t], out.reward)
        assert torch.equal(outs.obs[t], out.obs)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(S.named_leaves(st_r), S.named_leaves(st)))

    def policy(obs, masks, k):
        assert masks.shape == (len(SEEDS), 11)
        return acts[k], {"k": torch.tensor(k)}, k + 1
    (st_p, _, k), (outs_p, acts_p, aux) = W.rollout_policy(
        cfg, ST.step_mono_external, st0, policy, None, 0, 7)
    assert k == 7 and torch.equal(acts_p, acts)
    assert torch.equal(aux["k"], torch.arange(7))
    assert torch.equal(outs_p.reward, outs.reward)
