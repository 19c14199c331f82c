"""The port's parity engine against the JAX package's on the CPU, as in
test_torch_parity_engine.py: the monolith's legacy-random step (the
MT19937 stream, masked and unmasked; the MT state compared too), the
benchmark's monolith-policy step (the agent acts on the previous step's
observation) and the stored-agent step, 4 seeds x 60 steps, every leaf
and output bitwise but at counted argmax near-ties of the tuned agent.
"""
import pytest
import torch

import jax

from marl_sortingenv_tpu.config.config import load_config as jload
from marl_sortingenv_tpu.core import legacy_random as JLR
from marl_sortingenv_tpu.core import state as JS
from marl_sortingenv_tpu.core import step as JST
from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import legacy_random as LR
from marl_sortingenv_tpu_torch.core import state as S
from marl_sortingenv_tpu_torch.core import step as ST
from test_torch_fastb_model import agent, jax_agent
from test_torch_parity_engine import (SEEDS, STEPS, assert_state_equal,
                                      lockstep, run_case)

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)


@pytest.mark.parametrize("masked", [True, False])
def test_legacy_random(masked):
    cfg_j, cfg_t = jload(), load_config()
    fj = jax.jit(jax.vmap(
        lambda s, lr: JST.step_mono_legacy_random(cfg_j, s, lr, masked)))
    pair_j = (JS.reset(cfg_j, SEEDS), JLR.mt19937_init(SEEDS))
    pair_t = (S.reset(cfg_t, SEEDS, device="cpu"),
              LR.mt19937_init(SEEDS, device="cpu"))

    def step_j(pair, a):
        s, lr, out = fj(*pair)
        return (s, lr), out

    def step_t(pair, a):
        s, lr, out = ST.step_mono_legacy_random(cfg_t, *pair, masked)
        return (s, lr), out

    assert_state_equal(pair_j, pair_t, "reset")
    lockstep(step_j, step_t, pair_j, pair_t, STEPS)


@pytest.mark.parametrize("masked", [True, False])
def test_policy(monkeypatch, masked):
    apply_fn, params = jax_agent("mono")
    mono = agent("mono")
    run_case(monkeypatch, {},
             lambda c, s, a: JST.step_mono_policy(c, s, params, apply_fn,
                                                  masked),
             lambda c, s, a: ST.step_mono_policy(c, s, mono, masked))


def test_agent(monkeypatch):
    apply_fn, params = jax_agent("mono")
    mono = agent("mono")
    run_case(monkeypatch, {},
             lambda c, s, a: JST.step_mono_agent(c, s, params, apply_fn,
                                                 True),
             lambda c, s, a: ST.step_mono_agent(c, s, mono, True))
