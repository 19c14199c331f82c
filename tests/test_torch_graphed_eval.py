"""The evaluation's graphed steps (``core/fastb.py``: ``graphed_step``,
``GraphedStep``, through ``ops/graphs.py``; ``eval/harness.py::
policy_steps``) and the cache of device
constants (``marl_sortingenv_tpu_torch.const``) that makes the eager bodies
capturable.

On the CPU: the cache gives each constant the bits ``torch.tensor`` gives
it, value by value, for every constant one step of each body asks for; and
``policy_steps`` never graphs there.  On the card (marker ``cuda``): for
Random, PPO Sort-Only and PPO Modular at both configurations of the
benchmark, 256 and 4096 episodes, 200 steps, ``policy_steps`` with the
graph gives every output bit for bit as the eager loop does, and the same
totals; a second call captures nothing; each replay counts its kernel-2
launch; no step's outputs are overwritten by the next; a patched step
function is captured anew and its fault shows.  This file imports no JAX;
on the card:

    python -m pytest tests/test_torch_graphed_eval.py -m cuda --noconftest \
        -o addopts="" -q
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import marl_sortingenv_tpu_torch as PKG
from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import fastb as FB
from marl_sortingenv_tpu_torch.core import threefry as TF
from marl_sortingenv_tpu_torch.eval import harness
from marl_sortingenv_tpu_torch.models import mlp
from marl_sortingenv_tpu_torch.ops import graphs
from marl_sortingenv_tpu_torch.utils import profiling as P

ROOT = Path(__file__).resolve().parents[1]
GRAPHED = ("Random", "PPO Sort-Only", "PPO Modular")
CONFIGS = ("plant_noise05", "plant_paper")


def _conf(name: str) -> dict:
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def _cfg(name: str):
    return load_config(**_conf(name)["sim"])


def _agents(name: str, device: str):
    conf = _conf(name)
    return [mlp.load_npz(str(ROOT / conf["agents"][a]), device=device)
            .requires_grad_(False) for a in ("sort", "press", "mono")]


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A tensor's bit patterns (floats as ints, so -0.0 is not 0.0)."""
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    if x.dtype == torch.float64:
        return x.view(torch.int64)
    return x


# -- on the CPU ---------------------------------------------------------------

def _eager_steps(cfg, st, agents):
    """One step of every eager body on ``st``."""
    sp, pp, _ = agents
    n = st.current_step.shape[0]
    a11 = torch.arange(n, dtype=torch.int32) % 11
    FB.step_mono_random(cfg, st)
    FB.step_mono_model(cfg, st, sp, pp)
    FB.step_mono_model(cfg, st, sp, None, False)
    FB._rule_body(cfg, st)
    FB._external_body(cfg, st, a11 + 11, False)
    FB._sort_body(cfg, st, a11 % 2)
    FB._press_body(cfg, st, a11, True, sp)


@pytest.mark.parametrize("bale_mode", ["events", "full"])
@pytest.mark.parametrize("config", CONFIGS)
def test_const_gives_each_constant_its_bits(config, bale_mode, monkeypatch):
    """Every constant that a step of each eager body, and its reset, asks
    the cache for comes back with the bits ``torch.tensor`` gives the same
    value, and the same tensor at a second request."""
    asked = []

    def record(value, dtype, device):
        t = PKG.const(value, dtype, device)
        asked.append((value, dtype, t))
        return t
    monkeypatch.setattr(FB, "const", record)
    monkeypatch.setattr(TF, "const", record)
    cfg = load_config(**{**_conf(config)["sim"], "bale_mode": bale_mode})
    st = FB.reset_batch(cfg, 7, 6, device="cpu")
    for _ in range(2):
        st, _ = FB.step_mono_rule(cfg, st)
    with torch.no_grad():
        _eager_steps(cfg, st, _agents(config, "cpu"))
    assert len({(str(np.asarray(v)), d) for v, d, _ in asked}) >= 20
    for value, dtype, t in asked:
        want = torch.tensor(value, dtype=dtype)
        assert t.dtype == dtype and torch.equal(_bits(t), _bits(want)), (
            value, dtype, t, want)
        assert PKG.const(value, dtype, "cpu") is t


def test_const_tells_values_apart_by_their_bits():
    zero, neg = (PKG.const(v, torch.float32, "cpu") for v in (0.0, -0.0))
    assert zero is not neg and torch.signbit(neg) and not torch.signbit(zero)
    third = np.float32(1.0) / np.float32(3.0)
    assert PKG.const(third, torch.float32, "cpu").item() == third
    assert PKG.const([1, 2], torch.int32, "cpu") is not PKG.const(
        [1, 2], torch.int16, "cpu")


@pytest.mark.parametrize("lo,hi", [(-0.05, 0.05), (-0.1, 0.3)])
def test_draws_keep_the_bits_of_their_device_constants(lo, hi):
    """``uniform4`` and the Gumbel draw, with their bounds from the cache,
    give what the same expressions on fresh ``torch.tensor`` bounds
    give."""
    keys = TF.split(TF.prng_key(11, "cpu")[None], 64)[0]
    u01 = TF.bits_to_unit(TF.bits(keys, 4))
    lo32, hi32 = (torch.tensor(v, dtype=torch.float32) for v in (lo, hi))
    want = torch.maximum(lo32, TF.fma_f32(u01, (hi32 - lo32).expand_as(u01),
                                          lo32.expand_as(u01)))
    assert torch.equal(_bits(TF.uniform4(keys, lo, hi)), _bits(want))
    logits = torch.randn(64, 5, generator=torch.Generator().manual_seed(2))
    u01 = TF.bits_to_unit(TF.bits(keys, 5))
    tiny = torch.tensor(torch.finfo(torch.float32).tiny, dtype=torch.float32)
    u = torch.maximum(tiny, TF.fma_f32(u01, (1.0 - tiny).expand_as(u01),
                                       tiny.expand_as(u01)))
    want = -torch.log(-torch.log(u)) + logits
    assert torch.equal(_bits(TF.vperturbed(keys, logits)), _bits(want))


def test_cpu_policy_steps_never_graph():
    """On the CPU each step of the graphed policies is the eager body: one
    ``fastb.eager`` span per step, none marked ``graph``, and no capture or
    replay."""
    cfg, agents = _cfg("plant_noise05"), _agents("plant_noise05", "cpu")
    before = graphs.CAPTURES, graphs.REPLAYS
    with torch.profiler.profile():
        for policy in GRAPHED:
            for _ in harness.policy_steps(cfg, policy, "fastb", 6, 3,
                                          *agents, True, 4, "cpu"):
                pass
    eager = [r for r in P.spans() if r.name == "fastb.eager"]
    assert len(eager) == 3 * len(GRAPHED)
    assert all("graph" not in r.attrs for r in eager)
    assert (graphs.CAPTURES, graphs.REPLAYS) == before


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def _eager_outs(cfg, policy, agents, n, steps, seed0):
    """The policy's step outputs from the eager loop, as ``policy_steps``
    ran it before its steps were graphed."""
    sp, pp, _ = agents
    st = FB.reset_batch(cfg, seed0, n, device="cuda")
    outs = []
    with torch.no_grad():
        for _ in range(steps):
            if policy == "Random":
                st, out = FB.step_mono_random(cfg, st, True)
            else:
                st, out = FB.step_mono_model(
                    cfg, st, sp, pp if policy == "PPO Modular" else None,
                    True)
            outs.append(out)
    return outs


def _assert_same(got, want):
    assert len(got) == len(want)
    for t, (a, b) in enumerate(zip(got, want)):
        for name, x, y in zip(FB.BStepOut._fields, a, b):
            assert x.dtype == y.dtype and x.shape == y.shape, (t, name)
            assert torch.equal(_bits(x), _bits(y)), (t, name)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 4096])
@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("policy", GRAPHED)
def test_cuda_graphed_steps_equal_the_eager_loop(cuda, policy, config, n):
    """All 200 steps of a graphed policy, every output field and every
    episode's total, bit for bit as the eager loop gives them; the outputs
    are kept until the end, so none was overwritten by a later replay."""
    cfg, agents = _cfg(config), _agents(config, cuda)
    got = list(harness.policy_steps(cfg, policy, "fastb", n, 200, *agents,
                                    True, 9, cuda))
    want = _eager_outs(cfg, policy, agents, n, 200, 9)
    _assert_same(got, want)
    totals = harness.policy_totals(cfg, policy, "fastb", n, 200, *agents,
                                   True, 9, cuda)
    eager = np.asarray(torch.stack([o.reward for o in want]).cpu().numpy(),
                       np.float64).sum(axis=0)
    assert np.array_equal(totals, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("policy", GRAPHED)
def test_cuda_second_call_only_replays(cuda, policy):
    """A second call captures nothing; it replays once per step, and each
    replay counts its launch of kernel 2."""
    from marl_sortingenv_tpu_torch.ops import sort_cuda, step_cuda
    cfg, agents = _cfg("plant_noise05"), _agents("plant_noise05", cuda)
    for _ in harness.policy_steps(cfg, policy, "fastb", 256, 3, *agents,
                                  True, 1, cuda):
        pass
    captures, replays = graphs.CAPTURES, graphs.REPLAYS
    sort0, step0 = sort_cuda.LAUNCHES, step_cuda.LAUNCHES
    for _ in harness.policy_steps(cfg, policy, "fastb", 256, 17, *agents,
                                  True, 2, cuda):
        pass
    assert graphs.CAPTURES == captures
    assert graphs.REPLAYS == replays + 17
    assert sort_cuda.LAUNCHES == sort0 + 17
    assert step_cuda.LAUNCHES == step0


@pytest.mark.cuda
def test_cuda_outputs_outlive_the_next_replay(cuda):
    """Step k's outputs hold their values after step k + 1 is replayed."""
    cfg, agents = _cfg("plant_noise05"), _agents("plant_noise05", cuda)
    gen = harness.policy_steps(cfg, "PPO Modular", "fastb", 256, 200,
                               *agents, True, 3, cuda)
    first = next(gen)
    kept = [x.clone() for x in first]
    second = next(gen)
    gen.close()
    for a, b, c in zip(first, kept, second):
        assert torch.equal(_bits(a), _bits(b))
        assert a.data_ptr() != c.data_ptr()
    assert not torch.equal(first.obs, second.obs)


@pytest.mark.cuda
def test_cuda_patched_step_is_captured_anew(cuda, monkeypatch):
    """A step function patched on ``fastb`` (as the benchmark's faults
    patch it) keys a graph of its own, and its fault shows in the
    replays; the unpatched graph is replayed again after."""
    cfg, agents = _cfg("plant_noise05"), _agents("plant_noise05", cuda)

    def totals():
        return harness.policy_totals(cfg, "PPO Sort-Only", "fastb", 256, 20,
                                     *agents, True, 5, cuda)
    sound = totals()
    real = FB.step_mono_model

    def altered(*a, **kw):
        st, out = real(*a, **kw)
        reward = out.reward.clone()
        reward[..., 0] += 1.0
        return st, out._replace(reward=reward)
    captures = graphs.CAPTURES
    with monkeypatch.context() as m:
        m.setattr(FB, "step_mono_model", altered)
        faulty = totals()
    assert graphs.CAPTURES == captures + 1
    # one more per step, each sum of a reward and 1 rounded in f32
    assert abs(faulty[0] - sound[0] - 20.0) < 1e-3
    assert np.array_equal(faulty[1:], sound[1:])
    assert np.array_equal(totals(), sound)
    assert graphs.CAPTURES == captures + 1


@pytest.mark.cuda
def test_cuda_replay_records_one_graph_span(cuda):
    """Under the profiler a replayed step records one ``fastb.eager`` span,
    with its body and ``graph`` set, inside its ``eval.step``."""
    cfg, agents = _cfg("plant_noise05"), _agents("plant_noise05", cuda)
    for policy, body in (("Random", "random"), ("PPO Modular", "model")):
        gen = harness.policy_steps(cfg, policy, "fastb", 256, 200, *agents,
                                   True, 3, cuda)
        next(gen)
        with torch.profiler.profile():
            next(gen)
        gen.close()
        recs = P.spans()
        assert [r.name for r in recs] == ["eval.step", "fastb.eager"]
        assert recs[1].attrs == {"body": body, "graph": True}
        assert recs[1].parent == 0
