"""The port's fastb engine in full-bale mode, its batch-first converters and
its copy of the event-log replay (marl_sortingenv_tpu_torch/core/
bale_events.py), against the JAX package on the CPU.

* Full mode: every variant, 128 envs x 42 steps at max_steps=36 (across an
  episode's end), press times 1 and 2 and bales of 16, so presses finish
  every few steps and the bale buffers take full bales, own remainders and
  merged remainders; every state leaf and output as in test_torch_fastb
  (bitwise, the sorting reward's tanh to 4 ulp).
* The replay: the port's ``rebuild_bales`` equals JAX's on the same event
  logs, both refuse an overflowing log, and ``events_to_full`` of an
  events-mode run equals the full-mode run with the same keys, every leaf.
* ``to_batch_first(from_batch_first(x)) == x``; an events-mode state does
  not convert.

On the card (marker ``cuda``; this module imports JAX only inside the CPU
tests): full mode's eager step with its sorting core
on kernel 2 equals the plain step (no launch) and the CPU path, bitwise
(the sorting reward's tanh, which torch computes on the card and on the
CPU, to 4 ulp of 1 against the CPU).
"""
import numpy as np
import pytest
import torch

from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import bale_events as TBE
from marl_sortingenv_tpu_torch.core import fast as TFE
from marl_sortingenv_tpu_torch.core import fastb as TB
from marl_sortingenv_tpu_torch.ops import sort_cuda, step_cuda

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

STEPS = 42
FULL = dict(bale_mode="full", max_steps=36, press_time_1=1, press_time_2=2,
            balesize=16)


@pytest.mark.parametrize("variant,masked,autoreset", [
    ("rule", True, True),
    ("external", True, True),
    ("external", False, False),
    ("sort", True, True),
    ("press", True, False),
    ("press", False, True),
])
def test_full_mode_bitwise(variant, masked, autoreset):
    from test_torch_fastb import run_pair

    st = run_pair(FULL, variant, masked, STEPS, seed=5, autoreset=autoreset)
    assert st.ev_cnt is None
    assert int(st.bale_cnt.max()) > 0, "no bale was made"


def _events_and_full(variant="rule", steps=30, seed=8, n=64):
    """The same run in events and in full mode (no autoreset, fewer steps
    than max_steps, so the logs hold the whole run)."""
    out = []
    for mode in ("events", "full"):
        cfg = load_config(**{**FULL, "bale_mode": mode})
        st = TB.reset_batch(cfg, seed, n, device="cpu")
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            a = torch.from_numpy(rng.integers(0, 22, n).astype(np.int32))
            st, _ = (TB.step_mono_rule(cfg, st) if variant == "rule" else
                     TB.step_mono_external(cfg, st, a, False))
        out.append((cfg, st))
    return out


@pytest.mark.parametrize("variant", ["rule", "external"])
def test_events_to_full_equals_full_run(variant):
    (cfg_e, st_e), (cfg_f, st_f) = _events_and_full(variant)
    assert int(st_e.ev_cnt.max()) > 1
    conv = TBE.events_to_full(cfg_e, st_e)
    for nm, a, b in zip(TB.BState._fields, conv, st_f):
        if b is None:
            assert a is None, nm
            continue
        assert a.dtype == b.dtype and torch.equal(a, b), nm
    assert TBE.events_to_full(cfg_f, st_f) is st_f


def test_rebuild_bales_matches_jax_and_guards_overflow():
    from marl_sortingenv_tpu.config.config import load_config as jload
    from marl_sortingenv_tpu.core import bale_events as JBE

    (cfg_e, st_e), _ = _events_and_full("external", steps=34, seed=3)
    logs = [x.numpy() for x in (st_e.ev_mat, st_e.ev_n, st_e.ev_q,
                                st_e.ev_cnt)]
    cfg_j = jload(**{**FULL, "bale_mode": "events"})
    ref = JBE.rebuild_bales(cfg_j, *logs)
    got = TBE.rebuild_bales(cfg_e, st_e.ev_mat, st_e.ev_n, st_e.ev_q,
                            st_e.ev_cnt)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # both merge and own-bale remainders occur in this run
    sizes = got[0][got[0] > 0]
    assert (sizes > 16).any() and (sizes < 16).any()
    over = logs[3].copy()
    over[0] = logs[0].shape[0] + 1
    for rebuild, c in ((TBE.rebuild_bales, cfg_e), (JBE.rebuild_bales,
                                                     cfg_j)):
        with pytest.raises(ValueError, match="event log overflow"):
            rebuild(c, logs[0], logs[1], logs[2], over)


def test_batch_first_roundtrip():
    (_, st_e), (_, st_f) = _events_and_full("rule", steps=12)
    bf = TB.to_batch_first(st_f)
    assert isinstance(bf, TFE.FastEnvState)
    assert tuple(bf.bale_size.shape) == (64, 5, st_f.bale_size.shape[1])
    assert tuple(bf.cont_true.shape) == (64, 5)
    back = TB.from_batch_first(bf)
    for nm, a, b in zip(TB.BState._fields, back, st_f):
        if b is None:
            assert a is None, nm
            continue
        assert torch.equal(a, b), nm
    again = TB.to_batch_first(back)
    for nm, a, b in zip(TFE.FastEnvState._fields, again, bf):
        assert torch.equal(a, b), nm
    with pytest.raises(ValueError, match="full-bale-mode"):
        TB.to_batch_first(st_e)


def test_full_mode_cpu_launches_nothing():
    cfg = load_config(**FULL)
    st = TB.reset_batch(cfg, 2, 16, device="cpu")
    before = (step_cuda.LAUNCHES, sort_cuda.LAUNCHES)
    step = TB.mono_autoreset_step(cfg, "external", True)
    for _ in range(3):
        st, _ = step(st, torch.zeros(16, dtype=torch.int32))
    assert (step_cuda.LAUNCHES, sort_cuda.LAUNCHES) == before
    with pytest.raises(ValueError, match="bale_mode='events'"):
        step_cuda.step_mono_plain(cfg, st, None, variant="rule")


# ---------------------------------------------------------------------------
# CUDA: the full-mode step on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sort kernel has no CPU mode")
    return torch.device("cuda")


def _same(a, b, tag):
    for nm, x, y in zip(TB.BState._fields, a, b):
        if x is None:
            assert y is None, (tag, nm)
            continue
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), (tag, nm)


def outs_match(o_cuda, o_ref, tag, tanh_ulps=0):
    """Every output equal; the two that pass through the sorting reward's
    tanh to ``tanh_ulps`` ulp (torch's CUDA and CPU tanh may differ in the
    last bits; the pre-tanh argument is held bitwise by the state)."""
    for nm in TB.BStepOut._fields:
        x, y = getattr(o_cuda, nm).cpu(), getattr(o_ref, nm).cpu()
        assert x.dtype == y.dtype, (tag, nm)
        if nm in ("reward", "sort_reward") and tanh_ulps:
            ulp = torch.from_numpy(np.spacing(np.abs(y.numpy()) + 1.0))
            assert ((x - y).abs() <= tanh_ulps * ulp).all(), (tag, nm)
        else:
            assert torch.equal(x, y), (tag, nm)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,masked", [
    ("rule", True), ("external", True), ("external", False), ("sort", True),
    ("press", True), ("press", False)])
def test_cuda_full_mode_matches_plain_and_cpu(cuda, variant, masked):
    """512 envs x 42 autoreset steps: kernel 2 once per step, kernel 1
    never; every leaf and output equal to the plain step and the CPU path."""
    cfg = load_config(**FULL)
    n = 512
    step_k = TB.mono_autoreset_step(cfg, variant, masked)
    step_p = TB.with_autoreset(cfg, TB.eager_step(variant, masked))
    st_k = st_p = TB.reset_batch(cfg, 6, n, device=cuda)
    st_c = TB.reset_batch(cfg, 6, n, device="cpu")
    gen = torch.Generator().manual_seed(6)
    n_act = {"rule": 22, "external": 22, "sort": 2, "press": 11}[variant]
    for t in range(STEPS):
        a = torch.randint(0, n_act, (n,), generator=gen, dtype=torch.int32)
        a = None if variant == "rule" else a
        ag = None if a is None else a.to(cuda)
        k1, k2 = step_cuda.LAUNCHES, sort_cuda.LAUNCHES
        st_k, o_k = step_k(st_k, ag)
        assert (step_cuda.LAUNCHES - k1, sort_cuda.LAUNCHES - k2) == (0, 1)
        st_p, o_p = step_p(st_p, ag)
        assert sort_cuda.LAUNCHES - k2 == 1
        st_c, o_c = step_k(st_c, a)
        _same(st_k, st_p, f"plain step {t}")
        _same(st_k, st_c, f"CPU step {t}")
        outs_match(o_k, o_p, f"plain step {t}")
        outs_match(o_k, o_c, f"CPU step {t}", tanh_ulps=4)
