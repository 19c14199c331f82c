"""The port's step kernel (marl_sortingenv_tpu_torch/ops/step_cuda.py).

On the CPU: the kernel's plain version ``step_mono_plain`` against the JAX
package's Pallas step kernel ``step_pallas.step_mono`` in interpret mode,
run the way tests/test_step_pallas.py runs it (max_steps=36, so E = 9;
128 envs; 3 steps), bitwise for every variant and masked flag, and with
the fused autoreset at max_steps=3.

On the card (marker ``cuda``, skipped without one): the CUDA kernel against
``step_mono_plain`` on the same CUDA tensors, bitwise, in every design that
covers the config's support (``sort_cuda.DESIGNS``), at supports 16, 24,
32, 40 and 88 and at 1, 127, 4096, 4097 and 65536 envs.  Every variant,
out-of-range actions, the batch sizes, press completion and the deep event
log run in the designs of caps 16 and 32 and the generic ``(1, 104)`` at
support 16, and in the groups of caps 64 and 128 at supports 40 and 88.
On the CPU also: the design table ``lanes_for`` and the wrapper's argument
checks.  This module imports
JAX only inside the CPU tests, so the card's tests run where JAX is absent:
    python -m pytest tests/test_torch_step_kernel.py -m cuda --noconftest -o addopts=""
"""
import numpy as np
import pytest
import torch

from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import fastb as TB
from marl_sortingenv_tpu_torch.ops import sort_cuda, step_cuda

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

N_ACTIONS = {"rule": 22, "external": 22, "sort": 2, "press": 11}
# configs by sampler support (fastb._support_for)
SUPPORT_CFGS = {24: {"noise_sorting": 0.2},
                32: {"baseline_accuracy": (0.5, 0.5, 0.5, 0.5)},
                40: {"baseline_accuracy": (0.2, 0.2, 0.2, 0.2)},
                88: {"input_batch_size": 250,
                     "baseline_accuracy": (0.2, 0.2, 0.2, 0.2)}}


designs_for = sort_cuda.DESIGN_SET.designs_for


def design_id(d):
    return f"L{d[0]}c{d[1]}"


# the designs held at support 16: those of caps 16 and 32 and the generic
# (1, 104); the groups of caps 64 and 128 are held at supports 40 and 88
DESIGNS_16 = [d for d in designs_for(16) if d[1] <= 32 or d[0] == 1]
DESIGN_CASES = ([pytest.param(16, d, id=design_id(d)) for d in DESIGNS_16]
                + [pytest.param(s, d, id=f"s{s}-{design_id(d)}")
                   for s in (40, 88) for d in designs_for(s) if d[0] > 1])
CASES = [("rule", True), ("external", True), ("external", False),
         ("sort", True), ("press", True), ("press", False)]


def _assert_same(st_a, out_a, st_b, out_b, tag=""):
    """Every state leaf and every output bitwise equal (NaN-free data)."""
    for nm, a, b in zip(TB.BState._fields, st_a, st_b):
        if a is None:
            assert b is None, nm
            continue
        assert a.dtype == b.dtype, (tag, nm, a.dtype, b.dtype)
        assert torch.equal(a.cpu(), b.cpu()), f"{tag} state.{nm}"
    for nm in TB.BStepOut._fields:
        a, b = getattr(out_a, nm).cpu(), getattr(out_b, nm).cpu()
        assert a.dtype == b.dtype, (tag, nm, a.dtype, b.dtype)
        assert torch.equal(a, b), f"{tag} out.{nm}"


# ---------------------------------------------------------------------------
# CPU: plain version == JAX Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _jax_state_to_torch(st_j):
    kw = {}
    for nm, x in zip(TB.BState._fields, st_j):
        if x is None:
            kw[nm] = None
            continue
        a = np.asarray(x)
        if nm == "key":
            a = a.view(np.int32)
        kw[nm] = torch.from_numpy(np.array(a))
    return TB.BState(**kw)


def _compare_with_pallas(cfg_kw, variant, masked, steps=3, n=128, seed=1,
                         autoreset=False):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from marl_sortingenv_tpu.config.config import load_config as jload
    from marl_sortingenv_tpu.core import fastb as FB
    from marl_sortingenv_tpu.ops import step_pallas as SPK

    cfg_j = jload(bale_mode="events", **cfg_kw)
    cfg_t = load_config(bale_mode="events", **cfg_kw)
    st_j = FB.reset_batch(cfg_j, jax.random.PRNGKey(seed), n)
    st_t = TB.reset_batch(cfg_t, seed, n, device="cpu")
    rng = np.random.default_rng(seed)
    acts = rng.integers(0, N_ACTIONS[variant], size=(steps, n)).astype(
        np.int32)
    # jitted once: interpret mode otherwise re-traces the kernel each step
    pallas_step = jax.jit(lambda s, a: SPK.step_mono(
        cfg_j, s, a, variant=variant, masked=masked,
        support=FB._support_for(cfg_j), autoreset=autoreset, interpret=True))
    for t in range(steps):
        a = None if variant == "rule" else acts[t]
        st_j, out_j = pallas_step(st_j, None if a is None else jnp.asarray(a))
        st_t, out_t = step_cuda.step_mono_plain(
            cfg_t, st_t, None if a is None else torch.from_numpy(a),
            variant=variant, masked=masked, autoreset=autoreset)
    ref = _jax_state_to_torch(st_j)
    for nm, a, b in zip(TB.BState._fields, ref, st_t):
        if a is None:
            continue
        assert torch.equal(a.to(b.dtype), b), f"state.{nm}"
    for nm in TB.BStepOut._fields:
        a = torch.from_numpy(np.array(getattr(out_j, nm)))
        b = getattr(out_t, nm)
        if nm in ("reward", "sort_reward"):
            # tanh: XLA-CPU and torch-CPU f32 tanh differ in the last bits
            # (the pre-tanh argument is held bitwise in test_torch_fastb)
            tol = 4 * np.spacing(np.float32(1.0))
            assert torch.allclose(a.to(b.dtype), b, rtol=0, atol=tol), nm
        else:
            assert torch.equal(a.to(b.dtype), b), f"out.{nm}"
    return st_t


@pytest.mark.parametrize("variant,masked", CASES)
def test_plain_matches_pallas_kernel(variant, masked):
    _compare_with_pallas(dict(max_steps=36, balesize=24), variant, masked)


def test_plain_matches_pallas_kernel_noise():
    _compare_with_pallas(dict(max_steps=36, noise_sorting=0.05),
                         "external", True)


def test_plain_matches_pallas_kernel_fused_autoreset():
    st = _compare_with_pallas(dict(max_steps=3), "rule", True, steps=5,
                              seed=5, autoreset=True)
    assert int(st.current_step.max()) < 5


def test_plain_matches_pallas_kernel_press_completion():
    st = _compare_with_pallas(
        dict(max_steps=24, press_time_1=1, press_time_2=2, balesize=16),
        "rule", True, steps=8, seed=7)
    assert int(st.ev_cnt.max()) > 0


def test_wrapper_takes_plain_version_on_cpu():
    """On a CPU state the wrapper runs the plain version and launches
    nothing."""
    cfg = load_config(bale_mode="events", max_steps=36)
    st = TB.reset_batch(cfg, 0, 64, device="cpu")
    before = step_cuda.LAUNCHES
    st_w, out_w = step_cuda.step_mono(cfg, st, None, variant="rule")
    st_p, out_p = step_cuda.step_mono_plain(cfg, st, None, variant="rule")
    _assert_same(st_w, out_w, st_p, out_p)
    assert step_cuda.LAUNCHES == before


def test_kernel_refuses_a_cpu_state():
    cfg = load_config(bale_mode="events", max_steps=36)
    st = TB.reset_batch(cfg, 0, 8, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        step_cuda.step_mono_kernel(cfg, st, None, variant="rule")


@pytest.mark.parametrize("table", ["step", "sort"])
def test_lanes_for_covers_every_support(table):
    """Every support the engine allows (1 .. 104) gets a built design that
    covers it, at any batch size; 105 raises."""
    lanes_for = (step_cuda if table == "step" else sort_cuda).lanes_for
    for support in range(1, 105):
        for n in (1, 127, 4096, 4097, 65536, 1 << 20):
            lanes, cap = lanes_for(support, n)
            assert (lanes, cap) in sort_cuda.DESIGNS
            assert cap >= support and cap % lanes == 0
            assert lanes * (cap // lanes) >= support
            assert sort_cuda.DESIGN_SET.covers((lanes, cap), support)
    with pytest.raises(ValueError, match="support"):
        lanes_for(105, 4096)
    with pytest.raises(ValueError, match="support"):
        lanes_for(0, 4096)


def test_design_checks():
    """A design that is not built, or that does not cover the support,
    raises; so does a support outside the engine's range."""
    D = sort_cuda.DESIGN_SET
    assert D.check_design([16, 16], 16) == (16, 16)
    assert D.check_design((1, 104), 104) == (1, 104)
    with pytest.raises(ValueError, match="not built"):
        D.check_design((2, 16), 16)
    with pytest.raises(ValueError, match="covers supports up to 16"):
        D.check_design((16, 16), 24)
    assert D.check_design((16, 16), 8) == (16, 16)
    with pytest.raises(ValueError, match="one-lane design runs at its cap"):
        D.check_design((1, 16), 8)
    assert D.designs_for(40) == [(8, 64), (16, 64), (32, 64),
                                 (16, 128), (32, 128), (1, 104)]
    assert D.designs_for(88) == [(16, 128), (32, 128), (1, 104)]
    with pytest.raises(ValueError, match="covers supports up to 64"):
        D.check_design((32, 64), 65)
    assert (1, 16) not in D.designs_for(24)
    with pytest.raises(ValueError, match="support"):
        D.check_design((1, 104), 105)
    table = ((16, 4096, (8, 16)), (16, 0, (16, 16)), (104, 0, (1, 104)))
    assert D.pick(table, 16, 4095) == (16, 16)
    assert D.pick(table, 16, 4096) == (8, 16)
    assert D.pick(table, 17, 1 << 20) == (1, 104)
    with pytest.raises(ValueError, match="no design"):
        D.pick(((16, 0, (16, 16)),), 24, 1)


def test_kernel_checks_its_arguments():
    """The step kernel's wrapper refuses an unknown variant before it
    looks at the device, and a CPU state before it picks a design."""
    cfg = load_config(bale_mode="events", max_steps=36)
    st = TB.reset_batch(cfg, 0, 8, device="cpu")
    with pytest.raises(ValueError, match="unknown variant"):
        step_cuda.step_mono_kernel(cfg, st, None, variant="mono")
    with pytest.raises(ValueError, match="CUDA"):
        step_cuda.step_mono_kernel(cfg, st, None, variant="rule",
                                   design=(2, 16))
    with pytest.raises(ValueError, match="step_mono runs on CUDA or the CPU"):
        step_cuda.step_mono(cfg, st._replace(current_step=st.current_step.to(
            "meta")), None, variant="rule")


def test_full_bale_mode_raises():
    cfg = load_config(bale_mode="full", max_steps=36)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TB.reset_batch(cfg, 0, 8, device="cpu")


# ---------------------------------------------------------------------------
# CUDA: kernel == plain version on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the step kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_vs_plain(cfg, variant, masked, autoreset, n, steps, dev,
                     seed=0, action_range=None, design=None):
    """``steps`` steps through the kernel (in ``design``, or the one
    ``lanes_for`` picks through ``step_mono``) and through the plain
    version, every leaf and output bitwise after each."""
    st_k = st_p = TB.reset_batch(cfg, seed, n, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    lo, hi = action_range or (0, N_ACTIONS[variant])
    for t in range(steps):
        a = torch.randint(lo, hi, (n,), generator=gen, dtype=torch.int32)
        if action_range is not None:
            a[:2] = torch.tensor([-2**31, 2**31 - 1], dtype=torch.int32)
        a = a.to(dev)
        a = None if variant == "rule" else a
        before = step_cuda.LAUNCHES
        if design is None:
            st_k, out_k = step_cuda.step_mono(cfg, st_k, a, variant=variant,
                                              masked=masked,
                                              autoreset=autoreset)
        else:
            st_k, out_k = step_cuda.step_mono_kernel(
                cfg, st_k, a, variant=variant, masked=masked,
                autoreset=autoreset, design=design)
        assert step_cuda.LAUNCHES == before + 1
        st_p, out_p = step_cuda.step_mono_plain(
            cfg, st_p, a, variant=variant, masked=masked,
            autoreset=autoreset)
        _assert_same(st_k, out_k, st_p, out_p, tag=f"step {t}")
    torch.cuda.synchronize()
    return st_k


def _cfg(support, **kw):
    """The config ``kw`` at sampler support ``support`` (16: as given;
    40 and 88: at the accuracies and batch size of ``SUPPORT_CFGS``)."""
    cfg = load_config(bale_mode="events", **kw, **SUPPORT_CFGS.get(support, {}))
    assert TB._support_for(cfg) == support
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("support,design", DESIGN_CASES)
@pytest.mark.parametrize("autoreset", [False, True])
@pytest.mark.parametrize("variant,masked", CASES)
def test_cuda_kernel_matches_plain(cuda, variant, masked, autoreset, support,
                                   design):
    cfg = _cfg(support, max_steps=20, balesize=24)
    _kernel_vs_plain(cfg, variant, masked, autoreset, 1000, 24, cuda,
                     design=design)


@pytest.mark.cuda
@pytest.mark.parametrize("support,design", DESIGN_CASES)
@pytest.mark.parametrize("variant,masked", CASES[1:])
def test_cuda_kernel_out_of_range_actions(cuda, variant, masked, support,
                                          design):
    """Negative and too-large actions (and the int32 extremes) decode with
    floor division and modulo in the kernel, as in the plain version."""
    cfg = _cfg(support, max_steps=20, balesize=24)
    _kernel_vs_plain(cfg, variant, masked, True, 1000, 24, cuda,
                     action_range=(-40, 40), design=design)


@pytest.mark.cuda
@pytest.mark.parametrize("support,design", DESIGN_CASES)
def test_cuda_kernel_noise_and_press_completion(cuda, support, design):
    """Sorting noise 0.05 (which takes support 88's config to 96) and
    presses that finish within a step or two."""
    cfg = load_config(bale_mode="events", max_steps=24, noise_sorting=0.05,
                      press_time_1=1, press_time_2=2, balesize=16,
                      **SUPPORT_CFGS.get(support, {}))
    assert sort_cuda.DESIGN_SET.covers(design, TB._support_for(cfg))
    st = _kernel_vs_plain(cfg, "rule", True, True, 4096, 30, cuda,
                          design=design)
    assert int(st.ev_cnt.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("support,design", [
    (s, d) for s in sorted(SUPPORT_CFGS) for d in designs_for(s)],
    ids=lambda v: design_id(v) if isinstance(v, tuple) else f"s{v}")
def test_cuda_kernel_generic_support(cuda, support, design):
    """Configs whose sampler support is not 16 (24 at noise 0.2, 32 and 40
    at lower baseline accuracies, 88 at batches of 250 units) in every
    design that covers them: 40 in the groups at caps 64 and 128 and the
    one-lane generic design, 88 in those at cap 128 and the generic one."""
    cfg = load_config(bale_mode="events", max_steps=20,
                      **SUPPORT_CFGS[support])
    assert TB._support_for(cfg) == support
    _kernel_vs_plain(cfg, "external", True, True, 300, 24, cuda,
                     design=design)


@pytest.mark.cuda
@pytest.mark.parametrize("support,design", DESIGN_CASES)
@pytest.mark.parametrize("n", [1, 127, 4096, 4097, 65536])
def test_cuda_kernel_batch_sizes(cuda, n, support, design):
    """Ragged batches (the last block holds fewer envs than it has lane
    groups) and the main path's widths, across the fused autoreset."""
    cfg = _cfg(support, max_steps=6, balesize=24)
    _kernel_vs_plain(cfg, "external", True, True, n, 8, cuda, seed=n,
                     design=design)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4097])
def test_cuda_kernel_default_design(cuda, n):
    """Through ``step_mono``, the kernel runs the design ``lanes_for``
    picks, equal to the plain version."""
    cfg = load_config(bale_mode="events", max_steps=6)
    _kernel_vs_plain(cfg, "rule", True, True, n, 8, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("support,design", DESIGN_CASES)
def test_cuda_kernel_deep_event_log(cuda, support, design):
    """A deep event log (E = 904 rows) with presses finishing every step or
    two, on a ragged batch."""
    cfg = _cfg(support, max_steps=600, press_time_1=1, press_time_2=2,
               balesize=16)
    assert cfg.max_press_events > 900
    st = _kernel_vs_plain(cfg, "rule", True, True, 257, 40, cuda,
                          design=design)
    assert int(st.ev_cnt.max()) > 20


@pytest.mark.cuda
def test_cuda_kernel_matches_cpu_path(cuda):
    cfg = load_config(bale_mode="events", max_steps=30)
    step = TB.mono_autoreset_step(cfg, "rule")
    st_g = TB.reset_batch(cfg, 4, 512, device=cuda)
    st_c = TB.reset_batch(cfg, 4, 512, device="cpu")
    for _ in range(40):
        st_g, out_g = step(st_g, None)
        st_c, out_c = step(st_c, None)
    for nm, a, b in zip(TB.BState._fields, st_g, st_c):
        if a is not None:
            assert torch.equal(a.cpu(), b), f"state.{nm}"
