"""The port's sorting-core kernels (ops/sort_cuda.py, ops/mvhg_cuda.py) and
the frozen-sort press step that runs the first of them.

On the CPU:
* ``sort_material_plain`` against the JAX package's Pallas kernel
  ``sort_pallas.sort_material_fused`` in interpret mode, bitwise (leftover,
  true, false and the new keys), at 128 envs on stepped states of the
  default and noise-0.05 configs;
* ``sort_redistribute_plain`` against ``mvhg_pallas.sort_redistribute`` in
  interpret mode, bitwise, as tests/test_pallas_mvhg.py holds the JAX
  kernel to ``fastb.redistribute_u``, also at the JAX kernel's default
  support of 128;
* kernel 3's design table and checks (``mvhg_cuda.lanes_for``, supports 1
  to 128);
* the frozen-sort ``fastb.step_press`` against the JAX engine's, with the
  tuned sort agent of ``artifacts/models_tuned``, every leaf bitwise over
  40 autoreset steps at 64 envs, masked and unmasked.  The sorting reward
  is not in this step; the sort agent's argmax is compared on the same
  observations, and a split tie would be reported with its logit margin;
* the kernels' plain versions never reach the sorting-core kernel's
  wrapper, and the frozen-sort press step reaches it once per step.

On the card (marker ``cuda``, skipped without one): each kernel against its
plain version, bitwise, at 1, 127, 4096, 4097 and 65536 envs, in every
design that covers the support -- kernel 2 (``sort_cuda.DESIGNS``) at
supports 16, 24, 32, 40 and 88, kernel 3 (``mvhg_cuda.REDISTRIBUTE_DESIGNS``)
at those and at 128 -- and the frozen-sort press step through kernel 2
against its plain path.  JAX is imported only inside the CPU tests, so the
card's tests run where JAX is absent:
    python -m pytest tests/test_torch_sort_kernel.py -m cuda --noconftest -o addopts=""
"""
import os

import numpy as np
import pytest
import torch

from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import fastb as TB
from marl_sortingenv_tpu_torch.models import mlp
from marl_sortingenv_tpu_torch.ops import mvhg_cuda, sort_cuda, step_cuda

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

SORT_NPZ = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                        "models_tuned", "PPO_Sorting_Tuned_100000.npz")
CONFIGS = {"default": {}, "noise_0.05": {"noise_sorting": 0.05}}


def _stepped(cfg, n, steps, seed=3, device="cpu"):
    """A state after ``steps`` rule steps (the step kernel on CUDA)."""
    st = TB.reset_batch(cfg, seed, n, device=device)
    step = TB.mono_autoreset_step(cfg, "rule")
    for _ in range(steps):
        st, _ = step(st, None)
    return st


def _sort_inputs(cfg, st):
    """The sorting core's operands of the next step: the belt's counts
    move to the sorter, the belt's accuracy becomes the sorter's."""
    return (st.belt_counts.contiguous(), st.acc_belt.contiguous(),
            st.key.contiguous())


# ---------------------------------------------------------------------------
# CPU: plain versions == the JAX Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cname", sorted(CONFIGS))
@pytest.mark.parametrize("steps", [5, 198])
def test_sort_material_plain_matches_pallas(cname, steps):
    """Bitwise, every output and the new keys, 128 envs."""
    import jax.numpy as jnp
    from marl_sortingenv_tpu.ops import sort_pallas

    cfg = load_config(bale_mode="events", **CONFIGS[cname])
    st = _stepped(cfg, 128, steps)
    counts, acc, keys = _sort_inputs(cfg, st)
    support = TB._support_for(cfg)
    assert int(counts.sum()) > 0
    got = sort_cuda.sort_material_plain(counts, acc, keys, support)
    ref = sort_pallas.sort_material_fused(
        jnp.asarray(counts.numpy()), jnp.asarray(acc.numpy()),
        jnp.asarray(keys.numpy().view(np.uint32)), support=support,
        interpret=True)
    for nm, a, b in zip(("leftover", "true", "false", "keys"), got, ref):
        b = np.asarray(b)
        if nm == "keys":
            b = b.view(np.int32)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=nm)


def test_sort_redistribute_plain_matches_pallas():
    """Bitwise at support 104 on random inputs (counts < 80, accuracies
    with and without noise), as tests/test_pallas_mvhg.py:87 does."""
    import jax.numpy as jnp
    from marl_sortingenv_tpu.ops import mvhg_pallas

    rng = np.random.default_rng(3)
    n = 32
    counts = rng.integers(0, 80, (n, 4)).astype(np.int32)
    acc = np.where(rng.random((n, 4)) < 0.5, 1.0, 0.75).astype(np.float32)
    acc[: n // 2] = np.clip(acc[: n // 2] + rng.uniform(
        -0.05, 0.05, (n // 2, 4)), 0, 1).astype(np.float32)
    uniforms = rng.random((n, 12)).astype(np.float32)
    got = mvhg_cuda.sort_redistribute_plain(
        torch.from_numpy(counts), torch.from_numpy(acc),
        torch.from_numpy(uniforms), 104)
    ref = mvhg_pallas.sort_redistribute(
        jnp.asarray(counts), jnp.asarray(acc), jnp.asarray(uniforms),
        interpret=True, support=104)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("cname", sorted(CONFIGS))
def test_sort_redistribute_plain_matches_pallas_on_engine_states(cname):
    """Bitwise at the engine's own support (16), on a stepped state with
    the uniforms the engine draws (``fastb._sort_uniforms``)."""
    import jax.numpy as jnp
    from marl_sortingenv_tpu.ops import mvhg_pallas

    cfg = load_config(bale_mode="events", **CONFIGS[cname])
    support = TB._support_for(cfg)
    st = _stepped(cfg, 64, 7)
    counts, acc, keys = _sort_inputs(cfg, st)
    us, _ = TB._sort_uniforms(keys)
    c, a, u = counts.T.contiguous(), acc.T.contiguous(), us.T.contiguous()
    got = mvhg_cuda.sort_redistribute_plain(c, a, u, support)
    ref = mvhg_pallas.sort_redistribute(
        jnp.asarray(c.numpy()), jnp.asarray(a.numpy()),
        jnp.asarray(u.numpy()), interpret=True, support=support)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    # kernel 2's plain version computes the same redistribution
    for x, y in zip(got, sort_cuda.sort_material_plain(counts, acc, keys,
                                                       support)):
        assert torch.equal(x, y.T)


def _wide_operands(n, seed=128):
    """Kernel 3's operands at support 128 (as chip_smoke.py makes them):
    counts in [0, 160), accuracies in [0.2, 1), so a station's false units,
    the upper end of its draws, reach up to 127."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 160, (n, 4)).astype(np.int32),
            rng.uniform(0.2, 1.0, (n, 4)).astype(np.float32),
            rng.random((n, 12)).astype(np.float32))


def _mvhg_test_operands():
    """The inputs of tests/test_pallas_mvhg.py::
    test_kernel_invariants_interpret, from the same numpy seed."""
    rng = np.random.default_rng(0)
    n = 16
    counts = rng.integers(0, 60, (n, 4)).astype(np.int32)
    acc = np.full((n, 4), 0.75, np.float32)
    acc[:, 0] = 1.0
    return counts, acc, rng.random((n, 12)).astype(np.float32)


@pytest.mark.parametrize("inputs", ["mvhg_tests", "wide"])
def test_sort_redistribute_plain_matches_pallas_at_default_support(inputs):
    """Bitwise at support 128, the JAX kernel's default (its lane width),
    which the port's kernel 3 takes beyond the engine's cap of 104."""
    import jax.numpy as jnp
    from marl_sortingenv_tpu.ops import mvhg_pallas

    assert mvhg_pallas.SUPPORT == mvhg_cuda.SUPPORT == 128
    counts, acc, uniforms = (_mvhg_test_operands() if inputs == "mvhg_tests"
                             else _wide_operands(64))
    got = mvhg_cuda.sort_redistribute_plain(
        torch.from_numpy(counts), torch.from_numpy(acc),
        torch.from_numpy(uniforms), 128)
    ref = mvhg_pallas.sort_redistribute(
        jnp.asarray(counts), jnp.asarray(acc), jnp.asarray(uniforms),
        interpret=True)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if inputs == "wide":
        # station 0's first draw has hi = its false units: past the cap 104
        assert int(got[2][:, 0].max()) > 104


def test_redistribute_lanes_for_covers_every_support():
    """Kernel 3's table gives a built design that covers every support 1 ..
    128 at any batch size; 0 and 129 raise."""
    for support in range(1, 129):
        for n in (1, 4096, 65536):
            d = mvhg_cuda.lanes_for(support, n)
            assert d in mvhg_cuda.REDISTRIBUTE_DESIGNS
            assert mvhg_cuda.DESIGN_SET.covers(d, support)
            assert d[1] >= support and d[1] % d[0] == 0
    for support in (0, 129):
        with pytest.raises(ValueError, match="support"):
            mvhg_cuda.lanes_for(support, 4096)


def test_redistribute_design_checks():
    """Kernel 3's own design list: a design that is not built, or that does
    not cover the support, raises; supports 105 .. 128 only at cap 128;
    support 0 and 129 raise in the checks and in the plain version."""
    D = mvhg_cuda.DESIGN_SET
    assert D.check_design([32, 128], 128) == (32, 128)
    assert D.check_design((32, 128), 105) == (32, 128)
    assert D.check_design((1, 16), 16) == (1, 16)
    for design in ((1, 104), (1, 128), (16, 128), (8, 32)):
        with pytest.raises(ValueError, match="not built"):
            D.check_design(design, 16)
    with pytest.raises(ValueError, match="covers supports up to 64"):
        D.check_design((32, 64), 88)
    with pytest.raises(ValueError, match="one-lane design runs at its cap"):
        D.check_design((1, 16), 12)
    assert D.designs_for(105) == [(32, 128)]
    assert D.designs_for(12) == [(16, 16), (32, 32), (32, 64), (32, 128)]
    for support in (0, 129):
        with pytest.raises(ValueError, match="support"):
            D.check_design((32, 128), support)
    z = torch.zeros((8, 4), dtype=torch.int32)
    for support in (0, 129):
        with pytest.raises(ValueError, match="support"):
            mvhg_cuda.sort_redistribute_plain(z, torch.zeros((8, 4)),
                                              torch.zeros((8, 12)), support)


@pytest.mark.parametrize("built", ["same", "fewer", "other"])
def test_design_set_binds_only_its_own_designs(built):
    """A library whose ``<name>_designs()`` lists other designs than the
    wrapper's is refused when it is bound (a stand-in for the built
    library)."""
    want = mvhg_cuda.REDISTRIBUTE_DESIGNS
    pairs = {"same": want, "fewer": want[:-1],
             "other": ((2, 16),) + want[1:]}[built]

    def designs(buf, room):
        for j, (lanes, cap) in enumerate(pairs[:room]):
            buf[2 * j], buf[2 * j + 1] = lanes, cap
        return len(pairs)

    lib = type("Lib", (), {"sort_redistribute_designs": staticmethod(
        designs)})()
    if built == "same":
        mvhg_cuda.DESIGN_SET.bind(lib, "sort_redistribute")
    else:
        with pytest.raises(RuntimeError, match="the wrapper expects"):
            mvhg_cuda.DESIGN_SET.bind(lib, "sort_redistribute")


def test_wrappers_take_plain_versions_on_cpu():
    cfg = load_config(bale_mode="events")
    st = _stepped(cfg, 16, 4)
    counts, acc, keys = _sort_inputs(cfg, st)
    before = (sort_cuda.LAUNCHES, mvhg_cuda.LAUNCHES)
    a = sort_cuda.sort_material(counts, acc, keys, 16)
    b = sort_cuda.sort_material_plain(counts, acc, keys, 16)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    us, _ = TB._sort_uniforms(keys)
    a = mvhg_cuda.sort_redistribute(counts.T, acc.T, us.T, 16)
    b = mvhg_cuda.sort_redistribute_plain(counts.T, acc.T, us.T, 16)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (sort_cuda.LAUNCHES, mvhg_cuda.LAUNCHES) == before


def test_sort_kernel_checks_its_arguments():
    """The sorting-core kernel's wrapper refuses CPU tensors before it
    picks a design; the design checks are plain Python."""
    z4 = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        sort_cuda.sort_material_kernel(z4, torch.zeros((4, 8)),
                                       torch.zeros((8, 2), dtype=torch.int32),
                                       16, design=(16, 16))
    assert sort_cuda.lanes_for(16, 4096) in sort_cuda.DESIGNS
    with pytest.raises(ValueError, match="covers supports up to 32"):
        sort_cuda.DESIGN_SET.check_design((32, 32), 40)
    with pytest.raises(ValueError, match="support"):
        sort_cuda.lanes_for(105, 1)


def test_kernels_refuse_cpu_tensors_and_large_supports():
    z4 = torch.zeros((4, 8), dtype=torch.int32)
    a4 = torch.zeros((4, 8))
    k = torch.zeros((8, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        sort_cuda.sort_material_kernel(z4, a4, k, 16)
    with pytest.raises(ValueError, match="CUDA"):
        mvhg_cuda.sort_redistribute_kernel(z4.T, a4.T,
                                           torch.zeros((8, 12)), 16)
    with pytest.raises(ValueError, match="CUDA"):
        mvhg_cuda.sort_redistribute_kernel(z4.T, a4.T, torch.zeros((8, 12)),
                                           128, design=(32, 128))
    # the JAX kernel's default support, 128, is the largest kernel 3 takes
    with pytest.raises(ValueError, match="support"):
        mvhg_cuda.sort_redistribute_plain(z4.T, a4.T,
                                          torch.zeros((8, 12)), 129)


# ---------------------------------------------------------------------------
# CPU: the frozen-sort press step == the JAX engine's
# ---------------------------------------------------------------------------

def _assert_same(st_a, out_a, st_b, out_b, tag=""):
    for nm, a, b in zip(TB.BState._fields, st_a, st_b):
        if a is None:
            assert b is None, nm
            continue
        assert a.dtype == b.dtype, (tag, nm)
        assert torch.equal(a.cpu(), b.cpu()), f"{tag} state.{nm}"
    if out_a is not None:
        for nm in TB.BStepOut._fields:
            a, b = getattr(out_a, nm).cpu(), getattr(out_b, nm).cpu()
            assert a.dtype == b.dtype, (tag, nm)
            assert torch.equal(a, b), f"{tag} out.{nm}"


def _jax_to_torch(st_j):
    kw = {}
    for nm, x in zip(TB.BState._fields, st_j):
        if x is None:
            kw[nm] = None
            continue
        a = np.asarray(x)
        kw[nm] = torch.from_numpy(np.array(a.view(np.int32) if nm == "key"
                                           else a))
    return TB.BState(**kw)


@pytest.mark.parametrize("masked", [True, False])
def test_frozen_sort_press_matches_jax(masked):
    """40 autoreset steps at 64 envs (max_steps 30, so the run crosses a
    reset), every state leaf and every output bitwise."""
    import jax
    import jax.numpy as jnp
    from marl_sortingenv_tpu.config.config import load_config as jload
    from marl_sortingenv_tpu.core import fastb as FB
    from marl_sortingenv_tpu.models import mlp as jmlp
    from marl_sortingenv_tpu.utils.checkpoint import load_model

    kw = dict(bale_mode="events", max_steps=30)
    cfg_j, cfg_t = jload(**kw), load_config(**kw)
    sp_j = load_model(SORT_NPZ, jmlp.init_params(jax.random.PRNGKey(0),
                                                 13, 2))
    sp_t = mlp.load_npz(SORT_NPZ, device="cpu").requires_grad_(False)
    n = 64
    step_j = jax.jit(FB.with_autoreset(cfg_j, lambda c, s, a: FB.step_press(
        c, s, a, (jmlp.policy_logits, sp_j), masked)))
    step_t = TB.with_autoreset(cfg_t, lambda c, s, a: TB.step_press(
        c, s, a, sp_t, masked))
    st_j = FB.reset_batch(cfg_j, jax.random.PRNGKey(5), n)
    st_t = TB.reset_batch(cfg_t, 5, n, device="cpu")
    rng = np.random.default_rng(5)
    launches = (sort_cuda.LAUNCHES, step_cuda.LAUNCHES)
    for t in range(40):
        # the sort agent acts on the post-update sort observation: check
        # its argmax on that observation first, with the margin on a split
        obs = TB.get_sort_obs(cfg_t, TB._update_environment(cfg_t, st_t))
        lg_t = sp_t.policy_logits(obs).numpy()
        lg_j = np.asarray(jmlp.policy_logits(sp_j, jnp.asarray(obs.numpy())))
        split = np.argmax(lg_t, -1) != np.argmax(lg_j, -1)
        assert not split.any(), (
            f"step {t}: argmax tie split, logit margins "
            f"{np.abs(lg_j[split, 0] - lg_j[split, 1])}")
        a = rng.integers(0, 11, n).astype(np.int32)
        st_j, out_j = step_j(st_j, jnp.asarray(a))
        st_t, out_t = step_t(st_t, torch.from_numpy(a))
        _assert_same(_jax_to_torch(st_j), None, st_t, None, f"step {t}")
        for nm in TB.BStepOut._fields:
            x = torch.from_numpy(np.array(getattr(out_j, nm)))
            y = getattr(out_t, nm)
            assert torch.equal(x.to(y.dtype), y), f"step {t} out.{nm}"
    assert (sort_cuda.LAUNCHES, step_cuda.LAUNCHES) == launches
    assert int(st_t.current_step.max()) < 40, "no reset was crossed"


@pytest.mark.parametrize("variant", ["rule", "external", "sort", "press",
                                     "press_frozen_sort"])
def test_plain_entries_skip_the_kernel_wrapper(monkeypatch, variant):
    """The eager bodies reach the sorting-core kernel's wrapper by default;
    the kernels' plain versions (``eager_step``, ``step_mono_plain``) never
    do, so on the card they launch no kernel.  The frozen-sort
    ``step_press`` calls the wrapper once per step."""
    calls = []
    real = sort_cuda.sort_material
    monkeypatch.setattr(sort_cuda, "sort_material",
                        lambda *a: calls.append(1) or real(*a))
    cfg = load_config(bale_mode="events", max_steps=30)
    sp = (mlp.load_npz(SORT_NPZ, device="cpu").requires_grad_(False)
          if variant == "press_frozen_sort" else None)
    v = "press" if sp is not None else variant
    st = TB.reset_batch(cfg, 4, 8, device="cpu")
    a = torch.zeros(8, dtype=torch.int32)
    TB.eager_step(v, True, sp)(cfg, st, a)
    if sp is None:
        step_cuda.step_mono_plain(cfg, st, a, variant=v, autoreset=True)
    assert calls == []
    if sp is not None:
        TB.step_press(cfg, st, a, sp)
        assert calls == [1]


# ---------------------------------------------------------------------------
# CUDA: kernels == plain versions on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sort kernels have no CPU mode")
    return torch.device("cuda")


GENERIC = {"baseline_accuracy": (0.5, 0.5, 0.5, 0.5)}
# configs by sampler support (fastb._support_for)
SUPPORT_CFGS = {16: {}, 24: {"noise_sorting": 0.2}, 32: GENERIC,
                40: {"baseline_accuracy": (0.2, 0.2, 0.2, 0.2)},
                88: {"input_batch_size": 250,
                     "baseline_accuracy": (0.2, 0.2, 0.2, 0.2)}}
# every (support, design) pair with the design covering the support; None
# is the design lanes_for picks, through sort_material
SORT_CASES = [(s, d) for s in sorted(SUPPORT_CFGS)
              for d in [None] + sort_cuda.DESIGN_SET.designs_for(s)]


def _case_id(v):
    if isinstance(v, tuple):
        return f"L{v[0]}c{v[1]}"
    return "picked" if v is None else f"s{v}"


# kernel 3's pairs: the configs' supports and 128 (numpy operands); the
# picked designs at 16 and 32 keep the ids "s16" and "generic"
REDISTRIBUTE_CASES = [
    pytest.param(s, d, id={16: "s16", 32: "generic"}[s] if d is None
                 and s in (16, 32) else f"{_case_id(s)}-{_case_id(d)}")
    for s in sorted(SUPPORT_CFGS) + [128]
    for d in [None] + mvhg_cuda.DESIGN_SET.designs_for(s)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 4096, 4097, 65536])
@pytest.mark.parametrize("support,design", SORT_CASES, ids=_case_id)
def test_cuda_sort_material_matches_plain(cuda, n, support, design):
    cfg = load_config(bale_mode="events", **SUPPORT_CFGS[support])
    assert TB._support_for(cfg) == support
    st = _stepped(cfg, n, 9, device=cuda)
    counts, acc, keys = _sort_inputs(cfg, st)
    before = sort_cuda.LAUNCHES
    if design is None:
        got = sort_cuda.sort_material(counts, acc, keys, support)
    else:
        got = sort_cuda.sort_material_kernel(counts, acc, keys, support,
                                             design=design)
    assert sort_cuda.LAUNCHES == before + 1
    ref = sort_cuda.sort_material_plain(counts, acc, keys, support)
    torch.cuda.synchronize()
    assert sort_cuda.LAUNCHES == before + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 4096, 4097, 65536])
@pytest.mark.parametrize("support,design", REDISTRIBUTE_CASES)
def test_cuda_sort_redistribute_matches_plain(cuda, n, support, design):
    """Kernel 3 in every design that covers the support (None: the one
    ``lanes_for`` picks, through ``sort_redistribute``): on a stepped
    engine state with the uniforms the engine draws, where kernel 2 must
    give the same split, or at support 128 on numpy operands whose draws
    reach past the engine's cap."""
    if support == 128:
        c, a, u = (torch.from_numpy(x).to(cuda) for x in _wide_operands(n))
    else:
        cfg = load_config(bale_mode="events", **SUPPORT_CFGS[support])
        assert TB._support_for(cfg) == support
        st = _stepped(cfg, n, 9, device=cuda)
        counts, acc, keys = _sort_inputs(cfg, st)
        us, _ = TB._sort_uniforms(keys)
        c, a, u = (x.T.contiguous() for x in (counts, acc, us))
    before = mvhg_cuda.LAUNCHES
    if design is None:
        got = mvhg_cuda.sort_redistribute(c, a, u, support)
    else:
        got = mvhg_cuda.sort_redistribute_kernel(c, a, u, support,
                                                 design=design)
    ref = mvhg_cuda.sort_redistribute_plain(c, a, u, support)
    torch.cuda.synchronize()
    assert mvhg_cuda.LAUNCHES == before + 1
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    if support < 128:
        # kernel 2 on the same draws gives the same split
        for x, y in zip(got, sort_cuda.sort_material(counts, acc, keys,
                                                     support)):
            assert torch.equal(x, y.T)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [True, False])
def test_cuda_frozen_sort_press_matches_plain(cuda, masked):
    """The frozen-sort press step through kernel 2 == its plain path on the
    card, every leaf bitwise over 30 autoreset steps across a reset; kernel
    2 launches once per step and the step kernel not at all."""
    cfg = load_config(bale_mode="events", max_steps=20)
    sp = mlp.load_npz(SORT_NPZ, device=cuda).requires_grad_(False)
    step_k = TB.with_autoreset(cfg, lambda c, s, a: TB.step_press(
        c, s, a, sp, masked))
    step_p = TB.with_autoreset(cfg, TB.eager_step("press", masked, sp))
    st_k = st_p = TB.reset_batch(cfg, 2, 1000, device=cuda)
    gen = torch.Generator().manual_seed(2)
    for t in range(30):
        a = torch.randint(0, 11, (1000,), generator=gen,
                          dtype=torch.int32).to(cuda)
        k0, s0 = sort_cuda.LAUNCHES, step_cuda.LAUNCHES
        st_k, o_k = step_k(st_k, a)
        assert (sort_cuda.LAUNCHES, step_cuda.LAUNCHES) == (k0 + 1, s0)
        st_p, o_p = step_p(st_p, a)
        assert (sort_cuda.LAUNCHES, step_cuda.LAUNCHES) == (k0 + 1, s0)
        _assert_same(st_k, o_k, st_p, o_p, f"step {t}")
    torch.cuda.synchronize()
