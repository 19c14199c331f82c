"""The port's sorting-core kernels (ops/sort_cuda.py, ops/mvhg_cuda.py) and
the frozen-sort press step that runs the first of them.

On the CPU:
* ``sort_material_plain`` against the JAX package's Pallas kernel
  ``sort_pallas.sort_material_fused`` in interpret mode, bitwise (leftover,
  true, false and the new keys), at 128 envs on stepped states of the
  default and noise-0.05 configs;
* ``sort_redistribute_plain`` against ``mvhg_pallas.sort_redistribute`` in
  interpret mode, bitwise, as tests/test_pallas_mvhg.py holds the JAX
  kernel to ``fastb.redistribute_u``;
* the frozen-sort ``fastb.step_press`` against the JAX engine's, with the
  tuned sort agent of ``artifacts/models_tuned``, every leaf bitwise over
  40 autoreset steps at 64 envs, masked and unmasked.  The sorting reward
  is not in this step; the sort agent's argmax is compared on the same
  observations, and a split tie would be reported with its logit margin;
* the kernels' plain versions never reach the sorting-core kernel's
  wrapper, and the frozen-sort press step reaches it once per step.

On the card (marker ``cuda``, skipped without one): each kernel against its
plain version, bitwise, at 1, 127, 4096, 4097 and 65536 envs and at
supports 16, 24, 32 and 40 -- kernel 2 in every design that covers the
support (``sort_cuda.DESIGNS``) -- and the frozen-sort press step through
kernel 2 against its plain path.  JAX is imported only inside the CPU tests, so the
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
        sort_cuda.check_design((32, 32), 40)
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
    with pytest.raises(ValueError, match="support"):
        mvhg_cuda.sort_redistribute_plain(z4.T, a4.T,
                                          torch.zeros((8, 12)), 128)


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
                40: {"baseline_accuracy": (0.2, 0.2, 0.2, 0.2)}}
# every (support, design) pair with the design covering the support; None
# is the design lanes_for picks, through sort_material
SORT_CASES = [(s, d) for s in sorted(SUPPORT_CFGS)
              for d in [None] + sort_cuda.designs_for(s)]


def _case_id(v):
    if isinstance(v, tuple):
        return f"L{v[0]}c{v[1]}"
    return "picked" if v is None else f"s{v}"


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
@pytest.mark.parametrize("cfg_kw", [{}, GENERIC], ids=["s16", "generic"])
def test_cuda_sort_redistribute_matches_plain(cuda, n, cfg_kw):
    cfg = load_config(bale_mode="events", **cfg_kw)
    support = TB._support_for(cfg)
    st = _stepped(cfg, n, 9, device=cuda)
    counts, acc, keys = _sort_inputs(cfg, st)
    us, _ = TB._sort_uniforms(keys)
    c, a, u = counts.T.contiguous(), acc.T.contiguous(), us.T.contiguous()
    before = mvhg_cuda.LAUNCHES
    got = mvhg_cuda.sort_redistribute(c, a, u, support)
    ref = mvhg_cuda.sort_redistribute_plain(c, a, u, support)
    torch.cuda.synchronize()
    assert mvhg_cuda.LAUNCHES == before + 1
    for x, y in zip(got, ref):
        assert torch.equal(x, y)
    # and kernel 2 on the same draws gives the same split
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
