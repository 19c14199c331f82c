"""The port's integer-exact engine (marl_sortingenv_tpu_torch/core/
exact_dynamics.py) against the JAX package's, on the CPU, with no
tolerance: every step variant without a policy at the benchmark config
(noise 0), 3 seeds x 25 steps; after each step every state leaf (the RNG
limbs and the accuracies' IEEE bits included) and every output (obs,
reward bits, logs, purity cents).  The JAX engine runs one env per call
(its step functions are jitted; a vmap of them traces far longer).  The
same variants at noise 0.05 are in test_torch_exact_noise.py, the
integer-policy steps in test_torch_exact_models.py, and the golden files
and the parity engine in test_torch_exact_golden.py.
"""
import numpy as np
import pytest
import torch

import jax

from marl_sortingenv_tpu.config.config import load_config as jload
from marl_sortingenv_tpu.core import exact_dynamics as JXD
from marl_sortingenv_tpu.core import legacy_random as JLR
from marl_sortingenv_tpu.core import state as JS
from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import exact_dynamics as XD
from marl_sortingenv_tpu_torch.core import legacy_random as LR
from marl_sortingenv_tpu_torch.core import state as S
from test_torch_parity_engine import assert_state_equal

torch.set_num_threads(1)

SEEDS = np.arange(1, 4)
STEPS = 25
N_ACT = {"sort": 2, "press": 11, "mono": 22}
CFG_KW = {0.0: dict(max_steps=200, noise_sorting=0.0, balesize=200),
          0.05: dict(max_steps=200, noise_sorting=0.05, balesize=200)}


def acts(kind, steps=STEPS, seed=5):
    if kind is None:
        return None
    return np.random.default_rng(seed).integers(
        0, N_ACT[kind], (steps, len(SEEDS))).astype(np.int32)


def stack(trees):
    """Per-env JAX pytrees as one batched pytree of numpy arrays."""
    return jax.tree.map(lambda *x: np.stack([np.asarray(v) for v in x]),
                        *trees)


def assert_out_equal(oj, ot, tag):
    for k, a in oj.items():
        if k == "reward_sfs":
            for f, x in zip(("s", "m", "e"), a):
                x = np.asarray(x)
                y = getattr(ot[k], f).numpy()
                assert np.array_equal(x.view(f"i{x.itemsize}"), y), (tag, f)
            continue
        a, b = np.asarray(a), ot[k].numpy()
        if a.dtype == np.uint64:
            b = b.view(np.uint64)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), (tag, k)
        assert np.array_equal(a, b), f"{tag}: out[{k!r}] differs"


def lockstep(step_j, step_t, cj, ct, actions, steps=STEPS, legacy=False):
    """Step both engines side by side, every leaf and output compared
    after each step.  ``step_j`` steps one JAX env; ``legacy``: the random
    step, with an MT19937 stream per env beside the state."""
    sj = [JS.reset(cj, int(s)) for s in SEEDS]
    st = S.reset(ct, SEEDS, device="cpu")
    if legacy:
        lj = [JLR.mt19937_init(int(s) + 1000) for s in SEEDS]
        lt = LR.mt19937_init(SEEDS + 1000, device="cpu")
    for t in range(steps):
        outs = []
        for i in range(len(SEEDS)):
            if legacy:
                sj[i], lj[i], o = step_j(sj[i], lj[i])
            else:
                a = None if actions is None else actions[t, i]
                sj[i], o = step_j(sj[i], a)
            outs.append(o)
        if legacy:
            st, lt, ot = step_t(st, lt)
            assert_state_equal(stack(lj), lt, f"step {t} (MT19937)")
        else:
            a = None if actions is None else torch.from_numpy(actions[t])
            st, ot = step_t(st, a)
        assert_state_equal(stack(sj), st, f"step {t}")
        assert_out_equal(stack(outs), ot, f"step {t}")


CASES = {
    "rule": (lambda c, s, a: JXD.step_mono_rule_exact(c, s),
             lambda c, s, a: XD.step_mono_rule_exact(c, s), None),
    "sort": (lambda c, s, a: JXD.step_sort_exact(c, s, a),
             lambda c, s, a: XD.step_sort_exact(c, s, a), "sort"),
    "press_masked": (lambda c, s, a: JXD.step_press_exact(c, s, a, True),
                     lambda c, s, a: XD.step_press_exact(c, s, a, True),
                     "press"),
    "press_unmasked": (lambda c, s, a: JXD.step_press_exact(c, s, a, False),
                       lambda c, s, a: XD.step_press_exact(c, s, a, False),
                       "press"),
    "external_masked": (
        lambda c, s, a: JXD.step_mono_external_exact(c, s, a, True),
        lambda c, s, a: XD.step_mono_external_exact(c, s, a, True), "mono"),
    "external_unmasked": (
        lambda c, s, a: JXD.step_mono_external_exact(c, s, a, False),
        lambda c, s, a: XD.step_mono_external_exact(c, s, a, False), "mono"),
    "random_masked": (
        lambda c, s, lr: JXD.step_mono_random_exact(c, s, lr, True),
        lambda c, s, lr: XD.step_mono_random_exact(c, s, lr, True),
        "legacy"),
    "random_unmasked": (
        lambda c, s, lr: JXD.step_mono_random_exact(c, s, lr, False),
        lambda c, s, lr: XD.step_mono_random_exact(c, s, lr, False),
        "legacy"),
}


def run_case(noise, j_fn, t_fn, kind):
    cj, ct = jload(**CFG_KW[noise]), load_config(**CFG_KW[noise])
    lockstep(lambda s, a: j_fn(cj, s, a), lambda s, a: t_fn(ct, s, a),
             cj, ct, None if kind == "legacy" else acts(kind),
             legacy=kind == "legacy")


@pytest.mark.parametrize("case", sorted(CASES))
def test_steps_noise0(case):
    run_case(0.0, *CASES[case])


def test_choice_and_parity_view():
    """``choice_p_exact`` draws as the JAX package's on random leftovers,
    and ``to_parity_view`` holds the same arrays."""
    from marl_sortingenv_tpu.core import rng as JR
    from marl_sortingenv_tpu_torch.core import rng as R
    rng = np.random.default_rng(0)
    avail = rng.integers(0, 30, (64, 4)).astype(np.int32)
    avail[3:6, 1:] = 0
    seeds = np.arange(64)
    gj = JR.pcg64_init(seeds)
    gt = R.pcg64_init(seeds, device="cpu")
    choice = jax.jit(jax.vmap(JXD.choice_p_exact))
    for _ in range(3):
        ij, gj = choice(gj, avail)
        it, gt = XD.choice_p_exact(gt, torch.from_numpy(avail))
        assert np.array_equal(np.asarray(ij), it.numpy())
        assert np.array_equal(np.asarray(gj.state_lo).view(np.int64),
                              gt.state_lo.numpy())
    cj, ct = jload(**CFG_KW[0.0]), load_config(**CFG_KW[0.0])
    st, _ = XD.step_mono_rule_exact(ct, S.reset(ct, SEEDS, device="cpu"))
    sj = stack([JXD.step_mono_rule_exact(cj, JS.reset(cj, int(s)))[0]
                for s in SEEDS])
    vj, vt = JXD.to_parity_view(sj), XD.to_parity_view(st)
    assert sorted(vj) == sorted(vt)
    for k in vj:
        assert np.array_equal(vj[k], vt[k]), k
