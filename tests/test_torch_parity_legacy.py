"""The port's legacy ``RandomState`` stream (marl_sortingenv_tpu_torch/core/
legacy_random.py) against NumPy's ``RandomState`` and the JAX package's
``core/legacy_random.py``: seeding, then ``legacy_randint`` at per-env
ranges 1..22 (``n == 1`` consumes nothing) over 900 draws, across a
twist of the 624-word state; the values and the whole MT state bitwise."""
import numpy as np
import torch

import jax

from marl_sortingenv_tpu.core import legacy_random as JLR
from marl_sortingenv_tpu_torch.core import legacy_random as LR
from marl_sortingenv_tpu_torch.core import state as S

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

SEEDS = [1, 2, 3, 10, 42, 2**31 - 1]


def assert_state(s, rs):
    for i, r in enumerate(rs):
        _, key, pos, *_ = r.get_state()
        assert np.array_equal(s.key[i].numpy(), key.astype(np.int64)), i
        assert int(s.pos[i]) == pos, i


def test_seeding_matches_numpy():
    assert_state(LR.mt19937_init(SEEDS, device="cpu"),
                 [np.random.RandomState(s) for s in SEEDS])


def test_legacy_randint_against_numpy_and_jax():
    s = LR.mt19937_init(SEEDS, device="cpu")
    sj = JLR.mt19937_init(np.asarray(SEEDS))
    rs = [np.random.RandomState(x) for x in SEEDS]
    draw_j = jax.jit(jax.vmap(JLR.legacy_randint))
    rng = np.random.default_rng(0)
    twisted = False
    for t in range(900):
        n = rng.integers(1, 23, len(SEEDS))
        n[t % len(SEEDS)] = 1
        v, s = LR.legacy_randint(s, torch.from_numpy(n))
        vj, sj = draw_j(sj, n.astype(np.int32))
        want = [int(r.randint(0, int(k))) for r, k in zip(rs, n)]
        assert v.tolist() == want == np.asarray(vj).tolist(), t
        twisted |= bool((s.pos < 10).any()) and t > 10
    assert twisted, "no stream crossed a twist"
    assert_state(s, rs)
    for got, want in zip(S.to_numpy(s), jax.tree.leaves(sj)):
        assert got.dtype == np.asarray(want).dtype
        assert np.array_equal(got, np.asarray(want))


def test_fixed_range_22():
    """The unmasked monolith's ``np.random.randint(0, 22)`` at a fixed
    range (a host int), as ``np.random.choice(22)`` draws it."""
    s = LR.mt19937_init(SEEDS, device="cpu")
    rs = [np.random.RandomState(x) for x in SEEDS]
    for _ in range(700):
        v, s = LR.legacy_randint(s, 22)
        assert v.tolist() == [int(r.choice(22)) for r in rs]
    assert_state(s, rs)
