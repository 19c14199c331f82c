"""The port's PCG64 streams (marl_sortingenv_tpu_torch/core/rng.py) against
NumPy's ``Generator`` directly and against the JAX package's
``core/rng.py``, on 8 batched seeds: ``next_uint64``, ``next_uint32``
across the buffer, ``random()``, ``uniform``, ``integers`` at ranges 1,
2, 22 and one above 2**32, ``random_interval32``, ``shuffle_consume(100)``
(the bit generator's whole state afterwards equals ``Generator.shuffle``'s,
at two batch sizes and two jump-ahead block lengths), ``choice_p`` on
4-vectors with zeros and ``choice_n``.  All bitwise."""
import numpy as np
import pytest
import torch

import jax

from marl_sortingenv_tpu.core import rng as JR
from marl_sortingenv_tpu_torch.core import rng as R
from marl_sortingenv_tpu_torch.core import state as S

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

SEEDS = [0, 1, 2, 42, 99, 12345, 2**31, 987654321]


def gens(seeds=SEEDS):
    return [np.random.default_rng(s) for s in seeds]


def full_state(s: R.PCG64State, i: int) -> dict:
    """Env i's stream as NumPy's ``bit_generator.state`` fields."""
    hi = int(s.state_hi[i]) & (2**64 - 1)
    lo = int(s.state_lo[i]) & (2**64 - 1)
    ih = int(s.inc_hi[i]) & (2**64 - 1)
    il = int(s.inc_lo[i]) & (2**64 - 1)
    return {"state": (hi << 64) | lo, "inc": (ih << 64) | il,
            "has_uint32": int(s.has_uint32[i]),
            "uinteger": int(s.uinteger[i])}


def assert_matches_numpy(s, gs):
    for i, g in enumerate(gs):
        want = g.bit_generator.state
        got = full_state(s, i)
        assert got["state"] == want["state"]["state"], i
        assert got["inc"] == want["state"]["inc"], i
        assert got["has_uint32"] == want["has_uint32"], i
        if want["has_uint32"]:
            assert got["uinteger"] == want["uinteger"], i


def test_seeding_and_next_uint64():
    s = R.pcg64_init(SEEDS, device="cpu")
    assert_matches_numpy(s, gens())
    vals = []
    for _ in range(40):
        v, s = R.next_uint64(s)
        vals.append(v)
    got = torch.stack(vals, 1).numpy().view(np.uint64)
    for i, seed in enumerate(SEEDS):
        np.testing.assert_array_equal(got[i],
                                      np.random.PCG64(seed).random_raw(40))


def test_jump_ahead_equals_sequential_steps():
    s = R.pcg64_init(SEEDS, device="cpu")
    hi, lo, out = R._jump(s, 50)
    for k in range(50):
        v, s = R.next_uint64(s)
        assert torch.equal(out[:, k], v)
        assert torch.equal(hi[:, k], s.state_hi)
        assert torch.equal(lo[:, k], s.state_lo)


def test_mixed_draws_against_numpy_and_jax():
    """A sequence mixing 32- and 64-bit draws (the buffer crossing both),
    each step against NumPy and the JAX package's draws."""
    s = R.pcg64_init(SEEDS, device="cpu")
    sj = JR.pcg64_init(np.asarray(SEEDS))
    gs = gens()
    def vj(f):
        return jax.jit(jax.vmap(f))

    draws = [
        (lambda s: R.next_uint32(s),
         vj(JR.next_uint32),
         # rng 0xFFFFFFFF: NumPy returns the buffered 32-bit draw itself
         lambda g: int(g.integers(0, 2**32, dtype=np.uint32))),
        (lambda s: R.next_double(s), vj(JR.next_double),
         lambda g: g.random()),
        (lambda s: R.uniform(s, -0.05, 0.05),
         vj(lambda x: JR.uniform(x, -0.05, 0.05)),
         lambda g: g.uniform(-0.05, 0.05)),
        (lambda s: R.integers(s, 0, 1),
         vj(lambda x: JR.integers(x, 0, 1)),
         lambda g: int(g.integers(0, 1))),
        (lambda s: R.integers(s, 0, 2),
         vj(lambda x: JR.integers(x, 0, 2)),
         lambda g: int(g.integers(0, 2))),
        (lambda s: R.integers(s, 0, 22),
         vj(lambda x: JR.integers(x, 0, 22)),
         lambda g: int(g.integers(0, 22))),
        (lambda s: R.integers(s, 0, 10**12),
         vj(lambda x: JR.integers(x, 0, 10**12)),
         lambda g: int(g.integers(0, 10**12))),
        (lambda s: R.integers(s, 60, 81),
         vj(lambda x: JR.integers(x, 60, 81)),
         lambda g: int(g.integers(60, 81))),
    ]
    order = np.random.default_rng(0).integers(0, len(draws), 120)
    for k in order:
        f_t, f_j, f_np = draws[k]
        v, s = f_t(s)
        vj_, sj = f_j(sj)
        want = [f_np(g) for g in gs]
        assert v.tolist() == want, k
        assert v.tolist() == np.asarray(vj_).tolist(), k
    assert_matches_numpy(s, gs)


@pytest.mark.parametrize("n_env", [8, 24])
def test_random_interval_and_shuffle_against_jax(n_env):
    """``random_interval32`` at a batch of maxima (0 consumes nothing)
    interleaved with ``shuffle_consume(100)``, against the JAX package
    (NumPy reaches ``random_interval`` only through ``shuffle``)."""
    seeds = list(range(300, 300 + n_env))
    s = R.pcg64_init(seeds, device="cpu")
    sj = JR.pcg64_init(np.asarray(seeds))
    for rep in range(5):
        mx = np.random.default_rng(rep).integers(0, 300, n_env)
        mx[0] = 0
        v, s = R.random_interval32(s, torch.from_numpy(mx))
        vj_, sj = jax.vmap(JR.random_interval32)(sj, mx.astype(np.uint32))
        assert v.tolist() == np.asarray(vj_).tolist()
        s = R.shuffle_consume(s, 100)
        sj = jax.vmap(lambda x: JR.shuffle_consume(x, 100))(sj)
    for got, want in zip(S.to_numpy(s), jax.tree.leaves(sj)):
        assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("block", [R._SHUFFLE_BLOCK, 32])
def test_shuffle_state_equals_numpy(monkeypatch, block):
    """Two batch sizes; with a block of 32 draws (64 words) every shuffle
    of 100 takes several blocks, the path a block too short for an env's
    rejections takes."""
    monkeypatch.setattr(R, "_SHUFFLE_BLOCK", block)
    for n_env in (8, 24):
        seeds = list(range(700, 700 + n_env))
        s, gs = R.pcg64_init(seeds, device="cpu"), gens(seeds)
        for rep in range(4):
            # an odd number of 32-bit draws before: the buffer is full
            v, s = R.integers(s, 0, 7)
            for g in gs:
                g.integers(0, 7)
            s = R.shuffle_consume(s, 100)
            for g in gs:
                g.shuffle(np.arange(100))
            assert_matches_numpy(s, gs)


def test_choice_p_and_choice_n():
    s, gs = R.pcg64_init(SEEDS, device="cpu"), gens()
    sj = JR.pcg64_init(np.asarray(SEEDS))
    rng = np.random.default_rng(5)
    choice_p = jax.jit(jax.vmap(JR.choice_p))
    choice_n = jax.jit(jax.vmap(lambda x: JR.choice_n(x, 11)))
    for _ in range(30):
        w = rng.integers(0, 4, (len(SEEDS), 4)).astype(np.float64)
        w[:, 2] += 1.0                      # never all zero
        p = w / w.sum(1, keepdims=True)
        v, s = R.choice_p(s, torch.from_numpy(p))
        vj_, sj = choice_p(sj, p)
        want = [int(g.choice(4, p=p[i])) for i, g in enumerate(gs)]
        assert v.tolist() == want == np.asarray(vj_).tolist()
        v, s = R.choice_n(s, 11)
        vj_, sj = choice_n(sj)
        want = [int(g.choice(11)) for g in gs]
        assert v.tolist() == want == np.asarray(vj_).tolist()
    assert_matches_numpy(s, gs)
