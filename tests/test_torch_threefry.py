"""The port's eager threefry (marl_sortingenv_tpu_torch/core/threefry.py)
bitwise against jax.random on 20,000 keys, a quarter of them with the top
bit set in the first word and a quarter in the second."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_sortingenv_tpu_torch.core import threefry as TF

N_KEYS = 20_000


@pytest.fixture(scope="module")
def keys():
    rng = np.random.default_rng(1234)
    k = rng.integers(0, 2**32, size=(N_KEYS, 2), dtype=np.uint64)
    k = k.astype(np.uint32)
    k[: N_KEYS // 4, 0] |= np.uint32(0x80000000)
    k[N_KEYS // 4: N_KEYS // 2, 1] |= np.uint32(0x80000000)
    return jnp.asarray(k), torch.from_numpy(k.view(np.int32))


def _eq(a_jax, b_torch):
    a = np.asarray(a_jax)
    b = b_torch.numpy()
    if a.dtype == np.uint32 and b.dtype == np.int32:
        a = a.view(np.int32)
    np.testing.assert_array_equal(a.astype(b.dtype), b)


def test_partitionable_semantics_enabled():
    assert bool(jax.config.jax_threefry_partitionable)


@pytest.mark.parametrize("num", [2, 3, 7])
def test_split(keys, num):
    kj, kt = keys
    _eq(jax.vmap(lambda k: jax.random.split(k, num))(kj), TF.split(kt, num))


def test_bits4(keys):
    kj, kt = keys
    ref = jax.vmap(lambda k: jax.random.bits(k, (4,), jnp.uint32))(kj)
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64),
                                  TF.bits(kt, 4).numpy())


def test_uniform(keys):
    kj, kt = keys
    _eq(jax.vmap(lambda k: jax.random.uniform(k, dtype=jnp.float32))(kj),
        TF.uniform(kt))


def test_uniform4_noise(keys):
    """The fused multiply-add of jax's uniform(lo, hi) on the CPU."""
    kj, kt = keys
    ref = jax.vmap(lambda k: jax.random.uniform(
        k, (4,), jnp.float32, -0.05, 0.05))(kj)
    _eq(ref, TF.uniform4(kt, -0.05, 0.05))


def test_randint4(keys):
    kj, kt = keys
    _eq(jax.vmap(lambda k: jax.random.randint(k, (4,), 0, 4, jnp.int32))(kj),
        TF.randint4(kt))


def test_bernoulli(keys):
    kj, kt = keys
    _eq(jax.vmap(lambda k: jax.random.bernoulli(k, jnp.float32(0.5)))(kj),
        TF.bernoulli(kt))


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 5, 2**40 + 3])
def test_prng_key_and_batch_split(seed):
    _eq(jax.random.split(jax.random.PRNGKey(seed), 9),
        TF.split(TF.prng_key(seed)[None], 9)[0])


def test_fma_f32_rounds_once():
    """fma_f32 against an exact rational reference on random f32 triples,
    including products that cancel the addend."""
    from fractions import Fraction
    rng = np.random.default_rng(7)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + 1e-7 * rng.standard_normal(
        2000))).astype(np.float32)
    got = TF.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.nextafter(g, np.float32(-np.inf))
        hi = np.nextafter(g, np.float32(np.inf))
        err = abs(Fraction(float(g)) - exact)
        assert err <= abs(Fraction(float(lo)) - exact)
        assert err <= abs(Fraction(float(hi)) - exact)
