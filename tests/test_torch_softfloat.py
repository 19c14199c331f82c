"""The port's soft-float (marl_sortingenv_tpu_torch/core/softfloat.py)
against the JAX package's and against the pure-Python prototype
(``exact32_proto``, == IEEE f64), on the CPU, with no tolerance: every
``sf_*`` and ``sfs_*`` function on random operands from a numpy seed, in
and beyond the plant's domain (both packages wrap and shift alike there),
and on boundary cases: divisors 2^63 and 2^64 - 1, an ``un21`` at or above
2^63, mantissa carries to 2^53 and the signed adversarial pairs of
test_softfloat_signed.py.  The port's copy of the prototype is the JAX
package's file, byte for byte.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from marl_sortingenv_tpu.core import exact32_proto as JP
from marl_sortingenv_tpu.core import softfloat as J
from marl_sortingenv_tpu_torch.core import exact32_proto as P
from marl_sortingenv_tpu_torch.core import softfloat as T

torch.set_num_threads(1)

N = 20000
ROOT = Path(__file__).resolve().parents[1]


def tj(x):
    return jnp.asarray(np.asarray(x))


def tt(x):
    x = np.asarray(x)
    if x.dtype == np.uint64:
        x = x.view(np.int64)
    return torch.from_numpy(np.array(x, copy=True))


def same(want, got, what):
    """JAX's array against the port's tensor, bit for bit (u64 as its
    int64 pattern, f32/f64 as their bits)."""
    a, b = np.asarray(want), got.numpy()
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    if a.dtype in (np.float32, np.float64):
        a, b = a.view(f"i{a.itemsize}"), b.view(f"i{b.itemsize}")
    if a.dtype == np.bool_:
        b = b.astype(np.bool_)
    assert a.shape == b.shape, what
    bad = np.flatnonzero((a.astype(np.int64) != b.astype(np.int64)).ravel())
    assert bad.size == 0, f"{what}: {bad.size} differ, first at {bad[:5]}"


def rand_sf(rng, n, elo=-62, ehi=1, zeros=0.05):
    """Normalized soft-floats with values in [2^elo, 2^ehi), some zero."""
    m = rng.integers(1 << 52, 1 << 53, n, dtype=np.int64).astype(np.uint64)
    e = rng.integers(elo - 52, ehi - 52, n).astype(np.int32)
    z = rng.random(n) < zeros
    m[z], e[z] = 0, 0
    return m, e


def both(m, e):
    return J.SFJ(tj(m), tj(e)), T.SFJ(tt(m), tt(e))


def same_sf(want, got, what):
    same(want.m, got.m, what + ".m")
    same(want.e, got.e, what + ".e")


def test_prototype_is_a_copy():
    src = (ROOT / "marl_sortingenv_tpu" / "core" / "exact32_proto.py")
    dst = (ROOT / "marl_sortingenv_tpu_torch" / "core" / "exact32_proto.py")
    assert src.read_bytes() == dst.read_bytes()
    assert P.sf_div(P.sf_div_int(3, 7), P.sf_div_int(5, 11)) == \
        JP.sf_div(JP.sf_div_int(3, 7), JP.sf_div_int(5, 11))


@pytest.mark.parametrize("hi_a", [1 << 10, 1 << 20])
def test_div_int(hi_a):
    rng = np.random.default_rng(hi_a)
    a = rng.integers(0, hi_a + 1, N)
    b = rng.integers(1, hi_a + 1, N)
    same_sf(J.sf_div_int(tj(a.astype(np.uint64)), tj(b.astype(np.uint64))),
            T.sf_div_int(tt(a), tt(b)), "sf_div_int")
    # the domain against the prototype (== IEEE f64)
    got = T.sf_div_int(tt(a[:2000] % 701), tt(b[:2000] % 700 + 1))
    for i, (x, y) in enumerate(zip(a[:2000] % 701, b[:2000] % 700 + 1)):
        ref = P.sf_div_int(int(x), int(y))
        assert (int(got.m[i]), int(got.e[i]) if ref.m else 0) == (
            ref.m, ref.e if ref.m else 0), (x, y)


@pytest.mark.parametrize("fn", ["sf_add", "sf_div", "sf_mul"])
def test_binary_ops(fn):
    rng = np.random.default_rng(1)
    xm, xe = rand_sf(rng, N)
    ym, ye = rand_sf(rng, N)
    if fn == "sf_div":
        ym[ym == 0] = 1 << 52
    # mantissas at the top of their range push the results' carries
    xm[:500] = (1 << 53) - 1
    ym[:250] = (1 << 53) - 1
    xj, xt = both(xm, xe)
    yj, yt = both(ym, ye)
    same_sf(getattr(J, fn)(xj, yj), getattr(T, fn)(xt, yt), fn)
    # against the prototype on values in the plant's range
    got = getattr(T, fn)(xt, yt)
    for i in range(0, N, 97):
        if fn == "sf_div" and xm[i] == 0:
            continue
        ref = getattr(P, fn)(P.SF(int(xm[i]), int(xe[i])),
                             P.SF(int(ym[i]), int(ye[i])))
        assert (int(got.m[i]), int(got.e[i]) if ref.m else 0) == (
            ref.m, ref.e if ref.m else 0), (fn, i)


@pytest.mark.parametrize("elo", [-10, -62])
def test_sub_from_one_and_cents(elo):
    rng = np.random.default_rng(2)
    m, e = rand_sf(rng, N, elo, 0)
    m[:3], e[:3] = (1 << 52, (1 << 53) - 1, 1 << 52), (-52, -53, -53)
    xj, xt = both(m, e)
    same_sf(J.sf_sub_from_one(xj), T.sf_sub_from_one(xt), "sf_sub_from_one")
    same(J.sf_cents(xj), T.sf_cents(xt), "sf_cents")
    got = T.sf_cents(xt)
    for i in range(0, N, 101):
        assert int(got[i]) == P.sf_cents(P.SF(int(m[i]), int(e[i])))


def test_unary_and_conversions():
    rng = np.random.default_rng(3)
    m, e = rand_sf(rng, N)
    xj, xt = both(m, e)
    same(J.sf_to_f32(xj), T.sf_to_f32(xt), "sf_to_f32")
    for a, b in zip(J.sf_to_f32_parts(xj), T.sf_to_f32_parts(xt)):
        same(a, b, "sf_to_f32_parts")
    same(J.sf_round_int(xj), T.sf_round_int(xt), "sf_round_int")
    bits = J.sf_to_bits(xj)
    same(bits, T.sf_to_bits(xt), "sf_to_bits")
    same_sf(J.sf_from_bits(bits), T.sf_from_bits(tt(np.asarray(bits))),
            "sf_from_bits")
    u = rng.integers(0, 1 << 53, N).astype(np.uint64)
    u[:4] = (0, 1, (1 << 53) - 1, 1 << 52)
    same(J.sf_cmp_le_u53(xj, tj(u)), T.sf_cmp_le_u53(xt, tt(u)),
         "sf_cmp_le_u53")
    same_sf(J.sf_from_u53(tj(u)), T.sf_from_u53(tt(u)), "sf_from_u53")
    same_sf(J.sf_from_int(tj(u)), T.sf_from_int(tt(u)), "sf_from_int")
    for i in range(0, N, 211):
        x = P.SF(int(m[i]), int(e[i]))
        assert bool(T.sf_cmp_le_u53(T.SFJ(tt(m[i:i + 1]), tt(e[i:i + 1])),
                                    tt(u[i:i + 1]))[0]) == \
            P.sf_cmp_le_u53(x, int(u[i]))
        assert T.sf_to_f32(T.SFJ(tt(m[i:i + 1]), tt(e[i:i + 1])))[0].item() \
            == P.sf_to_f32(x)
        assert int(T.sf_round_int(T.SFJ(tt(m[i:i + 1]),
                                        tt(e[i:i + 1])))[0]) == \
            P.sf_round_int(x)


def test_div128_boundaries():
    """Divisors 2^63 and 2^64 - 1, dividends whose ``un21`` reaches 2^63
    and beyond, random operands: the quotient and remainder as Python's
    exact integers give them, and as JAX's."""
    rng = np.random.default_rng(4)
    d = [1 << 63, (1 << 64) - 1, (1 << 63) + 12345, (1 << 64) - (1 << 32)]
    hi = [(1 << 63) - 1, (1 << 64) - 2, 1 << 62, (1 << 64) - (1 << 32) - 1]
    lo = [(1 << 64) - 1, 0, 1 << 63, 12345678901234]
    dd = rng.integers(0, 1 << 63, N).astype(np.uint64) | np.uint64(1 << 63)
    hh = (rng.integers(0, 1 << 63, N).astype(np.uint64) * np.uint64(2)) % dd
    ll = rng.integers(0, 1 << 63, N).astype(np.uint64) * np.uint64(2) + \
        np.uint64(1)
    d = np.concatenate([np.asarray(d, np.uint64), dd])
    hi = np.concatenate([np.asarray(hi, np.uint64), hh])
    lo = np.concatenate([np.asarray(lo, np.uint64), ll])
    qj, rj = J._div128by64(tj(hi), tj(lo), tj(d))
    qt, rt = T._div128by64(tt(hi), tt(lo), tt(d))
    same(qj, qt, "q")
    same(rj, rt, "r")
    q, r = qt.numpy().view(np.uint64), rt.numpy().view(np.uint64)
    for i in list(range(4)) + list(range(4, N, 53)):
        num = (int(hi[i]) << 64) | int(lo[i])
        assert (int(q[i]), int(r[i])) == divmod(num, int(d[i])), i
    # un21 = (hi << 32) + un1 - q1 * d at or above 2^63 in some rows
    dh = d >> np.uint64(32)
    q1 = np.minimum(hi // dh, np.uint64((1 << 32) - 1))
    assert ((hi << np.uint64(32)) - q1 * d >= np.uint64(1 << 63)).any()


SIGNED = [
    (1.0, 1.0), (1.0, -1.0), (1.0, -0.5), (0.5, -1.0),
    (0.0, 0.0), (0.0, -0.25), (-0.25, 0.0),
    (1.0, -(1.0 - 2**-53)), (1.0 + 2**-52, -1.0),
    (1.0, 2**-60), (1.0, -2**-60), (-1.0, 2**-60),
    (1.0, 2**-53), (1.0, -2**-54), (1.0 + 2**-52, 2**-53),
    (1.5, 2**-53), (1.5, -2**-53),
    (1.0 - 2**-53, 2**-53), ((2 - 2**-52) * 2, (2 - 2**-52) * 2),
    (0.5, -0.2), (0.3333333333333333, -1.0), (-0.5, -0.5),
    (0.8957835778211, -0.12345678901234567),
]


def decompose(v):
    v = np.asarray(v, np.float64)
    s = np.where(v == 0, 0, np.where(v < 0, -1, 1)).astype(np.int32)
    m, e = np.frexp(np.abs(v))
    m53 = np.where(v == 0, 0, (m * (1 << 53))).astype(np.uint64)
    e = np.where(v == 0, 0, e - 53).astype(np.int32)
    return s, m53, e


def test_signed_add_clip_bits():
    rng = np.random.default_rng(5)
    a = np.asarray([p[0] for p in SIGNED] + [p[1] for p in SIGNED])
    b = np.asarray([p[1] for p in SIGNED] + [p[0] for p in SIGNED])
    n = N
    ea, eb = rng.integers(-62, 9, n), rng.integers(-62, 9, n)
    ra = np.ldexp(rng.random(n) + 1.0, ea) * rng.choice([-1.0, 1.0], n)
    rb = np.ldexp(rng.random(n) + 1.0, eb) * rng.choice([-1.0, 1.0], n)
    close = rng.random(n) < 0.3
    rb[close] = -ra[close] * (1.0 + rng.integers(-4, 5, n)[close] * 2.0**-52)
    a, b = np.concatenate([a, ra]), np.concatenate([b, rb])
    xa, xb = decompose(a), decompose(b)
    rj = J.sfs_add(J.SFS(*map(tj, xa)), J.SFS(*map(tj, xb)))
    rt = T.sfs_add(T.SFS(*map(tt, xa)), T.SFS(*map(tt, xb)))
    for f in ("s", "m", "e"):
        same(getattr(rj, f), getattr(rt, f), f"sfs_add.{f}")
    bits = T.sfs_to_bits(rt)
    same(J.sfs_to_bits(rj), bits, "sfs_to_bits")
    # == IEEE f64 on the CPU
    assert np.array_equal(bits.numpy().view(np.float64), a + b)
    same(J.sfs_to_f64(rj), T.sfs_to_f64(rt), "sfs_to_f64")
    cj, ct = J.sfs_clip1(rj), T.sfs_clip1(rt)
    for f in ("s", "m", "e"):
        same(getattr(cj, f), getattr(ct, f), f"sfs_clip1.{f}")
    assert np.array_equal(T.sfs_to_bits(ct).numpy().view(np.float64),
                          np.clip(a + b, -1.0, 1.0))


def test_signed_helpers():
    x = T.sf_div_int(torch.tensor([0, 3, 5]), torch.tensor([1, 7, 5]))
    s = T.sfs_of(x, -1)
    assert s.s.tolist() == [0, -1, -1]
    assert T.sfs_to_bits(s).numpy().view(np.float64).tolist() == [
        0.0, -3 / 7, -1.0]
    z = T.sfs_zero()
    assert int(T.sfs_to_bits(T.sfs_add(z, s))[1]) == int(
        T.sfs_to_bits(s)[1])
    w = T.sfs_where(torch.tensor([True, False, True]), s,
                    T.sfs_from_parts(1, 1 << 52, -53))
    assert T.sfs_to_f64(w).tolist() == [0.0, 0.5, -1.0]
    assert T.sf_zero().m.item() == 0 and T.sf_one().m.item() == 1 << 52
