"""Integer-only IEEE-f64 emulation (soft-float) for the integer-exact
engine, batched, in PyTorch.

The port of ``marl_sortingenv_tpu.core.softfloat``.  Executable spec:
``exact32_proto.py`` (a copy of the JAX package's pure-Python prototype).
Every op is integer arithmetic, so the card, the CPU and the JAX package
agree bit for bit whatever their float hardware does.

Domain contracts (kept by the callers):

* ``sf_div_int``: 0 <= a <= 2^20, 1 <= b <= 2^20
* values handled elsewhere lie in [2^-62, 4) or are exactly 0
* ``sf_cmp_le_u53``: u in [0, 2^53)

Representation: ``SFJ(m, e)`` with value = m * 2^e, m == 0 (zero) or m in
[2^52, 2^53); ``m`` is an ``int64`` tensor (a u64 held as its bit
pattern, as in ``core/rng.py``), ``e`` an ``int32`` tensor.  PyTorch has
no usable ``uint64`` (the CPU has no shift, add or compare for it), so
three things of u64 arithmetic need care here, and get it where a value
can reach 2^63: ``>>`` is logical only through ``R._srl`` /
``R._srl_var``, ``<`` is unsigned only through ``R._ult`` and ``//`` is
unsigned only through ``_udiv``.  Everything is elementwise over tensors
of any shape.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .rng import _SIGN, _srl, _srl_var, _ult

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64

MBITS = 52
MLOW = 1 << 52
MHIGH = 1 << 53
_M32 = 0xFFFFFFFF


class SFJ(NamedTuple):
    m: torch.Tensor  # u64 as int64: 0 or in [2^52, 2^53)
    e: torch.Tensor  # int32


def _i64(x, like=None) -> torch.Tensor:
    """``x`` as int64; a Python int becomes a filled 0-dim tensor on
    ``like``'s device (a fill, not a host-to-device copy, which would wait
    for the card)."""
    if isinstance(x, torch.Tensor):
        return x.to(I64)
    dev = like.device if like is not None else None
    return torch.full((), int(x), dtype=I64, device=dev)


def _ugt(a, b):
    return _ult(b, a)


def _uge(a, b):
    return ~_ult(a, b)


def _udiv(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Unsigned ``n // d`` for u64 bit patterns ``n`` (any) and
    0 < d < 2^63: halve ``n`` logically so that a signed floor division
    applies, then fix the one bit the halving dropped.  A zero divisor
    (a lane outside the domain, whose result is discarded) divides by 1
    instead of raising, as XLA's integer division does not raise."""
    d = d.clamp(min=1)
    q = ((_srl(n, 1)) // d) << 1
    r = n - q * d                      # in [0, 2d) < 2^64
    return q + _uge(r, d).to(I64)


def sf_zero(device=None) -> SFJ:
    return SFJ(torch.zeros((), dtype=I64, device=device),
               torch.zeros((), dtype=I32, device=device))


def sf_one(device=None) -> SFJ:
    return SFJ(torch.full((), MLOW, dtype=I64, device=device),
               torch.full((), -52, dtype=I32, device=device))


def _bitlen(x: torch.Tensor) -> torch.Tensor:
    """Bit length of u64 (0 for x == 0), int32, for any bit pattern: the
    binary exponent of each 32-bit half, which converts to f64 exactly
    (``frexp`` reads it from the bits; a dozen ops where the JAX package's
    6-step binary search takes some 70)."""
    x = x.to(I64)
    hi = _srl(x, 32)
    e_hi = torch.frexp(hi.to(F64)).exponent
    e_lo = torch.frexp((x & _M32).to(F64)).exponent
    return torch.where(hi != 0, e_hi + 32, e_lo).to(I32)


def _round_half_even(q, rem, den):
    """q (+ rem/den) rounded to nearest-even, overflow-safe (compares rem
    against den - rem instead of doubling rem); unsigned compares, since
    ``den`` reaches 2^63 and beyond."""
    other = den - rem
    up = _ugt(rem, other) | ((rem == other) & ((q & 1) == 1))
    return q + up.to(I64)


def _shl(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x << s`` for per-element shifts s >= 0, 0 from s = 64 on (XLA's
    shift; a C shift by 64 or more is undefined)."""
    return torch.where(s >= 64, 0, x << s.clamp(max=63))


def sf_div_int(a, b) -> SFJ:
    """Correctly-rounded f64 of a/b (small non-negative ints, b >= 1).

    One division with a post-normalization derived from the remainder:
    q0 = (a << p0) // b with p0 = 52 + bl(b) - bl(a) lands in
    [2^51, 2^53); below 2^52 one extra quotient bit comes from the doubled
    remainder."""
    a = _i64(a)
    # b == 0 only in lanes whose result is discarded (an empty env):
    # divide by 1 there rather than raise
    b = _i64(b, a).clamp(min=1)
    a, b = torch.broadcast_tensors(a, b)
    bl_a = _bitlen(torch.clamp(a, min=1))
    bl_b = _bitlen(b)
    p0 = (52 + bl_b - bl_a).to(I64)
    num = a << p0
    q0 = _udiv(num, b)
    rem0 = num - q0 * b
    small = q0 < MLOW
    bit = (2 * rem0) // b
    rem1 = 2 * rem0 - bit * b
    q = torch.where(small, 2 * q0 + bit, q0)
    rem = torch.where(small, rem1, rem0)
    p = torch.where(small, p0 + 1, p0)
    q = _round_half_even(q, rem, b)
    carry = q == MHIGH
    q = torch.where(carry, MLOW, q)
    e_out = (carry.to(I64) - p).to(I32)
    zero = a == 0
    return SFJ(torch.where(zero, 0, q), torch.where(zero, 0, e_out).to(I32))


def sf_add(x: SFJ, y: SFJ) -> SFJ:
    """Correctly-rounded f64 addition of non-negative values."""
    # order so that x >= y (zero sorts below everything)
    xkey = torch.where(x.m == 0, -(1 << 20), x.e.to(I64))
    ykey = torch.where(y.m == 0, -(1 << 20), y.e.to(I64))
    swap = (xkey < ykey) | ((xkey == ykey) & (x.m < y.m))
    xm = torch.where(swap, y.m, x.m)
    xe = torch.where(swap, y.e, x.e).to(I64)
    ym = torch.where(swap, x.m, y.m)
    ye = torch.where(swap, x.e, y.e).to(I64)

    # the exponent gap as the JAX package's u64: a negative gap (x zero,
    # y not) is huge, hence far
    d = xe - ye
    far = (d > MBITS + 2) | (d < 0)
    d_eff = torch.where(far, 0, d)

    X = xm << 2
    Yfull = ym << 2
    Y = Yfull >> d_eff
    sticky = (Yfull & ((torch.ones_like(d_eff) << d_eff) - 1)) != 0
    S = X + torch.where(far | (ym == 0), 0, Y)
    sticky = sticky & ~far & (ym != 0)
    e = xe
    over = S >= (MHIGH << 2)
    sticky = sticky | (over & ((S & 1) != 0))
    S = torch.where(over, S >> 1, S)
    e = torch.where(over, e + 1, e)
    q = S >> 2
    g = S & 3
    up = (g > 2) | ((g == 2) & sticky) | ((g == 2) & ~sticky & ((q & 1) == 1))
    q = q + up.to(I64)
    carry = q == MHIGH
    q = torch.where(carry, MLOW, q)
    e = torch.where(carry, e + 1, e)
    x_zero = xm == 0
    return SFJ(torch.where(x_zero, 0, q), torch.where(x_zero, 0, e).to(I32))


def sf_sub_from_one(y: SFJ) -> SFJ:
    """Correctly-rounded f64 of 1 - value(y), y in [0, 1], value >= 2^-62."""
    d = (-y.e).to(I64)   # one = 2^d in units of 2^{y.e}; d in [52, 62]
    one = _shl(torch.ones_like(d), d)
    diff = one - y.m      # exact, < 2^63
    bl = _bitlen(diff).to(I64)
    drop = (bl - 53).clamp(min=0)
    q = _srl_var(diff, drop)
    rem = diff - (q << drop)
    den = torch.ones_like(drop) << drop
    q = _round_half_even(q, rem, den)
    carry = q == MHIGH
    q = torch.where(carry, q >> 1, q)
    e = y.e.to(I64) + drop + carry.to(I64)
    # upshift if diff had fewer than 53 bits
    up = (53 - bl).clamp(min=0)
    q = q << torch.where(drop > 0, 0, up)
    e = e - torch.where(drop > 0, 0, up)
    is_zero = diff == 0
    y_zero = y.m == 0
    m_out = torch.where(is_zero, 0, torch.where(y_zero, MLOW, q))
    e_out = torch.where(is_zero, 0, torch.where(y_zero, -52, e))
    return SFJ(m_out, e_out.to(I32))


def _div128by64(hi, lo, d):
    """(hi*2^64 + lo) // d and remainder, for hi < d and d in [2^63, 2^64)
    (u64 bit patterns, so ``d`` is negative as int64).

    Hacker's Delight ``divlu`` (Knuth D) with 32-bit digits.  Each
    correction loop needs at most two rounds (Knuth D), so it runs exactly
    two masked rounds: the JAX package's ``while_loop`` with the same bits
    and no device-to-host test."""
    B = 1 << 32
    dh = _srl(d, 32)                 # in [2^31, 2^32)
    dl = d & _M32
    un1 = _srl(lo, 32)
    un0 = lo & _M32
    b_t = torch.full_like(d, B)

    def fix(q, r, u_low):
        done = torch.zeros(q.shape, dtype=torch.bool, device=q.device)
        for _ in range(2):
            bad = ~done & _ult(r, b_t) & (
                _uge(q, b_t) | _ugt(q * dl, (r << 32) + u_low))
            q = torch.where(bad, q - 1, q)
            r = torch.where(bad, r + dh, r)
            done = done | _uge(r, b_t)
        return q, r

    q1 = torch.minimum(_udiv(hi, dh), b_t - 1)
    r1 = hi - q1 * dh
    q1, r1 = fix(q1, r1, un1)
    un21 = (hi << 32) + un1 - q1 * d   # exact mod 2^64
    q0 = torch.minimum(_udiv(un21, dh), b_t - 1)
    r0 = un21 - q0 * dh
    q0, r0 = fix(q0, r0, un0)
    r = (un21 << 32) + un0 - q0 * d    # exact mod 2^64
    q = (q1 << 32) | q0
    return q, r


def sf_div(x: SFJ, y: SFJ) -> SFJ:
    """Correctly-rounded f64 division x/y (positive, y normalized)."""
    # normalize the divisor to [2^63, 2^64) with shift 11 and scale the
    # dividend alike: x.m * 2^53 * 2^11 = x.m * 2^64 => (hi, lo) = (x.m, 0)
    xm, ym = torch.broadcast_tensors(x.m, y.m)
    hi = xm
    lo = torch.zeros_like(xm)
    d = ym << 11
    q, r = _div128by64(hi, lo, d)
    # q in [2^52, 2^54): normalize
    e = x.e.to(I64) - y.e.to(I64) - 53
    big = q >= MHIGH
    bit = q & 1
    q_half = q >> 1
    # halved value's fraction is (bit*d + r)/(2d): up iff bit & (r>0 or odd)
    up_big = (bit == 1) & ((r != 0) | ((q_half & 1) == 1))
    q_big = q_half + up_big.to(I64)
    q_small = _round_half_even(q, r, d)
    q = torch.where(big, q_big, q_small)
    e = torch.where(big, e + 1, e)
    carry = q == MHIGH
    q = torch.where(carry, MLOW, q)
    e = torch.where(carry, e + 1, e)
    zero = xm == 0
    return SFJ(torch.where(zero, 0, q), torch.where(zero, 0, e).to(I32))


def sf_cmp_le_u53(x: SFJ, u) -> torch.Tensor:
    """Exact value(x) <= u * 2^-53 for u in [0, 2^53); x in domain."""
    u = _i64(u, x.m)
    s = x.e.to(I64) + 53
    pos = s >= 0
    lhs = x.m << torch.where(pos, s, 0)
    rhs_shift = torch.where(pos, 0, -s)
    # for x >= 2^-62, -s <= 9'ish; a larger shift means x lies far below
    # u's resolution: compare by saturation
    big_shift = rhs_shift > 10
    rhs = u << torch.where(big_shift, 10, rhs_shift)
    cmp = torch.where(pos, lhs <= u, x.m <= rhs)
    cmp = torch.where(big_shift, u > 0, cmp)
    return torch.where(x.m == 0, True, cmp)


def _f64_round_times100(m: torch.Tensor, e: torch.Tensor):
    """The f64-rounded product value(m, e) * 100 as (pm, e'), pm a 53-bit
    mantissa (both roundings of NumPy's ``x * 100``)."""
    p = m * 100
    bl = _bitlen(p).to(I64)
    shift = (bl - 53).clamp(min=0)
    pm = p >> shift
    rem = p - (pm << shift)
    pm = _round_half_even(pm, rem, torch.ones_like(shift) << shift)
    ovf = pm == MHIGH
    pm = torch.where(ovf, pm >> 1, pm)
    shift = shift + ovf.to(I64)
    return pm, e.to(I64) + shift


def sf_cents(x: SFJ) -> torch.Tensor:
    """int(rint(f64(value*100))): both roundings (np_round2's numerator),
    int64."""
    pm, e = _f64_round_times100(x.m, x.e)
    neg = e < 0
    s2c = torch.where(neg, -e, 0).clamp(max=63)
    q = pm >> s2c
    rem = pm - (q << s2c)
    q = _round_half_even(q, rem, torch.ones_like(s2c) << s2c)
    q = torch.where(neg, q, pm << torch.where(neg, 0, e.clamp(min=0)))
    return torch.where(x.m == 0, 0, q)


def sf_to_f32_parts(x: SFJ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mant24, exp) with f32 value = mant24 * 2^exp (mant24 in
    [2^23, 2^24]); int64, int32."""
    drop = 53 - 24
    q = x.m >> drop
    rem = x.m - (q << drop)
    q = _round_half_even(q, rem, torch.full_like(q, 1 << drop))
    carry = q == (1 << 24)
    q = torch.where(carry, 1 << 23, q)
    e = x.e + 29 + carry.to(I32)
    return q, e.to(I32)


def _pow2_f64(e: torch.Tensor) -> torch.Tensor:
    """2^e as f64 built from its IEEE bits (normal range), exact on every
    device."""
    return ((e.to(I64) + 1023) << 52).view(F64)


def sf_to_f32(x: SFJ) -> torch.Tensor:
    """f32(correctly-rounded-f64 value): exactly NumPy's f64->f32 cast.
    Built from integer parts: the f64 product of the 24-bit mantissa and
    an exact power of two is exact, and so is its cast."""
    q, e = sf_to_f32_parts(x)
    val = (q.to(F64) * _pow2_f64(e)).to(F32)
    return torch.where(x.m == 0, torch.zeros((), dtype=F32,
                                             device=val.device), val)


# ---------------------------------------------------------------------------
# Signed layer: SFS = (sign, magnitude) for exact reward arithmetic.
# ---------------------------------------------------------------------------

class SFS(NamedTuple):
    s: torch.Tensor  # int32 in {-1, 0, +1} (0 iff the magnitude is zero)
    m: torch.Tensor  # u64 as int64, as SFJ
    e: torch.Tensor  # int32, as SFJ


def sfs_zero(device=None) -> SFS:
    return SFS(torch.zeros((), dtype=I32, device=device),
               torch.zeros((), dtype=I64, device=device),
               torch.zeros((), dtype=I32, device=device))


def sfs_from_parts(s, m, e, device=None) -> SFS:
    return SFS(torch.as_tensor(s, dtype=I32, device=device),
               torch.as_tensor(m, dtype=I64, device=device),
               torch.as_tensor(e, dtype=I32, device=device))


def sfs_of(x: SFJ, sign=1) -> SFS:
    s = torch.where(x.m == 0, 0, sign).to(I32)
    return SFS(s, x.m, x.e)


def sfs_where(c, a: SFS, b: SFS) -> SFS:
    return SFS(torch.where(c, a.s, b.s), torch.where(c, a.m, b.m),
               torch.where(c, a.e, b.e))


def _mag_gt(xm, xe, ym, ye):
    """value(x) > value(y) for normalized magnitudes."""
    return (xe > ye) | ((xe == ye) & (xm > ym))


def _sub_mag(xm, xe, ym, ye) -> SFJ:
    """Correctly-rounded x - y for magnitudes with value(x) > value(y) > 0.

    Three guard bits; the dropped fraction of y becomes a borrow plus a
    sticky remainder."""
    xe = xe.to(I64)
    d = xe - ye.to(I64)
    far = (d > 55) | (d < 0)
    d_eff = torch.where(far, 0, d)
    X3 = xm << 3
    Y3full = ym << 3
    Y3 = torch.where(far, 0, Y3full >> d_eff)
    f_nz = torch.where(
        far, True, (Y3full & ((torch.ones_like(d_eff) << d_eff) - 1)) != 0)
    S = X3 - Y3 - f_nz.to(I64)
    sticky = f_nz

    bl = _bitlen(S).to(I64)
    drop = (bl - 53).clamp(min=0)
    one = torch.ones_like(drop)
    q = S >> drop
    rem = S & ((one << drop) - 1)
    half = torch.where(drop > 0, one << (drop - 1).clamp(min=0), 0)
    tie = (drop > 0) & (rem == half)
    up = (rem > half) | (tie & (sticky | ((q & 1) == 1)))
    q = q + up.to(I64)
    carry = q == MHIGH
    q = torch.where(carry, MLOW, q)
    e = xe - 3 + drop + carry.to(I64)
    # fewer than 53 bits: exact upshift (sticky is provably 0 here)
    upshift = (53 - bl).clamp(min=0)
    low = drop == 0
    q = torch.where(low, S << upshift, q)
    e = torch.where(low, xe - 3 - upshift, e)
    zero = S == 0
    return SFJ(torch.where(zero, 0, q), torch.where(zero, 0, e).to(I32))


def sfs_add(x: SFS, y: SFS) -> SFS:
    """Correctly-rounded f64 signed addition."""
    x_zero = x.s == 0
    y_zero = y.s == 0

    same = x.s == y.s
    mag_sum = sf_add(SFJ(x.m, x.e), SFJ(y.m, y.e))

    x_big = _mag_gt(x.m, x.e, y.m, y.e)
    y_big = _mag_gt(y.m, y.e, x.m, x.e)
    bm = torch.where(x_big, x.m, y.m)
    be = torch.where(x_big, x.e, y.e)
    sm = torch.where(x_big, y.m, x.m)
    se = torch.where(x_big, y.e, x.e)
    mag_diff = _sub_mag(bm, be, sm, se)
    diff_sign = torch.where(x_big, x.s, torch.where(y_big, y.s, 0))
    # equal magnitudes, opposite signs -> exactly +0
    eq = ~x_big & ~y_big
    dm = torch.where(eq, 0, mag_diff.m)
    de = torch.where(eq, 0, mag_diff.e)

    s = torch.where(same, x.s, diff_sign)
    m = torch.where(same, mag_sum.m, dm)
    e = torch.where(same, mag_sum.e, de)
    s = torch.where(m == 0, 0, s)

    s = torch.where(x_zero, y.s, torch.where(y_zero, x.s, s))
    m = torch.where(x_zero, y.m, torch.where(y_zero, x.m, m))
    e = torch.where(x_zero, y.e, torch.where(y_zero, x.e, e))
    return SFS(s.to(I32), m, e.to(I32))


def sfs_clip1(x: SFS) -> SFS:
    """clip(value, -1, 1), exact (|v| > 1 iff (e, m) > (-52, 2^52))."""
    over = (x.e > -52) | ((x.e == -52) & (x.m > MLOW))
    return SFS(x.s, torch.where(over, MLOW, x.m),
               torch.where(over, -52, x.e).to(I32))


def sfs_to_bits(x: SFS) -> torch.Tensor:
    """IEEE-754 f64 bit pattern as int64 (domain: normals and +0)."""
    biased = (x.e.to(I64) + 52 + 1023)
    bits = (biased << 52) | (x.m - MLOW)
    bits = bits | torch.where(x.s < 0, _SIGN, 0)
    return torch.where(x.s == 0, 0, bits)


def sfs_to_f64(x: SFS) -> torch.Tensor:
    """The value as f64 by exact integer reconstruction (the product of
    a 53-bit mantissa and an exact power of two)."""
    mag = x.m.to(F64) * _pow2_f64(x.e)
    return torch.where(x.s < 0, -mag, mag)


# ---------------------------------------------------------------------------
# noise > 0 extension: a general multiply through a 128-bit product of
# 32-bit limbs, exact int / next_double injection, Python round to int,
# and IEEE-bit pack/unpack so that exact f64 values live in int64 state.
# ---------------------------------------------------------------------------

def _mul128(a, b):
    """Full 128-bit product of two u64 as (hi, lo) via 32-bit limbs; the
    carries are unsigned compares."""
    ah, al = _srl(a, 32), a & _M32
    bh, bl = _srl(b, 32), b & _M32
    lo = al * bl
    m1 = ah * bl
    m2 = al * bh
    hi = ah * bh
    lo1 = lo + (m1 << 32)
    c1 = _ult(lo1, lo).to(I64)
    lo2 = lo1 + (m2 << 32)
    c2 = _ult(lo2, lo1).to(I64)
    hi = hi + _srl(m1, 32) + _srl(m2, 32) + c1 + c2
    return hi, lo2


def sf_mul(x: SFJ, y: SFJ) -> SFJ:
    """Correctly-rounded f64 multiply (non-negative normalized operands).

    p = x.m * y.m lies in [2^104, 2^106), so hi = p >> 64 is in
    [2^40, 2^42) and the normalization shift is 52 or 53."""
    hi, lo = _mul128(x.m, y.m)
    shift = (_bitlen(hi) + 64 - 53).to(I64)
    q = (hi << (64 - shift)) | _srl_var(lo, shift)
    one = torch.ones_like(shift)
    rem = lo & ((one << shift) - 1)
    q = _round_half_even(q, rem, one << shift)
    carry = q == MHIGH
    q = torch.where(carry, MLOW, q)
    e = x.e.to(I64) + y.e.to(I64) + shift + carry.to(I64)
    zero = (x.m == 0) | (y.m == 0)
    return SFJ(torch.where(zero, 0, q), torch.where(zero, 0, e).to(I32))


def sf_from_int(t) -> SFJ:
    """Exact SFJ of a non-negative integer < 2^53."""
    t = _i64(t)
    sh = (53 - _bitlen(t)).clamp(0, 63).to(I64)
    zero = t == 0
    return SFJ(torch.where(zero, 0, t << sh),
               torch.where(zero, 0, -sh).to(I32))


def sf_from_u53(u) -> SFJ:
    """Exact SFJ of u * 2^-53 for u in [0, 2^53) (``next_double``)."""
    x = sf_from_int(u)
    return SFJ(x.m, torch.where(x.m == 0, 0, x.e - 53).to(I32))


def sf_round_int(x: SFJ) -> torch.Tensor:
    """Python ``round(value(x))`` -> int64: half-to-even on the f64 value
    (non-negative, value < 2^53).  s >= 54 means value < 1/2 -> 0, which
    the clamped shift also produces."""
    e = x.e.to(I64)
    pos = e >= 0
    s = torch.clamp(-e, 0, 54)
    q = x.m >> s
    one = torch.ones_like(s)
    rem = x.m & ((one << s) - 1)
    q = _round_half_even(q, rem, one << s)
    q = torch.where(pos, x.m << torch.clamp(e, 0, 10), q)
    return torch.where(x.m == 0, 0, q)


def sf_to_bits(x: SFJ) -> torch.Tensor:
    """IEEE-754 f64 bit pattern (int64) of the non-negative value: normals
    and +0 only."""
    biased = x.e.to(I64) + 52 + 1023
    bits = (biased << 52) | (x.m - MLOW)
    return torch.where(x.m == 0, 0, bits)


def sf_from_bits(bits) -> SFJ:
    """Inverse of ``sf_to_bits`` (non-negative normals and zero)."""
    bits = _i64(bits)
    m = (bits & ((1 << 52) - 1)) | MLOW
    e = (_srl(bits, 52) - 1075).to(I32)
    zero = bits == 0
    return SFJ(torch.where(zero, 0, m), torch.where(zero, 0, e).to(I32))
