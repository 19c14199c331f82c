"""NumPy prototype of the exact32 software-float core (docs/EXACT32_DESIGN.md).

Validates — against real IEEE f64 over the *entire reachable domain* —
that the three primitives needed for TPU-exact `choice(p=...)` can be
computed with pure integer arithmetic:

1. ``sf_div_int(a, b)``     : correctly-rounded f64 of a/b (small ints)
2. ``sf_add(x, y)``         : correctly-rounded f64 addition
3. ``sf_div(x, y)``         : correctly-rounded f64 division (sf / sf)
4. ``sf_cmp_le_u53(x, u)``  : exact  x <= u * 2**-53  (u a 53-bit int)

A soft-float value is (m, e): value = m * 2^e with m in [2^52, 2^53)
(or m == 0 for zero).  The reachable domain for the redistribution cdf is
ratios of integers <= 700 and their 4-term cumulative sums, all within
[2^-10, 1]; the implementation is written for the wider [2^-60, 2^2]
envelope.

This prototype is the executable specification for the JAX/TPU port
(u64 ops only, no f64); the port replaces Python ints with u64 lanes and
the while-normalization with masked loops.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple


class SF(NamedTuple):
    m: int  # mantissa, 0 or in [2^52, 2^53)
    e: int  # exponent: value = m * 2^e


MBITS = 52
MLOW = 1 << 52
MHIGH = 1 << 53


def sf_zero() -> SF:
    return SF(0, 0)


def sf_from_float(x: float) -> SF:
    import math

    if x == 0.0:
        return sf_zero()
    man, exp = math.frexp(x)  # man in [0.5, 1)
    m = int(man * (1 << 53))
    return SF(m, exp - 53)


def sf_to_float(x: SF) -> float:
    import math

    if x.m == 0:
        return 0.0
    return math.ldexp(x.m, x.e)


def _round_half_even(q: int, rem2: int, den: int) -> int:
    """Round q (+ rem/den in [0,1)) to nearest-even; rem2 = 2*rem."""
    if rem2 > den or (rem2 == den and (q & 1)):
        return q + 1
    return q


def sf_div_int(a: int, b: int) -> SF:
    """Correctly-rounded f64 of a/b for 0 <= a, b small ints, b > 0."""
    if a == 0:
        return sf_zero()
    m = a
    e = 0
    while m < b:          # scale into [b, 2b)
        m <<= 1
        e -= 1
    while m >= 2 * b:     # a may exceed b (ratios > 1 not used, but safe)
        # keep m in [b, 2b)
        e += 1
        # defer the halving into the exponent by scaling b instead
        b <<= 1
    num = m << MBITS
    q = num // b
    rem = num - q * b
    q = _round_half_even(q, 2 * rem, b)
    if q == MHIGH:
        q = MLOW
        e += 1
    return SF(q, e - MBITS)


def sf_add(x: SF, y: SF) -> SF:
    """Correctly-rounded f64 addition (positive operands)."""
    if x.m == 0:
        return y
    if y.m == 0:
        return x
    if x.e < y.e or (x.e == y.e and x.m < y.m):
        x, y = y, x
    d = x.e - y.e
    if d > MBITS + 2:
        # y entirely below the rounding horizon: result is x unless the
        # sticky pushes a tie — with y > 0 and d > 54, y < ulp(x)/4
        return x
    # work with 2 guard bits + sticky
    X = x.m << 2
    if d == 0:
        Y = y.m << 2
        sticky = 0
    else:
        Y = (y.m << 2) >> d
        sticky = int((y.m << 2) & ((1 << d) - 1) != 0)
    S = X + Y
    e = x.e
    if S >= (MHIGH << 2):
        sticky |= S & 1
        S >>= 1
        e += 1
    # round on the 2 guard bits + sticky
    q = S >> 2
    # half = guard bits == 0b10 with sticky 0 -> tie
    g = S & 3
    if g > 2 or (g == 2 and sticky):
        q += 1
    elif g == 2 and not sticky and (q & 1):
        q += 1
    if q == MHIGH:
        q = MLOW
        e += 1
    return SF(q, e)


def sf_div(x: SF, y: SF) -> SF:
    """Correctly-rounded f64 division x / y (positive)."""
    if x.m == 0:
        return sf_zero()
    num = x.m << (MBITS + 1)  # 106-bit numerator (Python int; u64x2 on TPU)
    q = num // y.m
    rem = num - q * y.m
    e = x.e - y.e - (MBITS + 1)
    # q in [2^52, 2^54); normalize to [2^52, 2^53)
    if q >= MHIGH:
        # halve: value = (q//2 + ((q&1)*y.m + rem)/(2*y.m)) * 2^(e+1)
        r2 = (q & 1) * y.m + rem
        q >>= 1
        e += 1
        q = _round_half_even(q, 2 * r2, 2 * y.m)
    else:
        q = _round_half_even(q, 2 * rem, y.m)
    if q == MHIGH:
        q = MLOW
        e += 1
    return SF(q, e)


def sf_cmp_le_u53(x: SF, u: int) -> bool:
    """Exact  value(x) <= u * 2**-53  for u in [0, 2^53).

    (The TPU port bounds the shifts by the domain — cdf entries are 0 or
    >= 1/700 — so both sides stay within u64.)"""
    if x.m == 0:
        return True
    s = x.e + 53  # compare m * 2^(e+53) <= u
    if s >= 0:
        return (x.m << s) <= u
    return x.m <= (u << -s)


def round_half_even_mul(t: int, num: int, den: int) -> int:
    """Integer ``int(round(t * num/den))`` with banker's rounding — the
    noise=0 sorting split (acc = 0.75 => num/den = 3/4) without floats
    (reference env_super.py:539; exact because t*acc is an exact multiple
    of 1/den in f64 for small t)."""
    p = t * num
    q, r = divmod(p, den)
    r2 = 2 * r
    if r2 > den or (r2 == den and (q & 1)):
        return q + 1
    return q


def sf_sub_from_one(y: "SF") -> "SF":
    """Correctly-rounded f64 of 1.0 - value(y), for y in (0, 1]."""
    if y.m == 0:
        return SF(MLOW, -52 + 0)  # 1.0 = 2^52 * 2^-52
    # 1.0 = 2^-e_y-aligned integer minus m_y, then normalize + round
    # work in units of 2^(y.e): one = 2^-y.e
    d = -y.e  # >= 52 for y <= 1
    if d > 110:
        return SF(MLOW, -52)  # 1 - tiny rounds to 1 for d > 54; guard wide
    one = 1 << d
    diff = one - y.m  # exact integer, value = diff * 2^(y.e)
    if diff == 0:
        return sf_zero()
    # normalize diff to [2^52, 2^53) with round-half-even on dropped bits
    e = y.e
    while diff >= MHIGH:
        # need rounding of dropped bits
        drop = 0
        sticky = 0
        while diff >= MHIGH:
            sticky |= diff & 1
            if drop == 0:
                guard = diff & 1
            # collect guard progressively: simpler exact path below
            diff >>= 1
            e += 1
            drop += 1
        # redo exactly: recompute with remainder
        one = 1 << d
        diff_full = one - y.m
        rem = diff_full - (diff << drop)
        den = 1 << drop
        diff = _round_half_even(diff, 2 * rem, den)
        if diff == MHIGH:
            diff >>= 1
            e += 1
        break
    while diff < MLOW:
        diff <<= 1
        e -= 1
    return SF(diff, e)


def sf_cents(x: "SF") -> int:
    """``int(rint(f64(value(x) * 100)))`` — np_round2's numerator.

    NumPy first rounds the f64 *product* x*100 (so e.g. f64(1/40)*100
    rounds to exactly 2.5 although the exact product is above it), then
    rint half-even.  Reproduce both roundings."""
    if x.m == 0:
        return 0
    # 1) f64-round the product m*100 (59-bit) to a 53-bit mantissa
    p = x.m * 100
    shift = p.bit_length() - 53
    pm = p >> shift
    rem = p - (pm << shift)
    pm = _round_half_even(pm, 2 * rem, 1 << shift)
    if pm == MHIGH:
        pm >>= 1
        shift += 1
    e = x.e + shift  # product = pm * 2^e
    # 2) rint half-even to an integer
    if e >= 0:
        return pm << e
    s2 = -e
    q = pm >> s2
    rem = pm - (q << s2)
    return _round_half_even(q, 2 * rem, 1 << s2)


def sf_to_f32(x: "SF") -> float:
    """f32(value(x)): round the 53-bit mantissa to 24 bits half-even —
    identical to numpy's f64->f32 cast of the correctly-rounded f64."""
    import math

    if x.m == 0:
        return 0.0
    drop = 53 - 24
    q = x.m >> drop
    rem = x.m - (q << drop)
    den = 1 << drop
    q = _round_half_even(q, 2 * rem, den)
    if q == 1 << 24:
        q = 1 << 23
        return math.ldexp(q, x.e + drop + 1)
    return math.ldexp(q, x.e + drop)


# ---------------------------------------------------------------------------
# noise > 0 extension: general multiply, exact next_double, Python round.
# Needed for the reference's accuracy-noise path (env_super.py:492-509:
# ``uniform(-noise, +noise, 4)`` and ``int(round(target * acc))`` with
# arbitrary f64 accuracies).
# ---------------------------------------------------------------------------


def sf_mul(x: SF, y: SF) -> SF:
    """Correctly-rounded f64 multiply (non-negative operands)."""
    if x.m == 0 or y.m == 0:
        return sf_zero()
    p = x.m * y.m  # in [2^104, 2^106)
    shift = p.bit_length() - 53  # 52 or 53
    q = p >> shift
    rem = p - (q << shift)
    q = _round_half_even(q, 2 * rem, 1 << shift)
    e = x.e + y.e + shift
    if q == MHIGH:
        q = MLOW
        e += 1
    return SF(q, e)


def sf_from_int(t: int) -> SF:
    """Exact SF of a non-negative integer < 2^53."""
    if t == 0:
        return sf_zero()
    sh = 53 - t.bit_length()
    return SF(t << sh, -sh)


def sf_from_u53(u: int) -> SF:
    """Exact SF of u * 2^-53 for u in [0, 2^53) — ``next_double``'s value
    ((raw >> 11) * 2^-53, numpy/random/src distributions)."""
    if u == 0:
        return sf_zero()
    sh = 53 - u.bit_length()
    return SF(u << sh, -sh - 53)


def sf_round_int(x: SF) -> int:
    """Python ``round(value(x))`` -> int: half-to-even on the f64 value
    (non-negative; the sorting split's outer round, env_super.py:539)."""
    if x.m == 0:
        return 0
    if x.e >= 0:
        return x.m << x.e
    s = -x.e
    if s > 54:
        return 0  # value < 2^-1: rounds to 0 (tie at 1/2 -> even 0 too)
    q = x.m >> s
    rem = x.m - (q << s)
    return _round_half_even(q, 2 * rem, 1 << s)
