"""Bit-exact NumPy ``Generator``/PCG64 random streams, batched, in PyTorch.

The port of ``marl_sortingenv_tpu.core.rng``: the PCG64 (XSL-RR 128/64)
bit generator with NumPy's buffered ``next_uint32`` (low half first, high
half cached), ``Generator.integers`` (Lemire rejection), ``random()`` /
``uniform``, ``random_interval`` (mask rejection; behind ``shuffle``) and
``choice(n, p=...)``.  Seeding (``SeedSequence``) runs on the host through
NumPy itself (:func:`pcg64_init`).

Every function takes a batch of streams: each leaf of ``PCG64State`` has
the env batch ``N`` on its first axis, where the JAX package ``vmap``\\ s a
per-stream function.  An env that skips a draw keeps its state (a
``where``), so each env consumes exactly the draws NumPy would.

PyTorch has no usable ``uint64``, so a u64 lives in an ``int64`` tensor as
its bit pattern.  ``*``, ``+``, ``^``, ``&`` and ``<<`` give the right bits
mod 2**64; three things do not carry over and have helpers here: ``>>`` is
arithmetic (``_srl`` masks after the shift, ``_srl_var`` for a shift held
in a tensor), ``<`` is signed (``_ult`` flips the sign bits first) and no
shift may reach 64.  u32 values live in ``int64`` tensors in [0, 2**32).

A rejection loop runs until no env of the batch redraws; each test of
that is one device-to-host read, counted in ``HOST_SYNCS``.  Where a
rejection cannot happen (a range of a power of two) no test is made.
Draws whose number per env is known in advance, or bounded, are taken in
one block by PCG64's jump-ahead (``_jump``): state k of a stream is
``A_k * state + B_k * inc`` mod 2**128 with host-built ``A_k = a**k`` and
``B_k = a**(k-1) + ... + 1``, so the K states come from a few tensor ops
instead of K sequential steps.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..utils import profiling

I64 = torch.int64
F64 = torch.float64

M32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1
_SIGN = -(1 << 63)

# PCG 128-bit LCG default multiplier
_PCG_MULT = (2549297995355413924 << 64) | 4865540595714422341
_PCG_MULT_HI = 2549297995355413924
_PCG_MULT_LO = 4865540595714422341

_D_2POW53_INV = 1.0 / 9007199254740992.0  # 2**-53

# device-to-host reads made by the rejection loops (see module docstring)
HOST_SYNCS = 0


@profiling.spanned("rng.host_read")
def host_any(x: torch.Tensor) -> bool:
    """``bool(x.any())``: one device-to-host read, counted."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return bool(x.any())


@profiling.spanned("rng.host_read")
def host_ints(x: torch.Tensor) -> list:
    """The values of a 1-D int tensor, in one counted read."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return x.tolist()


@profiling.spanned("rng.host_read")
def host_array(x: torch.Tensor) -> np.ndarray:
    """``x`` as a numpy array on the host, in one counted read."""
    global HOST_SYNCS
    HOST_SYNCS += 1
    return x.cpu().numpy()


def _signed(v: int) -> int:
    """A u64 held in Python as the int64 with its bit pattern."""
    v &= _MASK64
    return v - (1 << 64) if v >= 1 << 63 else v


def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of u64 bit patterns by a constant 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _srl_var(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Logical right shift by per-element amounts ``r`` in [0, 63]: the
    arithmetic shift, then the top ``r`` bits cleared."""
    top = torch.full_like(x, _SIGN) >> r
    return (x >> r) & ~(top << 1)


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned ``a < b`` of u64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


class PCG64State(NamedTuple):
    """A batch of PCG64 streams (NumPy-compatible), each leaf ``[N]``.

    ``has_uint32``/``uinteger`` mirror NumPy's buffered 32-bit draw (the
    cache survives intervening 64-bit draws).  ``fence`` is always 0: the
    JAX package routes some products through it to keep XLA from fusing
    them; eager PyTorch rounds every op on its own, so the port only keeps
    the leaf so that states zip leaf for leaf."""

    state_hi: torch.Tensor  # u64 as int64
    state_lo: torch.Tensor  # u64 as int64
    inc_hi: torch.Tensor    # u64 as int64
    inc_lo: torch.Tensor    # u64 as int64
    has_uint32: torch.Tensor  # bool
    uinteger: torch.Tensor    # u32 as int64
    fence: torch.Tensor       # int64, always 0


def pcg64_init(seed, device="cuda") -> PCG64State:
    """Host-side seeding, identical to ``np.random.default_rng(seed)``
    for each seed of ``seed`` (a scalar or a 1-D array of seeds)."""
    device = resolve_device(device)
    flat = np.asarray(seed).reshape(-1)
    rows = []
    for s in flat:
        st = np.random.PCG64(int(s)).state["state"]
        rows.append([_signed(st["state"] >> 64), _signed(st["state"]),
                     _signed(st["inc"] >> 64), _signed(st["inc"])])
    t = torch.tensor(rows, dtype=I64).reshape(-1, 4).to(device)
    n = t.shape[0]
    return PCG64State(
        state_hi=t[:, 0].contiguous(), state_lo=t[:, 1].contiguous(),
        inc_hi=t[:, 2].contiguous(), inc_lo=t[:, 3].contiguous(),
        has_uint32=torch.zeros(n, dtype=torch.bool, device=device),
        uinteger=torch.zeros(n, dtype=I64, device=device),
        fence=torch.zeros(n, dtype=I64, device=device))


def select(pred, a, b):
    """``where(pred, a, b)`` leaf by leaf over two states of the same type
    (NamedTuples, nested); ``pred`` is ``[N]``.  A leaf that is the same
    tensor in both is passed through without an op."""
    if isinstance(a, tuple):
        return type(a)(*(select(pred, x, y) for x, y in zip(a, b)))
    if a is b:
        return a
    p = pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim()))
    return torch.where(p, a, b)


def _split32(x):
    return x & M32, _srl(x, 32)


def _mulhi64(a, b):
    """High 64 bits of the 128-bit product of two u64 bit patterns; ``b``
    may be a tensor or a pair ``(b0, b1)`` of its 32-bit halves."""
    a0, a1 = _split32(a)
    b0, b1 = b if isinstance(b, tuple) else _split32(b)
    t = a1 * b0 + _srl(a0 * b0, 32)
    w1 = t & M32
    w2 = _srl(t, 32)
    t = a0 * b1 + w1
    return a1 * b1 + w2 + _srl(t, 32)


def _step(s: PCG64State) -> PCG64State:
    """state = state * PCG_MULT + inc  (mod 2**128)."""
    lo = s.state_lo * _PCG_MULT_LO
    hi = (s.state_hi * _PCG_MULT_LO + s.state_lo * _PCG_MULT_HI
          + _mulhi64(s.state_lo, (_PCG_MULT_LO & M32, _PCG_MULT_LO >> 32)))
    lo2 = lo + s.inc_lo
    carry = _ult(lo2, lo).to(I64)
    return s._replace(state_hi=hi + s.inc_hi + carry, state_lo=lo2)


def _output_xsl_rr(hi, lo):
    rot = _srl(hi, 58)
    v = hi ^ lo
    return _srl_var(v, rot) | (v << ((-rot) & 63))


def next_uint64(s: PCG64State) -> Tuple[torch.Tensor, PCG64State]:
    """One 64-bit draw per stream: step the LCG, then XSL-RR output."""
    s = _step(s)
    return _output_xsl_rr(s.state_hi, s.state_lo), s


def next_uint32(s: PCG64State) -> Tuple[torch.Tensor, PCG64State]:
    """Buffered 32-bit draw (low half first, high half cached)."""
    v64, fresh = next_uint64(s)
    use = s.has_uint32
    val = torch.where(use, s.uinteger, v64 & M32)
    return val, PCG64State(
        state_hi=torch.where(use, s.state_hi, fresh.state_hi),
        state_lo=torch.where(use, s.state_lo, fresh.state_lo),
        inc_hi=s.inc_hi, inc_lo=s.inc_lo,
        has_uint32=~use,
        uinteger=torch.where(use, s.uinteger, _srl(v64, 32)),
        fence=s.fence)


def _to_double(v64):
    return _srl(v64, 11).to(F64) * _D_2POW53_INV


def next_double(s: PCG64State) -> Tuple[torch.Tensor, PCG64State]:
    """``Generator.random()``: 53-bit mantissa double in [0, 1)."""
    v, s = next_uint64(s)
    return _to_double(v), s


def uniform(s: PCG64State, low: float, high: float
            ) -> Tuple[torch.Tensor, PCG64State]:
    """``Generator.uniform(low, high)``: ``low + (high - low) * random()``,
    the product rounded before the add, as NumPy does."""
    d, s = next_double(s)
    return low + (high - low) * d, s


# ---------------------------------------------------------------------------
# jump-ahead: K draws of every stream at once
# ---------------------------------------------------------------------------

_JUMP = {}


def _jump_consts(k: int, device):
    """(A_hi, A_lo, A_lo halves, B_hi, B_lo, B_lo halves) for steps
    1..k, int64 [k] tensors on ``device`` (built once per k and device)."""
    key = (k, str(device))
    if key not in _JUMP:
        a, b = 1, 0
        rows = []
        for _ in range(k):
            a = (a * _PCG_MULT) & ((1 << 128) - 1)
            b = (b * _PCG_MULT + 1) & ((1 << 128) - 1)
            rows.append([_signed(a >> 64), _signed(a), a & M32,
                         (a >> 32) & M32, _signed(b >> 64), _signed(b),
                         b & M32, (b >> 32) & M32])
        t = torch.tensor(rows, dtype=I64).T.contiguous().to(device)
        _JUMP[key] = tuple(t)
    return _JUMP[key]


def _mul128(xh, xl, xl01, yh, yl):
    """The low 128 bits of (xh, xl) * (yh, yl), limbs as u64 patterns;
    ``xl01`` are the 32-bit halves of ``xl``."""
    return (xh * yl + xl * yh + _mulhi64(yl, xl01), xl * yl)


def _jump(s: PCG64State, k: int):
    """The states after 1..k steps of every stream and their outputs:
    (hi, lo, out), each int64 ``[N, k]`` (column j is step j + 1)."""
    ah, al, al0, al1, bh, bl, bl0, bl1 = (
        c[None, :] for c in _jump_consts(k, s.state_lo.device))
    ph, pl = _mul128(ah, al, (al0, al1), s.state_hi[:, None],
                     s.state_lo[:, None])
    qh, ql = _mul128(bh, bl, (bl0, bl1), s.inc_hi[:, None],
                     s.inc_lo[:, None])
    lo = pl + ql
    hi = ph + qh + _ult(lo, pl).to(I64)
    return hi, lo, _output_xsl_rr(hi, lo)


def _advance(s: PCG64State, hi, lo, d):
    """``s`` after ``d`` (int64 [N], 0 <= d <= k) of the steps ``_jump``
    gave as ``hi``/``lo``: column d - 1, or the state itself at 0."""
    idx = (d - 1).clamp(min=0)[:, None]
    keep = d == 0
    return s._replace(
        state_hi=torch.where(keep, s.state_hi, hi.gather(1, idx)[:, 0]),
        state_lo=torch.where(keep, s.state_lo, lo.gather(1, idx)[:, 0]))


def next_doubles(s: PCG64State, k: int) -> Tuple[torch.Tensor, PCG64State]:
    """``k`` successive ``random()`` draws of every stream: f64 [N, k]."""
    hi, lo, out = _jump(s, k)
    return _to_double(out), s._replace(state_hi=hi[:, -1].contiguous(),
                                       state_lo=lo[:, -1].contiguous())


# ---------------------------------------------------------------------------
# bounded draws
# ---------------------------------------------------------------------------

def _lemire32(s: PCG64State, rng) -> Tuple[torch.Tensor, PCG64State]:
    """NumPy ``buffered_bounded_lemire_uint32`` on the buffered 32-bit
    stream.  ``rng`` (an int, or int64 [N] of u32 values) is the inclusive
    range - 1; an env with ``rng == 0`` consumes nothing and gets 0."""
    if isinstance(rng, int):
        if rng == 0:
            return torch.zeros_like(s.state_lo), s
        rng_excl = rng + 1
        threshold = (M32 - rng) % rng_excl
        may_reject = threshold != 0
    else:
        rng_excl = rng + 1
        threshold = (M32 - rng) % rng_excl
        may_reject = True

    v32, s_nz = next_uint32(s)
    m = v32 * rng_excl
    while may_reject:
        redraw = (m & M32) < threshold
        if not host_any(redraw):
            break
        v2, s2 = next_uint32(s_nz)
        m = torch.where(redraw, v2 * rng_excl, m)
        s_nz = select(redraw, s2, s_nz)
    val = _srl(m, 32)
    if isinstance(rng, int):
        return val, s_nz
    is_zero = rng == 0
    return torch.where(is_zero, 0, val), select(is_zero, s, s_nz)


def _lemire64(s: PCG64State, rng: int) -> Tuple[torch.Tensor, PCG64State]:
    """NumPy ``bounded_lemire_uint64`` for a range that does not fit in
    32 bits (``rng`` a host int): the threshold ``-rng_excl mod rng_excl``
    is formed on the host in exact integers."""
    rng_excl = rng + 1
    threshold = _signed(((1 << 64) - rng_excl) % rng_excl)
    b01 = (rng_excl & M32, rng_excl >> 32)
    b = _signed(rng_excl)

    v, s = next_uint64(s)
    m_hi, m_lo = _mulhi64(v, b01), v * b
    while True:
        redraw = _ult(m_lo, torch.full_like(m_lo, threshold))
        if not host_any(redraw):
            break
        v2, s2 = next_uint64(s)
        m_hi = torch.where(redraw, _mulhi64(v2, b01), m_hi)
        m_lo = torch.where(redraw, v2 * b, m_lo)
        s = select(redraw, s2, s)
    return m_hi, s


def integers(s: PCG64State, low, high) -> Tuple[torch.Tensor, PCG64State]:
    """``Generator.integers(low, high)`` (endpoint-exclusive, int64):
    ranges that fit in 32 bits take the buffered 32-bit Lemire path, a
    larger range given as host ints the 64-bit path."""
    if isinstance(low, int) and isinstance(high, int) and \
            high - low - 1 > M32:
        v, s = _lemire64(s, high - low - 1)
        return low + v, s
    if isinstance(low, int) and isinstance(high, int):
        v, s = _lemire32(s, high - low - 1)
        return low + v, s
    low = torch.as_tensor(low, dtype=I64, device=s.state_lo.device)
    high = torch.as_tensor(high, dtype=I64, device=s.state_lo.device)
    v, s = _lemire32(s, (high - low - 1) & M32)
    return low + v, s


def _fill_mask(mx):
    m = mx
    for k in (1, 2, 4, 8, 16):
        m = m | (m >> k)
    return m


def random_interval32(s: PCG64State, mx) -> Tuple[torch.Tensor, PCG64State]:
    """``random_interval(max)`` for max in [0, 2**32): mask rejection on
    buffered uint32 draws (``max`` inclusive; 0 consumes nothing).  ``mx``
    is an int or int64 [N]."""
    if isinstance(mx, int) and mx == 0:
        return torch.zeros_like(s.state_lo), s
    m = _fill_mask(mx)
    v, s_nz = next_uint32(s)
    v = v & m
    # with max all ones below its top bit no draw is ever rejected
    while not (isinstance(mx, int) and m == mx):
        redraw = v > mx
        if not host_any(redraw):
            break
        v2, s2 = next_uint32(s_nz)
        v = torch.where(redraw, v2 & m, v)
        s_nz = select(redraw, s2, s_nz)
    if isinstance(mx, int):
        return v, s_nz
    is_zero = mx == 0
    return torch.where(is_zero, 0, v), select(is_zero, s, s_nz)


_SHUFFLE_BLOCK = 96      # 64-bit draws per jump-ahead block: 192 words
_SHUFFLE_CHUNK = 16      # words per automaton chunk; divides 2 * block
_SHUFFLE_TABLES = {}


def _shuffle_tables(n: int, device):
    """(max, mask) of the j-th draw of a shuffle of ``n``, for j in
    [0, n + _SHUFFLE_CHUNK): max = n-1-j, and max -1 (never accepts) once
    the shuffle is done (j >= n - 1)."""
    key = (n, str(device))
    if key not in _SHUFFLE_TABLES:
        mx = [n - 1 - j if j < n - 1 else -1
              for j in range(n + _SHUFFLE_CHUNK)]
        mk = [_fill_mask(v) if v >= 0 else 0 for v in mx]
        _SHUFFLE_TABLES[key] = (torch.tensor(mx, dtype=I64, device=device),
                                torch.tensor(mk, dtype=I64, device=device))
    return _SHUFFLE_TABLES[key]


def _compose_chunk(words, j0, mx_tab, m_tab):
    """Draws accepted and words consumed by each env over one chunk of its
    u32 word stream ``words`` [N, L] (L a power of two), starting with
    ``j0`` draws done.  The chunk is an automaton over the L + 1 relative
    draw counts r: word q maps r to r + accept(q, j0 + r) and consumes
    itself while the shuffle is not done.  The L maps are composed by
    halving (log2 L gathers), and the composite is read at r = 0."""
    n_env, L = words.shape
    r = torch.arange(L + 1, dtype=I64, device=words.device)
    j = (j0[:, None] + r[None, :]).clamp(max=mx_tab.shape[0] - 1)
    mx, mk = mx_tab[j][:, None, :], m_tab[j][:, None, :]
    acc = ((words[:, :, None] & mk) <= mx).to(I64)     # [N, L, L+1]
    f = (r + acc).clamp(max=L)
    c = (mx >= 0).to(I64).expand(n_env, L, L + 1)
    while f.shape[1] > 1:
        f1, f2 = f[:, 0::2], f[:, 1::2]
        c = c[:, 0::2] + c[:, 1::2].gather(2, f1)
        f = f2.gather(2, f1)
    return f[:, 0, 0], c[:, 0, 0]


def shuffle_consume(s: PCG64State, n: int) -> PCG64State:
    """Advance every stream exactly as ``Generator.shuffle`` of an
    n-element sequence does (draw j, j = 0 .. n-2, is
    ``random_interval32(n - 1 - j)``), discarding the permutation.

    Each env's stream is one sequence of buffered u32 words: the cached
    half (if any), then the low and high halves of the next 64-bit
    draws.  Blocks of 64-bit draws come from ``_jump``; their words are
    run through ``_compose_chunk`` in chunks until every env has made its
    n - 1 draws (about 141 words on average for n = 100; one block of 192
    words holds them almost always, and one read per block tests that).
    The state then advances by the 64-bit draws the consumed words used,
    and the buffer holds what NumPy's would."""
    if n <= 1:
        return s
    mx_tab, m_tab = _shuffle_tables(n, s.state_lo.device)
    n_env = s.state_lo.shape[0]
    h = s.has_uint32.to(I64)
    k_block = _SHUFFLE_BLOCK
    j = torch.zeros(n_env, dtype=I64, device=s.state_lo.device)
    used = torch.zeros_like(j)          # words consumed
    base, n_draws = s, 0
    his, los, outs = [], [], []
    while True:
        hi, lo, out = _jump(base, k_block)
        his.append(hi)
        los.append(lo)
        outs.append(out)
        seq = torch.stack([out & M32, _srl(out, 32)], dim=2).reshape(
            n_env, 2 * k_block)
        if n_draws == 0:
            # the cached half first; the block's last word then waits for
            # the next block
            shifted = torch.cat([s.uinteger[:, None], seq[:, :-1]], dim=1)
            words = torch.where(s.has_uint32[:, None], shifted, seq)
        else:
            # this block's words for envs that began with a cached half
            # start one word later in the stream
            prev_last = _srl(outs[-2][:, -1:], 32)
            shifted = torch.cat([prev_last, seq[:, :-1]], dim=1)
            words = torch.where(s.has_uint32[:, None], shifted, seq)
        for c in range(0, 2 * k_block, _SHUFFLE_CHUNK):
            dj, dw = _compose_chunk(words[:, c:c + _SHUFFLE_CHUNK], j,
                                    mx_tab, m_tab)
            j, used = j + dj, used + dw
        n_draws += k_block
        if not host_any(j < n - 1):
            break
        base = base._replace(state_hi=hi[:, -1].contiguous(),
                             state_lo=lo[:, -1].contiguous())
    hi = torch.cat(his, dim=1)
    lo = torch.cat(los, dim=1)
    out = torch.cat(outs, dim=1)
    fresh = used - h                    # words taken from 64-bit draws
    d = (fresh + 1) // 2                # 64-bit draws used
    last = _srl(out.gather(1, (d - 1).clamp(min=0)[:, None])[:, 0], 32)
    s2 = _advance(s, hi, lo, d)
    return s2._replace(has_uint32=(fresh % 2) == 1,
                       uinteger=torch.where(d > 0, last, s.uinteger))


def choice_p(s: PCG64State, p) -> Tuple[torch.Tensor, PCG64State]:
    """``Generator.choice(len(p), p=p)`` for probability rows ``p``
    (f64 [N, n]): cdf = cumsum(p) built by sequential adds in NumPy's
    order (a parallel scan would associate differently), cdf /= cdf[-1],
    one ``random()`` draw, ``searchsorted(cdf, u, side='right')``."""
    u, s = next_double(s)
    return _choice_from_u(p, u), s


def _choice_from_u(p, u):
    """``searchsorted(cdf, u, side='right')`` for probability rows ``p``
    [N, n] and draws ``u`` ([N] or [N, 1]).  The last cdf entry is
    ``c / c == 1.0 > u`` and never counts, so only the first n - 1 are
    formed."""
    acc = p[:, 0]
    terms = [acc]
    for i in range(1, p.shape[1]):
        acc = acc + p[:, i]
        terms.append(acc)
    cdf = torch.stack(terms[:-1], dim=1) / acc[:, None]
    return (cdf <= u.reshape(-1, 1)).sum(dim=1)


def choice_n(s: PCG64State, n) -> Tuple[torch.Tensor, PCG64State]:
    """``Generator.choice(n)`` (uniform, no p): one Lemire integers draw."""
    return integers(s, 0, n)
