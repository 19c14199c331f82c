"""Eager threefry2x32 with ``jax.random``'s partitionable semantics.

The counterpart of the batched RNG of ``marl_sortingenv_tpu.core.fastb``
(``_vsplit`` / ``_vuniform`` / ``_vuniform4`` / ``_vrandint4`` /
``_vbernoulli`` / ``_vcategorical``), of the learner's one-key draws
(``categorical``, ``permutation``, ``normal``) and of the JAX kernels'
``_threefry`` / ``_bits_to_unit_f32``.  For the same keys it draws the
same bits:

* ``split(key, num)`` row i is the block with 64-bit counter (0, i), both
  output words kept as the new key;
* a 32-bit ``random_bits`` word of a shape-(k,) draw is ``o0 ^ o1`` of the
  block (0, i);
* ``uniform`` is ``bitcast((bits >> 9) | 0x3f800000) - 1``.

Keys are ``int32[N, 2]`` tensors holding the u32 bit patterns.  PyTorch's
CPU ``uint32`` has no add, shift or remainder, so the rounds run on int64
tensors masked to 32 bits.  The CUDA kernel
(``csrc/threefry.cuh``) computes the same function in native u32.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device

_MASK = 0xFFFFFFFF
_ROT_EVEN = (13, 15, 26, 6)
_ROT_ODD = (17, 29, 16, 24)
_ROTS = (_ROT_EVEN, _ROT_ODD, _ROT_EVEN, _ROT_ODD, _ROT_EVEN)


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 holding the u32 value."""
    return x.to(torch.int64) & _MASK


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> int32 with the same bit pattern."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def threefry2x32(k0, k1, c0, c1):
    """One threefry2x32 block per element; all operands are broadcastable
    int64 tensors (or ints) holding u32 values.  Returns (o0, o1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (c0 + ks[0]) & _MASK
    x1 = (c1 + ks[1]) & _MASK
    for grp in range(5):
        for r in _ROTS[grp]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) & _MASK) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        i = grp + 1
        x0 = (x0 + ks[i % 3]) & _MASK
        x1 = (x1 + ks[(i + 1) % 3] + i) & _MASK
    return x0, x1


def _blocks(keys: torch.Tensor, num: int, start: int = 0):
    """Blocks (0, i) for start <= i < start + num of every key: int64
    (N, num) pairs."""
    k = _u32(keys)
    k0, k1 = k[:, 0:1], k[:, 1:2]
    ctr = torch.arange(start, start + num, dtype=torch.int64,
                       device=keys.device)[None, :]
    return threefry2x32(k0, k1, torch.zeros_like(ctr), ctr)


def prng_key(seed: int, device="cuda") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**64: int32[2]."""
    if seed < 0 or seed >= 2**64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    k = torch.tensor([seed >> 32, seed & _MASK], dtype=torch.int64,
                     device=resolve_device(device))
    return _i32(k)


def split(keys: torch.Tensor, num: int = 2, start: int = 0) -> torch.Tensor:
    """``vmap(jax.random.split(k, num))``: int32[N, 2] -> int32[N, num, 2].
    With ``start``, rows start .. start + num - 1 of a larger split: the
    split is counter-based, so a slice costs only its own rows."""
    o0, o1 = _blocks(keys, num, start)
    return _i32(torch.stack([o0, o1], dim=-1))


def bits(keys: torch.Tensor, k: int) -> torch.Tensor:
    """``vmap(random_bits(key, 32, (k,)))`` as int64 u32 values, (N, k)."""
    o0, o1 = _blocks(keys, k)
    return o0 ^ o1


def bits_to_unit(b: torch.Tensor) -> torch.Tensor:
    """u32 values (int64) -> f32 in [0, 1), bit-exact with jax.random."""
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(keys: torch.Tensor) -> torch.Tensor:
    """``vmap(jax.random.uniform(k))``: f32[N] in [0, 1)."""
    return bits_to_unit(bits(keys, 1)[:, 0])


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """f32 fused multiply-add ``a * b + c`` rounded once, on f32 tensors.

    The product of two f32 is exact in f64; the f64 sum is made exact by
    TwoSum, and when its error term is non-zero the f64 sum is nudged one
    f64 ulp toward the true value, so that a tie in the final f64 -> f32
    rounding resolves as a single rounding would."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    inf = torch.full_like(s, float("inf"))
    toward = torch.where(e > 0, inf, -inf)
    s = torch.where(e != 0, torch.nextafter(s, toward), s)
    return s.float()


def uniform4(keys: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``vmap(jax.random.uniform(k, (4,), f32, lo, hi))``: f32[N, 4].

    jax computes ``max(lo, u01 * (hi - lo) + lo)`` with the span as an f32
    subtraction, and XLA on the CPU fuses the multiply-add."""
    u01 = bits_to_unit(bits(keys, 4))
    dev = keys.device
    lo32 = torch.tensor(lo, dtype=torch.float32, device=dev)
    hi32 = torch.tensor(hi, dtype=torch.float32, device=dev)
    span = hi32 - lo32
    return torch.maximum(lo32, fma_f32(u01, span.expand_as(u01),
                                       lo32.expand_as(u01)))


def randint4(keys: torch.Tensor) -> torch.Tensor:
    """``vmap(jax.random.randint(k, (4,), 0, 4, int32))``: int32[N, 4].

    For a span of 4 jax's two-word scheme reduces to
    ``random_bits(split(k)[1]) % 4``."""
    return (bits(split(keys)[:, 1], 4) % 4).to(torch.int32)


def bernoulli(keys: torch.Tensor) -> torch.Tensor:
    """``vmap(jax.random.bernoulli(k, 0.5))``: bool[N]."""
    return uniform(keys) < 0.5


# ---------------------------------------------------------------------------
# Draws from ONE key (the learner's key chain).  The learner keeps its key
# as an int32[2] tensor on the CPU: splitting it is host arithmetic on
# Python ints (no device launch, no device-to-host copy), and the draws it
# seeds run on the device the caller names.
# ---------------------------------------------------------------------------

def key_words(key) -> tuple[int, int]:
    """The two u32 words of one key: an int32[2] tensor or a pair of
    ints."""
    k = key.tolist() if isinstance(key, torch.Tensor) else list(key)
    return k[0] & _MASK, k[1] & _MASK


def split_key(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of one key, computed on the host:
    int32[num, 2] on the CPU."""
    k0, k1 = key_words(key)
    rows = [threefry2x32(k0, k1, 0, i) for i in range(num)]
    return _i32(torch.tensor(rows, dtype=torch.int64))


def random_bits(key, shape, device="cuda", offset: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit) of one key, as int64 u32
    values: word i of the flat shape is ``o0 ^ o1`` of the block with the
    64-bit counter (i >> 32, i & 0xffffffff), the partitionable scheme.
    With ``offset`` the words are those of flat indices offset, offset +
    1, ... of a larger draw: a shard's slice of it, and only that."""
    k0, k1 = key_words(key)
    shape = tuple(shape)
    size = int(np.prod(shape, dtype=np.int64)) if shape else 1
    idx = torch.arange(offset, offset + size, dtype=torch.int64,
                       device=resolve_device(device))
    o0, o1 = threefry2x32(k0, k1, idx >> 32, idx & _MASK)
    return (o0 ^ o1).reshape(shape)


def _perturbed(b: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``gumbel + logits`` from the u32 words ``b`` (int64, logits' shape),
    ``jax.random.gumbel``'s default ``'low'`` mode: ``g = -log(-log(u))``
    with ``u = max(tiny, u01 * (1 - tiny) + tiny)`` (the mul-add rounded
    once, as XLA fuses it)."""
    dev = logits.device
    u01 = bits_to_unit(b)
    lo = torch.tensor(torch.finfo(torch.float32).tiny, dtype=torch.float32,
                      device=dev)
    span = torch.tensor(1.0, dtype=torch.float32, device=dev) - lo
    u = torch.maximum(lo, fma_f32(u01, span.expand_as(u01),
                                  lo.expand_as(u01)))
    return -torch.log(-torch.log(u)) + logits.float()


def categorical(key, logits: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` of one key:
    ``argmax(gumbel + logits)``.  Returns int64 indices.  ``torch.log`` and
    XLA's ``log`` may differ in the last bit, so the draw agrees with JAX on
    the chosen index except where two perturbed logits tie to an ulp.
    ``row0``: ``logits`` [n, A] are rows row0 .. row0 + n - 1 of a larger
    batch, and the draw is that batch's draw for them (a shard's slice)."""
    b = random_bits(key, logits.shape, logits.device,
                    offset=row0 * logits.shape[-1])
    return torch.argmax(_perturbed(b, logits), dim=-1)


def vperturbed(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """The perturbed logits ``gumbel + logits`` (f32[N, A]) that
    ``vcategorical`` takes the argmax of."""
    return _perturbed(bits(keys, logits.shape[-1]), logits)


def vcategorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``vmap(jax.random.categorical)(keys, logits)``: one draw per key from
    its row of ``logits[N, A]``; the gumbel words of key i are
    ``bits(keys, A)[i]``.  Returns int64[N].  Agrees with JAX on the index
    except at near-ties, as ``categorical``."""
    return torch.argmax(vperturbed(keys, logits), dim=-1)


def normal(key, shape, device="cuda") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` of one key: a uniform on
    ``[nextafter(-1, 0), 1)`` (``u01 * span + lo``, the mul-add rounded
    once, then ``max(lo, .)``), mapped by ``sqrt(2) * erfinv``.
    ``torch.erfinv`` and XLA's ``erf_inv`` round differently, so the values
    agree with JAX to a few ulp, not bitwise."""
    device = resolve_device(device)
    u01 = bits_to_unit(random_bits(key, shape, device))
    lo = torch.tensor(np.nextafter(np.float32(-1.0), np.float32(0.0)),
                      dtype=torch.float32, device=device)
    span = torch.tensor(1.0, dtype=torch.float32, device=device) - lo
    u = torch.maximum(lo, fma_f32(u01, span.expand_as(u01),
                                  lo.expand_as(u01)))
    return torch.erfinv(u) * np.float32(np.sqrt(2))


def permutation(key, n: int, device="cuda") -> torch.Tensor:
    """``jax.random.permutation(key, n)``: JAX's ``_shuffle``, which runs
    ``ceil(3 ln n / ln(2**32 - 1))`` rounds; each splits the key, draws u32
    sort keys of shape (n,) from the second half and stable-sorts by them.
    Returns int64[n] on ``device``."""
    device = resolve_device(device)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        ks = split_key(key)
        key, sub = ks[0], ks[1]
        order = torch.sort(random_bits(sub, (n,), device), stable=True).indices
        x = x[order]
    return x
