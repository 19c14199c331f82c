"""Legacy global NumPy ``RandomState`` (MT19937), batched, in PyTorch.

The port of ``marl_sortingenv_tpu.core.legacy_random``.  The monolith's
``mode='random'`` (the 5-policy benchmark's "Random" scenario) draws from
the legacy global stream (``np.random.choice`` / ``np.random.randint``),
so its parity needs MT19937 and the legacy bounded integer algorithm:
mask rejection, not Lemire.

Seeding runs on the host through NumPy itself (``np.random.RandomState(
seed).get_state()``); the tensors carry only the twist, the tempering and
the masked bounded draw.  The key words are u32 values in ``int64``
tensors; ``key`` is ``[N, 624]``, ``pos`` ``int32 [N]``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import resolve_device
from . import rng as R

I32 = torch.int32
I64 = torch.int64

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF


class MTState(NamedTuple):
    key: torch.Tensor  # u32 words as int64 [N, 624]
    pos: torch.Tensor  # int32 [N]: next word to read; 624 triggers a twist


def mt19937_init(seed, device="cuda") -> MTState:
    """Equal to ``np.random.seed(s)`` for each seed ``s`` of ``seed`` (a
    scalar or a 1-D array)."""
    device = resolve_device(device)
    flat = np.asarray(seed).reshape(-1)
    keys = np.empty((flat.shape[0], _N), np.int64)
    poss = np.empty(flat.shape[0], np.int32)
    for i, s in enumerate(flat):
        st = np.random.RandomState(int(s)).get_state()
        keys[i] = st[1]
        poss[i] = st[2]
    return MTState(key=torch.from_numpy(keys).to(device),
                   pos=torch.from_numpy(poss).to(device))


def _twist(key):
    """Full 624-word regeneration, the canonical in-place ascending loop
    in staged slices: for i >= N - M the ``mt[(i + M) % N]`` operand is a
    word already rewritten this round, and the last word reads the new
    ``mt[0]``."""
    nm = _N - _M  # 227

    def part(y_hi, y_lo, km):
        y = (y_hi & _UPPER) | (y_lo & _LOWER)
        mag = torch.where((y & 1) == 1, _MATRIX_A, 0)
        return km ^ (y >> 1) ^ mag

    old = key
    s1 = part(old[:, 0:nm], old[:, 1:nm + 1], old[:, _M:_N])
    s2 = part(old[:, nm:2 * nm], old[:, nm + 1:2 * nm + 1], s1)
    s3 = part(old[:, 2 * nm:_N - 1], old[:, 2 * nm + 1:_N],
              s2[:, :_N - 1 - 2 * nm])
    s4 = part(old[:, _N - 1:_N], s1[:, 0:1], s2[:, _M - nm - 1:_M - nm])
    return torch.cat([s1, s2, s3, s4], dim=1)


def next_uint32(s: MTState) -> Tuple[torch.Tensor, MTState]:
    """One tempered word per stream; a stream at the end of its words
    twists first (tested once for the batch, one counted host read)."""
    need = s.pos >= _N
    key, pos = s.key, s.pos
    if R.host_any(need):
        key = torch.where(need[:, None], _twist(key), key)
        pos = torch.where(need, 0, pos)
    y = key.gather(1, pos.to(I64)[:, None])[:, 0]
    y = y ^ (y >> 11)
    y = y ^ ((y << 7) & 0x9D2C5680)
    y = y ^ ((y << 15) & 0xEFC60000)
    y = y ^ (y >> 18)
    return y, MTState(key=key, pos=pos + 1)


def legacy_randint(s: MTState, n) -> Tuple[torch.Tensor, MTState]:
    """``np.random.randint(0, n)`` / ``np.random.choice(n)`` (legacy):
    mask rejection on 32-bit draws; ``n == 1`` consumes nothing.  ``n`` is
    an int or int [N]; returns int32 [N]."""
    rng = torch.as_tensor(n, device=s.key.device).to(I64) - 1
    rng = rng.expand(s.pos.shape)
    m = R._fill_mask(rng)

    v, s_nz = next_uint32(s)
    v = v & m
    while True:
        redraw = v > rng
        if not R.host_any(redraw):
            break
        v2, s2 = next_uint32(s_nz)
        v = torch.where(redraw, v2 & m, v)
        s_nz = R.select(redraw, s2, s_nz)
    is_zero = rng == 0
    return (torch.where(is_zero, 0, v).to(I32),
            R.select(is_zero, s, s_nz))
