"""Integer-exact (fixed-point) policy forward for the integer-exact engine,
in PyTorch.

The port of ``marl_sortingenv_tpu.models.mlp_exact``: a Q14 fixed-point
policy tower evaluated in integer arithmetic alone (int64 accumulation, a
host-baked integer tanh table, an integer argmax), so that the card, the
CPU and the JAX package pick the same actions bit for bit.  The f32
``ActorCritic`` forward is not such a surface (products and ``tanh`` round
differently per backend); the quantized policy is the exact engine's
authoritative policy, a deterministic surrogate of the f32 one.

Numerics (the JAX package's):

* scale S = 2**14; an obs (already clipped to [-1, 1]) quantizes to Q14 as
  ``round(obs * S)``: the power-of-two product is exact and IEEE
  round-half-even is the same on every device;
* weights Q14 (int32), biases Q28 (int64), both rounded once on the host
  in f64;
* per layer: int64 products and sums (Q28), the bias, an arithmetic shift
  back to Q14, then a saturating tanh from a 131,073-entry table (tanh on
  [-4, 4]);
* the logits stay Q28 int64; a masked entry becomes ``int64 min // 2``.

The products are a broadcast multiply and a sum: ``torch.matmul`` has no
int64 kernel on CUDA, and integer sums are exact in any order.
"""

from __future__ import annotations

import zlib
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import resolve_device
from . import mlp

FRAC = 14
SCALE = 1 << FRAC                    # 16384
TANH_IN_MAX = 4 * SCALE              # saturate |x| > 4.0

I32 = torch.int32
I64 = torch.int64

# host-baked integer tanh: _TANH_TABLE[i + TANH_IN_MAX] = rint(tanh(i/S)*S)
_TANH_TABLE = np.rint(
    np.tanh(np.arange(-TANH_IN_MAX, TANH_IN_MAX + 1, dtype=np.float64)
            / SCALE) * SCALE).astype(np.int32)
_TANH_ON = {}

_MASKED = torch.iinfo(torch.int64).min // 2


def tanh_table_checksum() -> int:
    """CRC32 of the baked table (pinned in the tests, as the JAX package
    pins its own)."""
    return zlib.crc32(_TANH_TABLE.tobytes())


def _tanh_table(device) -> torch.Tensor:
    key = str(device)
    if key not in _TANH_ON:
        _TANH_ON[key] = torch.from_numpy(_TANH_TABLE).to(device)
    return _TANH_ON[key]


class QDense(NamedTuple):
    w: torch.Tensor  # int32 [in, out], Q14
    b: torch.Tensor  # int64 [out], Q28


class QPolicy(NamedTuple):
    pi: Tuple[QDense, ...]
    action: QDense


def quantize_policy(params, device="cuda") -> QPolicy:
    """One-time quantization of a policy tower on the host (numpy f64
    ``rint``, the JAX package's arithmetic): ``params`` is an
    ``ActorCritic`` or the JAX package's layout (``mlp.ACParams``, or any
    object with ``pi`` and ``action``, ``Dense.w`` being ``[in, out]``)."""
    dev = resolve_device(device)
    if isinstance(params, mlp.ActorCritic):
        params = mlp.params_to_jax(params)

    def q(lyr) -> QDense:
        wq = np.rint(np.asarray(lyr.w, np.float64) * SCALE)
        bq = np.rint(np.asarray(lyr.b, np.float64) * SCALE * SCALE)
        if np.abs(wq).max(initial=0) >= 2**31:
            raise ValueError("weight out of Q14 int32 range")
        return QDense(torch.from_numpy(wq.astype(np.int32)).to(dev),
                      torch.from_numpy(bq.astype(np.int64)).to(dev))

    return QPolicy(pi=tuple(q(lyr) for lyr in params.pi),
                   action=q(params.action))


def quantize_obs(obs: torch.Tensor) -> torch.Tensor:
    """f32 obs in [-1, 1] -> Q14 int32: ``round(obs * 16384)``, exact."""
    return torch.round(obs.to(torch.float32) * float(SCALE)).to(I32)


def _tanh_q(x_q28: torch.Tensor) -> torch.Tensor:
    """Q28 int64 pre-activation -> Q14 int32 tanh from the table."""
    h = (x_q28 >> FRAC).clamp(-TANH_IN_MAX, TANH_IN_MAX)  # arithmetic
    return _tanh_table(x_q28.device)[h + TANH_IN_MAX]


def _imatmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int64 [..., D] @ int64 [D, O] as a broadcast multiply and a sum."""
    return (x[..., :, None] * w).sum(dim=-2)


def policy_logits_q(qp: QPolicy, obs_q: torch.Tensor) -> torch.Tensor:
    """Integer policy forward: Q14 int32 obs [..., D] -> Q28 int64 logits
    [..., A]."""
    x = obs_q.to(I64)
    for lyr in qp.pi:
        acc = _imatmul(x, lyr.w.to(I64)) + lyr.b                   # Q28
        x = _tanh_q(acc).to(I64)                                   # Q14
    return _imatmul(x, qp.action.w.to(I64)) + qp.action.b


def predict_deterministic_q(qp: QPolicy, obs: torch.Tensor,
                            mask=None) -> torch.Tensor:
    """SB3 ``predict(deterministic=True)`` in integers: the argmax of the
    (masked) Q28 logits, int32.  Integer logits can tie exactly; the first
    maximal index wins, as ``jnp.argmax`` (and ``torch.argmax`` on every
    device) resolves it."""
    logits = policy_logits_q(qp, quantize_obs(obs))
    if mask is not None:
        logits = torch.where(mask, logits, _MASKED)
    return torch.argmax(logits, dim=-1).to(I32)


def logits_q_as_f64(qp: QPolicy, obs: torch.Tensor) -> torch.Tensor:
    """The integer logits as f64, exactly (|Q28 logits| << 2^53)."""
    return policy_logits_q(qp, quantize_obs(obs)).to(torch.float64)
