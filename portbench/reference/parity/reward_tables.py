"""Exact reward tables — bit-exact rewards by construction.

The sorting reward (reference ``env_super.py:963-1003``) ends in
``np.tanh``.  NumPy's f64 tanh is a private SIMD polynomial that differs
from libm in the last ulp (~27% of arguments on this host), so no
re-implementation can honestly claim bit-exactness.  But the argument is
a *finite* set: each container purity is a 2-decimal-quantized double
(``round(true/total, 2)`` -> one of the 101 canonical grid doubles, or
the empty-container threshold, ``env_super.py:771-791``), and the score
accumulates in a fixed association order ``((dA+dB)+dC)+dD``
(``env_super.py:983-991``).  For the default config that is **1770
distinct scores**.  We enumerate them on the host, evaluate the full
reference pipeline (division, scaling, ``np.tanh``) with NumPy itself,
and ship the result as a lookup table.  The device never evaluates a
transcendental: it computes the (bit-exact) score and looks the reward
up.  Bit-exactness is then true *by construction* — the table values ARE
NumPy's outputs.

Two lookup frontends:

* parity engine (f64 on CPU): ``searchsorted`` on the sorted score set;
* exact/TPU engine (integer cents): staged index tables mapping the four
  purity-cent integers straight to the reward — no f64 arithmetic at all.

The press reward (``env_super.py:1006-1080``) has no transcendentals but
its overflow branches compare ``level/700`` against 1.0/0.95/0.90 in f64.
We precompute the exact integer cutoffs so the device compares integers.
The action reward depends only on ``(dist, min(num_bales,3))`` — a tiny
host-enumerated table of exact doubles.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..config import SimConfig


def _purity_grid() -> np.ndarray:
    """The 101 canonical doubles reachable from np_round2(true/total):
    rint(x*100) -> k, then k/100 rounded-to-nearest."""
    return np.arange(101, dtype=np.float64) / 100.0


@dataclasses.dataclass(frozen=True)
class SortingRewardTable:
    """score -> reward, plus the staged cent-index path."""
    # parity-engine path: sorted distinct scores and their rewards
    scores: np.ndarray        # [K] f64, sorted
    rewards: np.ndarray       # [K] f64 = np.tanh of the exact pipeline
    # exact-engine path: cents (c0..c3 in 0..100) -> staged indices
    idx2: np.ndarray          # [101,101] i32 -> index into lvl2 set
    idx3: np.ndarray          # [n2, 101] i32 -> index into lvl3 set
    idx4: np.ndarray          # [n3, 101] i32 -> index into scores/rewards
    # reward decomposition for signed-softfloat accumulation on device
    reward_sign: np.ndarray   # [K] i32 in {-1, 0, +1}
    reward_m: np.ndarray      # [K] u64 mantissa in [2^52, 2^53) or 0
    reward_e: np.ndarray      # [K] i32 exponent (value = m * 2^e)
    reward_bits: np.ndarray   # [K] u64 IEEE-754 bit pattern


def _decompose(vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """IEEE f64 -> (sign, mantissa in [2^52,2^53) or 0, exponent)."""
    bits = vals.view(np.uint64)
    sign = np.where(vals == 0.0, 0, np.where(np.signbit(vals), -1, 1))
    biased = ((bits >> np.uint64(52)) & np.uint64(0x7FF)).astype(np.int64)
    frac = bits & np.uint64((1 << 52) - 1)
    # normals only in our domain (|reward| <= 1, never subnormal unless 0)
    m = np.where(vals == 0.0, np.uint64(0),
                 frac | np.uint64(1 << 52))
    e = np.where(vals == 0.0, 0, biased - 1023 - 52)
    return sign.astype(np.int32), m, e.astype(np.int32)


def build_sorting_table(cfg: SimConfig) -> SortingRewardTable:
    theta = np.float64(cfg.purity_threshold_theta)
    grid = _purity_grid()

    # cents index: the exact engine addresses materials by purity cents;
    # the empty-container default (bale_quality_thresholds[mat],
    # env_super.py:786-789) must land on the grid for the cent path
    thr = np.float64(cfg.quality_threshold)
    assert thr in grid, "non-grid quality threshold: exact path unsupported"
    dcents = grid - theta                       # [101], index = cents

    # staged association-order enumeration: ((d0+d1)+d2)+d3
    s2_all = dcents[:, None] + dcents[None, :]          # [101,101]
    s2, idx2 = np.unique(s2_all, return_inverse=True)
    idx2 = idx2.reshape(101, 101).astype(np.int32)

    s3_all = s2[:, None] + dcents[None, :]
    s3, idx3 = np.unique(s3_all, return_inverse=True)
    idx3 = idx3.reshape(s2.size, 101).astype(np.int32)

    s4_all = s3[:, None] + dcents[None, :]
    s4, idx4 = np.unique(s4_all, return_inverse=True)
    idx4 = idx4.reshape(s3.size, 101).astype(np.int32)

    # full reference reward pipeline on the host (env_super.py:992-998):
    # raw = (score/4) * scaling ; reward = np.tanh(raw / temperature)
    raw = (s4 / 4.0) * np.float64(cfg.purity_scaling_factor)
    rewards = np.tanh(raw / np.float64(cfg.tanh_temperature))

    sign, m, e = _decompose(rewards)
    return SortingRewardTable(
        scores=s4, rewards=rewards, idx2=idx2, idx3=idx3, idx4=idx4,
        reward_sign=sign, reward_m=m, reward_e=e,
        reward_bits=rewards.view(np.uint64),
    )


@dataclasses.dataclass(frozen=True)
class PressRewardTable:
    """Integer cutoffs + the (dist, bonus) action-reward table."""
    cut_catastrophic: int     # min level with level/cap >  1.0
    cut_severe: int           # min level with level/cap >  0.95
    cut_mild: int             # min level with level/cap >  0.90
    action: np.ndarray        # [bs//2+1, 4] f64: efficiency + (peak - bef)
    action_sign: np.ndarray   # decomposed for softfloat accumulation
    action_m: np.ndarray
    action_e: np.ndarray


def build_press_table(cfg: SimConfig) -> PressRewardTable:
    cap = int(cfg.container_capacity)
    levels = np.arange(0, 64 * cap, dtype=np.int64)
    fill = levels.astype(np.float64) / np.float64(cap)

    def first(mask):
        i = np.argmax(mask)
        assert mask[i]
        return int(levels[i])

    # thresholds are hard-coded in the reference (env_super.py:1011-1030);
    # only the penalty magnitudes come from config.yml:50-52
    cut_cat = first(fill > 1.0)
    cut_sev = first(fill > 0.95)
    cut_mild = first(fill > 0.90)

    bs = int(cfg.effective_balesize)
    bef = np.float64(cfg.bale_efficiency_factor)
    dist = np.arange(bs // 2 + 1, dtype=np.float64)
    efficiency = (1.0 - 4.0 * (dist / np.float64(bs))) * bef
    peaks = np.array([0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0], np.float64)
    action = efficiency[:, None] + (peaks[None, :] - bef)

    sign, m, e = _decompose(action.ravel())
    return PressRewardTable(
        cut_catastrophic=cut_cat, cut_severe=cut_sev, cut_mild=cut_mild,
        action=action,
        action_sign=sign.reshape(action.shape),
        action_m=m.reshape(action.shape),
        action_e=e.reshape(action.shape),
    )
