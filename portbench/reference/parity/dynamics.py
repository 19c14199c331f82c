"""Dynamics of the sorting plant for the bit-exact parity engine, batched,
in PyTorch.

The port of ``marl_sortingenv_tpu.core.dynamics``: every function maps
``(cfg, EnvState, ...) -> (..., EnvState)`` on a batch-first state (see
``core/state.py``) and consumes exactly the random draws the reference
consumes, in its order, so that each env follows NumPy's trajectory bit
for bit.  Where the JAX package runs a data-dependent ``while_loop``
under ``vmap``, the port runs the loop for the batch with a ``where``
per env; a loop whose length the host must learn reads it once from the
device (``rng.HOST_SYNCS`` counts the reads).

f64 arithmetic follows NumPy's operation order, one rounding per op:
eager PyTorch fuses nothing, so no op here may be a fused one (no
``addcmul``, ``lerp``, f64 ``cumsum`` or ``torch.compile``).  A division
by a constant is a true division: the divisor is a device tensor
(``_div``), because PyTorch's CUDA ``tensor / python_scalar`` multiplies
by the reciprocal.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from . import rng as R
from .state import EnvState
from ..config import SimConfig

I32 = torch.int32
I64 = torch.int64
F64 = torch.float64

# Seasonal pattern ratios in material order A,B,C,D (the reference's
# input generator; dict key 1 row 0, key 2 row 1)
_PATTERNS = ((0.40, 0.15, 0.35, 0.10), (0.15, 0.40, 0.10, 0.35))

_CONSTS = {}


def _const(value, device, dtype=None) -> torch.Tensor:
    """A cached constant tensor on ``device`` (a scalar or a tuple), of
    ``dtype`` or, by default, the engine's float type ``F64``."""
    dtype = F64 if dtype is None else dtype
    key = (value, str(device), dtype)
    if key not in _CONSTS:
        _CONSTS[key] = torch.tensor(value, dtype=dtype, device=device)
    return _CONSTS[key]


def _div(a: torch.Tensor, c) -> torch.Tensor:
    """``a / c`` for a host constant ``c`` (or tuple), a true f64 division
    on every device."""
    return a / _const(c, a.device)


def _idx(x: torch.Tensor) -> torch.Tensor:
    return x.to(I64)


def _take(arr: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``arr[n, m[n]]`` for each env n (``arr`` [N, K])."""
    return arr.gather(1, _idx(m)[:, None])[:, 0]


def _onehot(m: torch.Tensor, k: int) -> torch.Tensor:
    """bool [N, k]: column m[n] of row n."""
    return torch.arange(k, device=m.device)[None, :] == _idx(m)[:, None]


def _put(arr: torch.Tensor, m: torch.Tensor, val) -> torch.Tensor:
    """``arr`` with ``arr[n, m[n]] = val[n]`` for each env n."""
    v = val[:, None] if isinstance(val, torch.Tensor) else val
    return torch.where(_onehot(m, arr.shape[1]), v, arr)


# ---------------------------------------------------------------------------
# Python-round semantics
# ---------------------------------------------------------------------------

def py_round2(x: torch.Tensor) -> torch.Tensor:
    """Python ``round(x, 2)``: the correctly rounded decimal, half to even,
    as CPython's ``double_round``.  ``np.round(x, 2)`` is not the same (it
    rounds the already-rounded product ``x*100``: ``round(1/40, 2)`` is
    0.03 in Python and 0.02 by scaled rint).

    Exact integer arithmetic on the IEEE bit pattern: with
    |x| = m * 2^E, the rounded decimal is k/100 with k = round_half_even(
    m * 100 * 2^E), from the exact integer m*100 (< 2^60) and a shift.
    Valid for |x| < 2^52 (the reference rounds values in [-1, 400]).
    In a float type other than float64 (the control) it is the scaled
    rint of ``np_round2``."""
    if F64 != torch.float64:
        return np_round2(x)
    x = x.to(F64)
    neg = x < 0.0
    bits = x.abs().view(I64)
    e_biased = (bits >> 52) & 0x7FF
    frac = bits & ((1 << 52) - 1)
    is_sub = e_biased == 0
    m = torch.where(is_sub, frac, frac | (1 << 52))
    e = torch.where(is_sub, -1074, e_biased - 1075)
    big_m = m * 100                      # exact: m < 2^53
    shift = -e
    # shift <= 0 cannot occur for |x| < 2^52; shift >= 64 => k = 0
    big = shift >= 64
    sh = shift.clamp(1, 63)
    one = torch.ones_like(sh)
    int_part = big_m >> sh               # big_m >= 0: logical shift
    frac_part = big_m & ((one << sh) - 1)
    half = one << (sh - 1)
    round_up = (frac_part > half) | ((frac_part == half)
                                     & ((int_part & 1) == 1))
    k = torch.where(big, 0, int_part + round_up.to(I64))
    out = _div(k.to(F64), 100.0)
    return torch.where(neg, -out, out)


def np_round2(x: torch.Tensor) -> torch.Tensor:
    """``round(np.float64(x), 2)``: ``rint(x*100)/100`` (half to even on
    the rounded product).  For x = 370/400 CPython rounds to 0.93, this to
    0.92; the reference's containers are ``np.int64``, so its purity and
    quality rounds take these semantics, and only the input occupancy
    takes ``py_round2``'s."""
    return _div(torch.round(x.to(F64) * 100.0), 100.0)


def py_round_int(x: torch.Tensor) -> torch.Tensor:
    """Python ``round(float)`` -> int (half to even), as in
    ``int(round(target_amount * acc))``."""
    return torch.round(x.to(F64)).to(I32)


# ---------------------------------------------------------------------------
# Input generation (the reference's SeasonalInputGenerator.generate_input)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _pattern_units(cfg: SimConfig):
    """Per pattern key (row): the floor allocation of the batch and the
    remainder handed out one unit at a time; the floor of the f64
    products, as the JAX package and NumPy form it."""
    units = np.floor(np.asarray(_PATTERNS, np.float64)
                     * np.float64(cfg.input_batch_size)).astype(np.int32)
    return units, cfg.input_batch_size - units.sum(axis=1)


def generate_input(cfg: SimConfig, st: EnvState
                   ) -> Tuple[torch.Tensor, EnvState]:
    """One batch per env: pattern switch every ``steps_per_pattern``
    calls, floor allocation, the remainder assigned one unit at a time to
    a uniformly chosen material, then a Fisher-Yates shuffle's draws
    consumed (only the counts reach the dynamics).  Returns per-material
    counts (i32 [N, 4])."""
    dev = st.current_step.device
    switch = st.gen_step_counter >= cfg.steps_per_pattern
    pattern_idx = torch.where(switch, (st.gen_pattern_idx + 1) % 2,
                              st.gen_pattern_idx)
    step_counter = torch.where(switch, 0, st.gen_step_counter)
    key = _take(st.gen_pattern_seq, pattern_idx)           # 1 or 2
    units_np, rem_np = _pattern_units(cfg)
    row = _idx(key - 1)
    units = _const(tuple(map(tuple, units_np.tolist())), dev, I32)[row]
    remainder = _const(tuple(rem_np.tolist()), dev, I32)[row]

    g = st.gen_rng
    for k in range(int(rem_np.max())):
        active = k < remainder
        m, g2 = R.choice_n(g, 4)
        units = units + (_onehot(m, 4) & active[:, None]).to(I32)
        g = R.select(active, g2, g)
    g = R.shuffle_consume(g, cfg.input_batch_size)

    return units, st._replace(gen_pattern_idx=pattern_idx,
                              gen_step_counter=step_counter + 1, gen_rng=g)


# ---------------------------------------------------------------------------
# Material flow + input rule
# ---------------------------------------------------------------------------

def input_action_rules(cfg: SimConfig, st: EnvState) -> EnvState:
    """Draws the input occupancy from rng_input; the value is unused by
    the dynamics but the stream advances."""
    _, rng_input = R.integers(st.rng_input, cfg.input_occupancy_min,
                              cfg.input_occupancy_max + 1)
    return st._replace(rng_input=rng_input)


def update_environment(cfg: SimConfig, st: EnvState) -> EnvState:
    """sorting <- belt <- input <- fresh batch; occupancy bookkeeping;
    the one-step accuracy delay."""
    st = st._replace(sort_counts=st.belt_counts, belt_counts=st.input_counts,
                     belt_occupancy=st.input_occupancy)
    counts, st = generate_input(cfg, st)
    total = counts.sum(dim=1, dtype=I32)
    return st._replace(
        input_counts=counts,
        input_occupancy=py_round2(_div(total.to(F64), 100.0)),
        acc_sorter=st.acc_belt,
        total_input_units=st.total_input_units + total)


# ---------------------------------------------------------------------------
# Sorting machine
# ---------------------------------------------------------------------------

def _props(counts: torch.Tensor) -> torch.Tensor:
    total = counts.sum(dim=1, dtype=I32)
    props = counts.to(F64) / total.to(F64)[:, None]
    return torch.where((total > 0)[:, None], props, 0.0)


def sorting_rules(st: EnvState) -> torch.Tensor:
    """Rule-based sort mode: boost the dominant pair.  An empty belt gives
    mode 1 (0 > 0 is False)."""
    p = _props(st.belt_counts)
    return torch.where(p[:, 0] + p[:, 2] > p[:, 1] + p[:, 3], 0, 1).to(I32)


def update_accuracy(cfg: SimConfig, st: EnvState) -> EnvState:
    """Boost the selected pair, add 4 sequential uniform noise draws (the
    reference's ``uniform(-noise, +noise, 4)``), clip to [0, 1]."""
    dev = st.current_step.device
    b = cfg.boost
    base = _const(tuple(cfg.baseline_accuracy), dev)
    setting = st.sensor_setting[:, None]
    acc = base + torch.where(
        setting == 0, _const((b, 0.0, b, 0.0), dev),
        torch.where(setting == 1, _const((0.0, b, 0.0, b), dev),
                    _const((0.0,) * 4, dev)))
    n = cfg.effective_noise
    d, g = R.next_doubles(st.rng_noise, 4)
    noise = -n + (n - -n) * d
    return st._replace(acc_belt=torch.clamp(acc + noise, 0.0, 1.0),
                       rng_noise=g)


def sort_material(cfg: SimConfig, st: EnvState
                  ) -> Tuple[torch.Tensor, EnvState]:
    """The hot loop: per station A..D the true/false split by banker's
    rounding, then the false units redistributed one by one with
    probability proportional to the current leftovers, one weighted
    ``choice`` draw of the ``rng`` (seed + 99) stream per unit.

    A station's false count never exceeds ``f(sort_counts[i])`` with
    ``f(t) = t - rint(t * acc)``, which does not decrease in t, and the
    leftovers only fall; so one host read of those bounds fixes every
    loop's length, and all the draws come in one jump-ahead block that
    each env reads from its own position.  Returns the step's mean purity
    (f64 [N])."""
    sc, acc = st.sort_counts, st.acc_sorter
    bounds = R.host_ints((sc - py_round_int(sc.to(F64) * acc)).amax(dim=0))
    total_input = sc.sum(dim=1, dtype=I32)
    g = st.rng
    n_draws = sum(bounds)
    if n_draws:
        hi, lo, out = R._jump(g, n_draws)
        u_all = R._to_double(out)
    # the leftovers, trues and falses are small integers, exact in f64:
    # pvals = leftover / total as the reference forms them, without casts
    ptr = torch.zeros((sc.shape[0], 1), dtype=I64, device=sc.device)
    leftover = sc.to(F64)
    cols = torch.arange(4, device=sc.device)
    trues, falses = [], []
    for i in range(4):
        true_val = torch.round(leftover[:, i] * acc[:, i])
        false_val = leftover[:, i] - true_val
        trues.append(true_val)
        falses.append(false_val)
        leftover = torch.where(cols == i, false_val[:, None], leftover)
        for k in range(bounds[i]):
            # an active env's total is at least false_val - k > 0; an
            # inactive one's (maybe 0/0) draw is discarded
            active = (false_val > k)[:, None]
            total = leftover.sum(dim=1, keepdim=True)
            sel = R._choice_from_u(leftover / total, u_all.gather(1, ptr))
            leftover = leftover - ((cols == sel[:, None]) & active).to(F64)
            ptr = ptr + active
    if n_draws:
        g = R._advance(g, hi, lo, ptr[:, 0])
    true_arr = torch.stack(trues, dim=1).to(I32)
    false_arr = torch.stack(falses, dim=1).to(I32)
    leftover = leftover.to(I32)

    e_input = leftover.sum(dim=1, dtype=I32)
    total_output = (true_arr.sum(dim=1, dtype=I32)
                    + false_arr.sum(dim=1, dtype=I32) + e_input)
    discrepancy = total_input - total_output
    e_input = e_input + discrepancy.clamp(-1, 1)
    err = (discrepancy.abs() > 1).to(I32)

    cont_true = st.cont_true + torch.cat([true_arr, e_input[:, None]], 1)
    cont_false = st.cont_false + false_arr
    true_sum = true_arr.sum(dim=1, dtype=I32)
    mean_purity = torch.where(
        total_input > 0,
        np_round2(1.0 - (total_input - true_sum).to(F64)
                  / total_input.clamp(min=1).to(F64)),
        0.0)
    return mean_purity, st._replace(cont_true=cont_true,
                                    cont_false=cont_false, rng=g,
                                    error_flag=st.error_flag + err)


# ---------------------------------------------------------------------------
# Presses & bales
# ---------------------------------------------------------------------------

def bale_quality_int(q: torch.Tensor) -> torch.Tensor:
    """A bale's quality ``int(q * 100)``: truncation toward zero."""
    return (q * 100.0).to(I32)


def _press_bale(cfg: SimConfig, st: EnvState, m, n, q_int):
    """Each env's bales of material ``m`` after pressing ``n`` units of
    integer quality ``q_int``: ``n // balesize`` full bales of (balesize,
    q_int); a remainder above threshold*balesize becomes its own bale,
    otherwise it merges into the last one (or opens one if the list is
    empty).  Returns (bale_size, bale_qual, bale_cnt)."""
    bs = cfg.effective_balesize
    full = n // bs
    rem = n % bs
    sel = _onehot(m, 5)
    mb = cfg.max_bales
    row_size = st.bale_size.gather(
        1, _idx(m)[:, None, None].expand(-1, 1, mb))[:, 0]
    row_qual = st.bale_qual.gather(
        1, _idx(m)[:, None, None].expand(-1, 1, mb))[:, 0]
    cnt = _take(st.bale_cnt, m)

    idx = torch.arange(mb, dtype=I32, device=n.device)[None, :]
    cnt_c = cnt[:, None]
    new_mask = (idx >= cnt_c) & (idx < cnt_c + full[:, None])
    row_size = torch.where(new_mask, bs, row_size)
    row_qual = torch.where(new_mask, q_int[:, None], row_qual)
    cnt = cnt + full

    big_rem = rem.to(F64) > float(bs) * float(cfg.bale_remainder_threshold)
    has_rem = rem > 0
    own = has_rem & (big_rem | (cnt == 0))
    app_mask = own[:, None] & (idx == cnt[:, None])
    row_size = torch.where(app_mask, rem[:, None], row_size)
    row_qual = torch.where(app_mask, q_int[:, None], row_qual)
    merge = has_rem & ~big_rem & (cnt > 0)
    merge_mask = merge[:, None] & (idx == cnt[:, None] - 1)
    row_size = torch.where(merge_mask, row_size + rem[:, None], row_size)
    cnt = cnt + own.to(I32)

    return (torch.where(sel[:, :, None], row_size[:, None, :], st.bale_size),
            torch.where(sel[:, :, None], row_qual[:, None, :], st.bale_qual),
            torch.where(sel, cnt[:, None], st.bale_cnt))


def check_press_status(cfg: SimConfig, st: EnvState,
                       quality_int=bale_quality_int) -> EnvState:
    """Decrement busy press timers; on reaching zero, bale out and clear.
    Press 1 strictly before press 2 (the bale append order matters when
    both finish in the same step).  The bale update is skipped, after one
    host read, for a press that finishes in no env.  ``quality_int`` maps
    ``press_q`` to the bales' integer quality (the integer-exact engine
    stores cents and passes its own)."""
    busy = st.press_timer > 0
    timer = torch.where(busy, st.press_timer - 1, st.press_timer)
    done = busy & (timer == 0)
    flags = R.host_ints(done.any(dim=0))
    for p in range(2):
        if flags[p]:
            d = done[:, p]
            size, qual, cnt = _press_bale(
                cfg, st, st.press_mat[:, p], st.press_n[:, p],
                quality_int(st.press_q[:, p]))
            st = st._replace(
                bale_size=torch.where(d[:, None, None], size, st.bale_size),
                bale_qual=torch.where(d[:, None, None], qual, st.bale_qual),
                bale_cnt=torch.where(d[:, None], cnt, st.bale_cnt))
    return st._replace(
        press_timer=timer,
        press_mat=torch.where(done, 0, st.press_mat),
        press_n=torch.where(done, 0, st.press_n),
        press_q=torch.where(done, 0.0, st.press_q))


def _levels(st: EnvState) -> torch.Tensor:
    """Container levels A..D (true + false) and E (true): i32 [N, 5]."""
    return torch.cat([st.cont_true[:, :4] + st.cont_false,
                      st.cont_true[:, 4:5]], dim=1)


def _container_level(st: EnvState, m) -> torch.Tensor:
    """A..D: true+false; E: true only."""
    return _take(_levels(st), m)


def use_press(cfg: SimConfig, st: EnvState, press, m
              ) -> Tuple[torch.Tensor, EnvState]:
    """``press`` is 1 or 2, ``m`` 0..4 (i32 [N] each).  Returns the
    action-log code (i32): the discrete action if executed, 111/222 if
    the press was busy."""
    p = press - 1
    busy = _take(st.press_timer, p) > 0
    total = _container_level(st, m)
    true_m = torch.where(m < 4, _take(st.cont_true, m), total)
    quality = torch.where(
        (m < 4) & (total > 0),
        np_round2(true_m.to(F64) / total.clamp(min=1).to(F64)), 0.0)
    press_time = torch.where(press == 1, cfg.press_time_1,
                             cfg.press_time_2).to(I32)
    clear_false = (m < 4)[:, None] & _onehot(m.clamp(max=3), 4)
    started = st._replace(
        last_press_started=torch.ones_like(st.last_press_started),
        last_press_amount=total,
        cont_true=_put(st.cont_true, m, 0),
        cont_false=torch.where(clear_false, 0, st.cont_false),
        press_timer=_put(st.press_timer, p, press_time),
        press_mat=_put(st.press_mat, p, m),
        press_n=_put(st.press_n, p, total),
        press_q=_put(st.press_q, p, quality))
    blocked = st._replace(
        press_penalty_flag=torch.ones_like(st.press_penalty_flag))
    st = R.select(busy, blocked, started)
    code = torch.where(busy, torch.where(press == 1, 111, 222),
                       (press - 1) * 5 + m + 1)
    return code.to(I32), st


def press_action_rules(cfg: SimConfig, st: EnvState, press_id, m
                       ) -> Tuple[torch.Tensor, EnvState]:
    """Tick the press timers (always), then dispatch; ``press_id`` 0 is a
    no-op.  Returns the action-log code (0 for a no-op)."""
    st = check_press_status(cfg, st)
    code, used = use_press(cfg, st, press_id.clamp(min=1), m)
    noop = press_id == 0
    st = R.select(noop, st, used)
    return torch.where(noop, 0, code).to(I32), st


def check_container_level(cfg: SimConfig, st: EnvState):
    """Rule-based pressing: the first free press x the fullest non-empty
    container (ties -> the earliest of A..D; E only if strictly fuller).
    Returns (press_id, mat_idx), press_id 0 for none."""
    free1 = st.press_timer[:, 0] == 0
    free2 = st.press_timer[:, 1] == 0
    free_press = torch.where(free1, 1, torch.where(free2, 2, 0))
    levels_ad = st.cont_true[:, :4] + st.cont_false
    best_ad = torch.argmax(levels_ad, dim=1)     # first max
    best_lvl = _take(levels_ad, best_ad)
    lvl_e = st.cont_true[:, 4]
    best_idx = torch.where(lvl_e > best_lvl, 4, best_ad)
    best_lvl = torch.maximum(best_lvl, lvl_e)
    ok = (free_press > 0) & (best_lvl > 0)
    return (torch.where(ok, free_press, 0).to(I32),
            torch.where(ok, best_idx, 0).to(I32))


def press_action_masks(cfg: SimConfig, st: EnvState) -> torch.Tensor:
    """bool [N, 11]: index 0 always valid; (press p, container c) valid
    iff the press is idle and the level >= balesize."""
    enough = _levels(st) >= cfg.effective_balesize
    p1 = (st.press_timer[:, 0] == 0)[:, None]
    p2 = (st.press_timer[:, 1] == 0)[:, None]
    return torch.cat([torch.ones_like(p1), enough & p1, enough & p2], dim=1)


def monolith_action_masks(cfg: SimConfig, st: EnvState) -> torch.Tensor:
    m = press_action_masks(cfg, st)
    return torch.cat([m, m], dim=1)


def _kth_valid(mask: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The index of each row's (k+1)-th True entry."""
    csum = torch.cumsum(mask.to(I32), dim=1)
    return torch.argmax((csum == (k.to(I32) + 1)[:, None]).to(I32),
                        dim=1).to(I32)


def sample_masked_press_action(cfg: SimConfig, st: EnvState):
    """A uniform choice over the valid discrete press actions from
    rng_pressing (``integers(0, 1)`` consumes nothing when only the no-op
    is valid).  Returns (press_id, mat_idx, state)."""
    mask = press_action_masks(cfg, st)
    n_valid = mask.sum(dim=1)
    k, rng_pressing = R._lemire32(st.rng_pressing, n_valid - 1)
    press_id, mat = press_discrete_to_action(_kth_valid(mask, k))
    return press_id, mat, st._replace(rng_pressing=rng_pressing)


def press_discrete_to_action(a):
    """0 -> no-op; 1-5 -> press1 x A..E; 6-10 -> press2 x A..E."""
    a = a.to(I32)
    press_id = torch.where(a == 0, 0, torch.where(a <= 5, 1, 2)).to(I32)
    mat = torch.where(a == 0, 0, (a - 1) % 5).to(I32)
    return press_id, mat


def validate_press_action(cfg: SimConfig, st: EnvState, press_id, mat):
    """The no-op is always valid; a press must be idle and its container
    hold >= balesize."""
    busy = torch.where(press_id == 1, st.press_timer[:, 0] > 0,
                       torch.where(press_id == 2, st.press_timer[:, 1] > 0,
                                   False))
    ok = ~busy & (_container_level(st, mat) >= cfg.effective_balesize)
    return torch.where(press_id == 0, True, ok)


def sanitize_press_action(cfg: SimConfig, st: EnvState, a):
    """Invalid actions become no-ops; returns (press_id, mat, was_invalid,
    invalid_code 111/222/0)."""
    press_id, mat = press_discrete_to_action(a)
    valid = validate_press_action(cfg, st, press_id, mat)
    code = torch.where(valid, 0, torch.where(
        press_id == 1, 111, torch.where(press_id == 2, 222, 999))).to(I32)
    return (torch.where(valid, press_id, 0).to(I32),
            torch.where(valid, mat, 0).to(I32), ~valid, code)


def detect_overflow(cfg: SimConfig, st: EnvState) -> torch.Tensor:
    return (_levels(st) > cfg.container_capacity).any(dim=1)


# ---------------------------------------------------------------------------
# Observations & purity helpers
# ---------------------------------------------------------------------------

def container_purities(cfg: SimConfig, st: EnvState) -> torch.Tensor:
    """round(true/(true+false), 2) per A..D; empty -> quality threshold."""
    total = st.cont_true[:, :4] + st.cont_false
    purity = np_round2(st.cont_true[:, :4].to(F64)
                       / total.clamp(min=1).to(F64))
    return torch.where(total > 0, purity, float(cfg.quality_threshold))


def compute_purity_differences(cfg: SimConfig, st: EnvState):
    """round(purity - threshold, 2)."""
    return np_round2(container_purities(cfg, st)
                     - float(cfg.quality_threshold))


def get_sort_obs(cfg: SimConfig, st: EnvState) -> torch.Tensor:
    """f32 [N, 13]."""
    obs = torch.cat([st.belt_occupancy[:, None], _props(st.belt_counts),
                     st.acc_belt, compute_purity_differences(cfg, st)],
                    dim=1).to(torch.float32)
    return torch.clamp(obs, -1.0, 1.0)


def get_press_obs(cfg: SimConfig, st: EnvState) -> torch.Tensor:
    """f32 [N, 16]."""
    levels = _div(_levels(st).to(F64), float(cfg.container_capacity))
    sorter = _div(st.sort_counts.to(F64), float(cfg.stage_capacity))
    timers = _div(st.press_timer.to(F64),
                  (float(cfg.press_time_1), float(cfg.press_time_2)))
    obs = torch.cat([levels, levels, sorter, timers],
                    dim=1).to(torch.float32)
    return torch.clamp(obs, 0.0, 1.0)


def get_mono_obs(cfg: SimConfig, st: EnvState) -> torch.Tensor:
    return torch.cat([get_sort_obs(cfg, st), get_press_obs(cfg, st)], dim=1)


# ---------------------------------------------------------------------------
# Rewards
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _sorting_table(cfg: SimConfig):
    from . import reward_tables as RT

    try:
        return RT.build_sorting_table(cfg)
    except AssertionError:
        return None  # off-grid threshold: fall back to torch's tanh


@functools.lru_cache(maxsize=16)
def _sorting_table_on(cfg: SimConfig, device: str):
    tab = _sorting_table(cfg)
    if tab is None:
        return None
    return (torch.from_numpy(tab.scores).to(device=device, dtype=F64),
            torch.from_numpy(tab.rewards).to(device=device, dtype=F64))


def calculate_sorting_reward(cfg: SimConfig, st: EnvState) -> torch.Tensor:
    """tanh(mean(purity - theta) * 2.0 / 0.5), the score accumulated in
    material order, ((d0 + d1) + d2) + d3, as the reference's ``+=`` loop.

    The final ``np.tanh`` comes out of an exact host-built table
    (``reward_tables.build_sorting_table``): the score set is finite, so
    the reward is NumPy's own tanh output, bit for bit.  A quality
    threshold off the table's grid falls back to ``torch.tanh``, which
    agrees with NumPy's to a few ulp, not bitwise (held to 4 ulp)."""
    d = container_purities(cfg, st) - float(cfg.purity_threshold_theta)
    score = ((d[:, 0] + d[:, 1]) + d[:, 2]) + d[:, 3]
    tab = _sorting_table_on(cfg, str(score.device))
    if tab is not None:
        scores, rewards = tab
        k = torch.searchsorted(scores, score).clamp(0, rewards.shape[0] - 1)
        return rewards[k]
    raw = _div(score, 4.0) * float(cfg.purity_scaling_factor)
    return torch.tanh(_div(raw, float(cfg.tanh_temperature)))


def calculate_press_reward(cfg: SimConfig, st: EnvState
                           ) -> Tuple[torch.Tensor, EnvState]:
    """The press reward.  It resets the last-press flags (the reference
    mutates them inside the reward), hence the updated state."""
    levels = _levels(st)
    fill = _div(levels.to(F64), float(cfg.container_capacity))
    catastrophic = (fill > 1.0).any(dim=1)
    zero = torch.zeros_like(fill[:, 0])
    max_penalty = torch.where(
        (fill > 0.95).any(dim=1), float(cfg.overflow_penalty_severe),
        torch.where((fill > 0.90).any(dim=1),
                    float(cfg.overflow_penalty_mild), zero))

    # the reference sums integer levels, then divides once
    total_level = levels.sum(dim=1, dtype=I32).to(F64)
    overall = _div(total_level, float(5 * cfg.container_capacity))
    state_reward = overall * float(cfg.max_state_reward)

    bs = cfg.effective_balesize
    amount = st.last_press_amount
    num_bales = amount // bs
    rem = amount % bs
    dist = torch.minimum(rem, bs - rem)
    bef = float(cfg.bale_efficiency_factor)
    efficiency = (1.0 - 4.0 * _div(dist.to(F64), float(bs))) * bef
    peaks = _const((0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0), amount.device)
    bonus = peaks[_idx(num_bales.clamp(max=3))]
    action_reward = torch.where(st.last_press_started,
                                efficiency + (bonus - bef), 0.0)

    normal = torch.clamp(state_reward + action_reward, -1.0, 1.0)
    reward = torch.where(
        catastrophic, float(cfg.overflow_penalty_catastrophic),
        torch.where(max_penalty < 0.0, max_penalty, normal))
    hold = catastrophic | (max_penalty < 0.0)
    return reward, st._replace(
        last_press_started=st.last_press_started & hold,
        last_press_amount=torch.where(hold, st.last_press_amount, 0))
