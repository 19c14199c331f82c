"""The integer-exact engine: bit-exact trajectories without trusting
hardware f64, batched, in PyTorch.

The port of ``marl_sortingenv_tpu.core.exact_dynamics``.  It reuses the
parity engine's state machine (``core/dynamics.py``: the integer plant and
the PCG64 streams) and replaces every computation whose result depends on
hardware f64 rounding with the integer soft-float of ``core/softfloat.py``.
It covers the benchmark configuration ``noise_sorting = 0`` and the
reference's default ``noise = 0.05``:

* ``choice(p=...)`` in the redistribution loop: a soft-float cdf;
* the sorting true/false split: exact banker's rounding of ``t*3/4`` at
  noise 0 (accuracies exactly {0.75, 1.0}); at noise > 0 the full
  ``int(round(target * acc))`` through a soft-float product;
* the accuracy noise draw ``uniform(-n, +n, 4)`` (noise > 0): NumPy's
  separate mul and add roundings, then ``clip(base + noise, 0, 1)``, all
  in integers, the exact f64 accuracies carried as IEEE bit patterns in
  ``acc_belt_bits`` / ``acc_sorter_bits``;
* occupancy, purity and quality rounds: integer cents;
* observations: exact f32 from cents tables and soft-float divisions;
* rewards: signed soft-float, emitted as IEEE-754 bit patterns.

State convention (the JAX package's): ``input_occupancy``,
``belt_occupancy`` and ``press_q`` hold *cents* (67.0 for 0.67);
``to_parity_view`` converts for comparisons.

Every function is batch-first, one env per row, where the JAX package
``vmap``\\ s, and runs on the device of the state.  All arithmetic that
decides a trajectory is integer, so the card and the CPU agree bit for
bit with each other and with the JAX package.  The redistribution loop
runs for the batch with a mask per env; its length comes from one host
read per step (``rng.HOST_SYNCS``), as in the parity engine.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from . import dynamics as D
from . import rng as R
from . import softfloat as SF
from .state import EnvState
from ..config.config import SimConfig

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
F64 = torch.float64

# f32 tables: index k -> np.float32(np.float64(k) / den), built by NumPy,
# so they are authoritative for the reference's f64 -> f32 casts
_TABLES_NP = {
    "T100": (np.arange(501, dtype=np.float64) / 100.0).astype(np.float32),
    "T700": (np.arange(24001, dtype=np.float64) / 700.0).astype(np.float32),
    "T12": (np.arange(13, dtype=np.float64) / 12.0).astype(np.float32),
    "T15": (np.arange(16, dtype=np.float64) / 15.0).astype(np.float32),
    # powers of two of the f64 view of soft-float values (``_f64_view``)
    "POW2": np.ldexp(1.0, np.arange(-70, -39)),
}
_TABLES = {}


def _tab(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.from_numpy(_TABLES_NP[name]).to(device)
    return _TABLES[key]


def _lookup(name: str, k: torch.Tensor) -> torch.Tensor:
    """``table[k]`` with the index clamped into the table, as an XLA
    gather clamps it."""
    tab = _tab(name, k.device)
    return tab[k.to(I64).clamp(0, tab.shape[0] - 1)]


def _f64_view(m: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The f64 value of a soft-float, scaled by the clamped 2^e table as
    the JAX package scales it."""
    return m.to(F64) * _lookup("POW2", e.to(I64) + 70)


def _f32_cents(k: torch.Tensor) -> torch.Tensor:
    """f32 of k/100 from the table (k in [-500, 500], integer)."""
    v = _lookup("T100", k.abs())
    return torch.where(k < 0, -v, v)


def _draws64(g: R.PCG64State, k: int):
    """``k`` successive 64-bit draws of every stream (int64 [N, k]) and
    the state after them, by jump-ahead."""
    hi, lo, out = R._jump(g, k)
    return out, g._replace(state_hi=hi[:, -1].contiguous(),
                           state_lo=lo[:, -1].contiguous())


def choice_from_u53(avail: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The index ``Generator.choice(4, p=avail/total)`` picks for the draw
    ``u = raw >> 11`` (int64 [N]), with the f64 decisions of NumPy's cdf
    made in integers: p_j = avail_j / T correctly rounded, the cdf by
    sequential correctly-rounded adds, each entry divided by the last,
    ``searchsorted(cdf, u * 2^-53, side='right')``.  ``avail`` is int
    [N, 4]; int32 [N]."""
    T = avail.sum(dim=1, dtype=I64)
    ps = SF.sf_div_int(avail.to(I64), T[:, None])
    acc = SF.SFJ(ps.m[:, 0], ps.e[:, 0])
    cdf = [acc]
    for j in range(1, 4):
        acc = SF.sf_add(acc, SF.SFJ(ps.m[:, j], ps.e[:, j]))
        cdf.append(acc)
    last = cdf[3]
    cm = torch.stack([c.m for c in cdf], dim=1)
    ce = torch.stack([c.e for c in cdf], dim=1)
    cn = SF.sf_div(SF.SFJ(cm, ce), SF.SFJ(last.m[:, None], last.e[:, None]))
    return SF.sf_cmp_le_u53(cn, u[:, None]).sum(dim=1, dtype=I32)


def choice_p_exact(g: R.PCG64State, avail) -> Tuple[torch.Tensor,
                                                    R.PCG64State]:
    """Bit-exact ``Generator.choice(4, p=avail/total)`` without hardware
    f64: one 64-bit draw per stream, then ``choice_from_u53``."""
    raw, g = R.next_uint64(g)
    return choice_from_u53(avail, R._srl(raw, 11)), g


def _split_counts(target: torch.Tensor, boosted: torch.Tensor):
    """true_val = int(round(target * acc)) with acc in {0.75, 1.0}, in
    integers (the noise-0 split; a boosted 1.25 clips to 1.0)."""
    p = target.to(I64) * 3
    q, r = p // 4, p % 4
    r2 = 2 * r
    up = (r2 > 4) | ((r2 == 4) & ((q & 1) == 1))
    t075 = (q + up.to(I64)).to(I32)
    return torch.where(boosted, target, t075)


def _split_counts_bits(target: torch.Tensor, acc_bits: torch.Tensor):
    """true_val = int(round(target * acc)) for an f64 accuracy carried as
    IEEE bits (the noise > 0 split): exact int -> correctly-rounded f64
    product -> Python half-even round, all in integers."""
    prod = SF.sf_mul(SF.sf_from_int(target), SF.sf_from_bits(acc_bits))
    return SF.sf_round_int(prod).to(I32)


def _true_counts(cfg: SimConfig, st: EnvState, target: torch.Tensor,
                 cols=slice(None)):
    """The sorter's true count of ``target`` per station in ``cols``, on
    the DELAYED accuracies (the previous step's belt accuracies)."""
    if cfg.effective_noise != 0.0:
        return _split_counts_bits(target, st.acc_sorter_bits[:, cols])
    return _split_counts(target, st.acc_sorter[:, cols] >= 0.875)


def sort_material_exact(cfg: SimConfig, st: EnvState
                        ) -> Tuple[torch.Tensor, EnvState]:
    """Exact-mode sort_material: the integer split and the exact weighted
    choice.  Returns the mean purity as *cents* (int32 [N]).

    A station's false count is ``f(target)`` with ``f(t) = t - round(t *
    acc)``, which does not decrease in t, and the leftovers only fall; so
    ``f(sort_counts)`` bounds every station's loop, one host read fixes the
    loops' lengths and all draws come in one jump-ahead block that each env
    reads from its own position, as in ``dynamics.sort_material``."""
    sc = st.sort_counts
    n_env = sc.shape[0]
    bounds = R.host_ints((sc - _true_counts(cfg, st, sc)).amax(dim=0))
    total_input = sc.sum(dim=1, dtype=I32)
    g = st.rng
    n_draws = sum(bounds)
    if n_draws:
        hi, lo, out = R._jump(g, n_draws)
        u_all = R._srl(out, 11)
    ptr = torch.zeros((n_env, 1), dtype=I64, device=sc.device)
    cols = torch.arange(4, device=sc.device)
    leftover = sc
    trues, falses = [], []
    for i in range(4):
        target = leftover[:, i]
        true_val = _true_counts(cfg, st, target, i)
        false_val = target - true_val
        trues.append(true_val)
        falses.append(false_val)
        leftover = torch.where(cols == i, false_val[:, None], leftover)
        for k in range(bounds[i]):
            # an active env's leftover total is at least false_val - k > 0;
            # an inactive env's choice is discarded
            active = (false_val > k)[:, None]
            sel = choice_from_u53(leftover, u_all.gather(1, ptr)[:, 0])
            leftover = leftover - ((cols == sel[:, None]) & active).to(I32)
            ptr = ptr + active
    if n_draws:
        g = R._advance(g, hi, lo, ptr[:, 0])
    true_arr = torch.stack(trues, dim=1)
    false_arr = torch.stack(falses, dim=1)

    e_input = leftover.sum(dim=1, dtype=I32)
    cont_true = st.cont_true + torch.cat([true_arr, e_input[:, None]], 1)

    # mean purity cents: np_round2(1 - (total - true) / total)
    true_sum = true_arr.sum(dim=1, dtype=I32)
    ratio = SF.sf_div_int((total_input - true_sum).clamp(min=0),
                          total_input.clamp(min=1))
    purity_cents = torch.where(
        total_input > 0, SF.sf_cents(SF.sf_sub_from_one(ratio)).to(I32), 0)
    return purity_cents.to(I32), st._replace(
        cont_true=cont_true, cont_false=st.cont_false + false_arr, rng=g)


@functools.lru_cache(maxsize=8)
def _acc_consts(cfg: SimConfig):
    """Host constants of the accuracy-noise pipeline.  The reference
    builds the accuracies with Python float adds and ``high - low`` with a
    C double subtraction (``Generator.uniform``): both are replicated here
    on the host, in Python floats, through ``exact32_proto``."""
    from . import exact32_proto as P

    n = float(cfg.effective_noise)
    low = -n
    rng2 = P.sf_from_float(n - low)

    def sfs_const(v: float):
        s = P.sf_from_float(abs(v))
        sign = 0 if v == 0 else (1 if v > 0 else -1)
        return (sign, s.m, s.e)

    def clip_bits(v: float) -> int:
        return int(np.float64(min(max(v, 0.0), 1.0)).view(np.int64))

    base = [float(b) for b in cfg.baseline_accuracy]
    boosted = [b + float(cfg.boost) for b in base]
    return (sfs_const(low), (rng2.m, rng2.e),
            tuple(sfs_const(v) for v in base),
            tuple(sfs_const(v) for v in boosted),
            tuple(clip_bits(v) for v in base),
            tuple(clip_bits(v) for v in boosted))


def _boosted_mask(sensor_setting: torch.Tensor) -> torch.Tensor:
    """bool [N, 4]: mode 0 boosts A and C (even stations), mode 1 B and D;
    any other mode boosts nothing."""
    odd = (torch.arange(4, device=sensor_setting.device) % 2) == 1
    s = sensor_setting[:, None]
    return torch.where(s == 0, ~odd, torch.where(s == 1, odd, False))


def update_accuracy_exact(cfg: SimConfig, st: EnvState) -> EnvState:
    """Exact update_accuracy.

    noise = 0: the 4 uniform draws are consumed (stream parity) but their
    values are exactly 0; the accuracies are {0.75, 1.0} after the clip.

    noise > 0: each draw is ``low + (high-low) * next_double`` with NumPy's
    separate mul and add roundings, then ``clip(acc + noise, 0, 1)``, in
    the integer soft-float, the exact f64 values stored as IEEE bits in
    ``acc_belt_bits`` (and an f64 view in ``acc_belt``)."""
    dev = st.current_step.device
    (low_c, rng2_c, base_c, boost_c,
     base_bits, boost_bits) = _acc_consts(cfg)
    out, g = _draws64(st.rng_noise, 4)
    boosted = _boosted_mask(st.sensor_setting)

    if cfg.effective_noise == 0.0:
        b = cfg.boost
        base = D._const(tuple(cfg.baseline_accuracy), dev)
        acc = base + torch.where(
            st.sensor_setting[:, None] == 0, D._const((b, 0.0, b, 0.0), dev),
            torch.where(st.sensor_setting[:, None] == 1,
                        D._const((0.0, b, 0.0, b), dev),
                        D._const((0.0,) * 4, dev)))
        acc = torch.clamp(acc, 0.0, 1.0)
        # cached constants: a host-to-device copy per step would wait for
        # the card each time
        bits = torch.where(boosted, D._const(boost_bits, dev, I64),
                           D._const(base_bits, dev, I64))
        return st._replace(acc_belt=acc, acc_belt_bits=bits, rng_noise=g)

    low = _sfs_const(low_c, dev)
    rng2 = SF.SFJ(D._const(rng2_c[0], dev, I64), D._const(rng2_c[1], dev, I32))
    d = SF.sf_from_u53(R._srl(out, 11))
    noise_v = SF.sfs_add(low, SF.sfs_of(SF.sf_mul(rng2, d)))
    acc_c = SF.sfs_where(boosted, _sfs_const(zip(*boost_c), dev),
                         _sfs_const(zip(*base_c), dev))
    acc = SF.sfs_add(acc_c, noise_v)
    # np.clip(x, 0, 1): non-positive -> +0, above one -> 1.0
    nonpos = acc.s <= 0
    over = (acc.e > -52) | ((acc.e == -52) & (acc.m > SF.MLOW))
    m = torch.where(nonpos, 0, torch.where(over, SF.MLOW, acc.m))
    e = torch.where(nonpos, 0, torch.where(over, -52, acc.e)).to(I32)
    return st._replace(acc_belt=_f64_view(m, e),
                       acc_belt_bits=SF.sf_to_bits(SF.SFJ(m, e)),
                       rng_noise=g)


def update_environment_exact(cfg: SimConfig, st: EnvState) -> EnvState:
    """The material flow, the occupancy stored as cents."""
    st = st._replace(sort_counts=st.belt_counts,
                     belt_counts=st.input_counts,
                     belt_occupancy=st.input_occupancy)  # cents flow on
    counts, st = D.generate_input(cfg, st)
    total = counts.sum(dim=1, dtype=I32)
    # occupancy cents: py_round2(k/100) == k cents for k <= 400
    return st._replace(
        input_counts=counts,
        input_occupancy=total.to(F64),
        acc_sorter=st.acc_belt,
        acc_sorter_bits=st.acc_belt_bits,
        total_input_units=st.total_input_units + total)


def container_purity_cents(cfg: SimConfig, st: EnvState) -> torch.Tensor:
    """np_round2(true / (true + false)) in cents per A..D; an empty
    container gives the threshold's cents.  int32 [N, 4]."""
    true4 = st.cont_true[:, :4]
    total = true4 + st.cont_false
    cents = SF.sf_cents(SF.sf_div_int(true4, total.clamp(min=1))).to(I32)
    thr = int(round(cfg.quality_threshold * 100))
    return torch.where(total > 0, cents, thr).to(I32)


def get_sort_obs_exact(cfg: SimConfig, st: EnvState) -> torch.Tensor:
    """f32 [N, 13]."""
    total = st.belt_counts.sum(dim=1, dtype=I32)
    props = SF.sf_to_f32(SF.sf_div_int(st.belt_counts,
                                       total.clamp(min=1)[:, None]))
    props = torch.where((total > 0)[:, None], props, 0.0)
    diffs = _f32_cents(container_purity_cents(cfg, st) - 90)
    occ = _f32_cents(st.belt_occupancy.to(I32))
    if cfg.effective_noise == 0.0:
        # the accuracies are exactly {0.75, 1.0}: the f64 view is exact
        acc_f32 = st.acc_belt.to(F32)
    else:
        acc_f32 = SF.sf_to_f32(SF.sf_from_bits(st.acc_belt_bits))
    obs = torch.cat([occ[:, None], props, acc_f32, diffs], dim=1)
    return torch.clamp(obs, -1.0, 1.0)


def get_press_obs_exact(cfg: SimConfig, st: EnvState) -> torch.Tensor:
    """f32 [N, 16]."""
    lv = _lookup("T700", D._levels(st).clamp(0, 24000))
    sorter = _lookup("T100", st.sort_counts.clamp(0, 500))
    t1 = _lookup("T12", st.press_timer[:, 0].clamp(0, 12))
    t2 = _lookup("T15", st.press_timer[:, 1].clamp(0, 15))
    obs = torch.cat([lv, lv, sorter, t1[:, None], t2[:, None]], dim=1)
    return torch.clamp(obs, 0.0, 1.0)


def get_mono_obs_exact(cfg: SimConfig, st: EnvState) -> torch.Tensor:
    return torch.cat([get_sort_obs_exact(cfg, st),
                      get_press_obs_exact(cfg, st)], dim=1)


def use_press_exact(cfg: SimConfig, st: EnvState, press, m
                    ) -> Tuple[torch.Tensor, EnvState]:
    """``dynamics.use_press`` with the quality stored as cents."""
    p = press - 1
    busy = D._take(st.press_timer, p) > 0
    total = D._container_level(st, m)
    true_m = torch.where(m < 4, D._take(st.cont_true, m), total)
    q_cents = torch.where(
        (m < 4) & (total > 0),
        SF.sf_cents(SF.sf_div_int(true_m, total.clamp(min=1))), 0)
    press_time = torch.where(press == 1, cfg.press_time_1,
                             cfg.press_time_2).to(I32)
    clear_false = (m < 4)[:, None] & D._onehot(m.clamp(max=3), 4)
    started = st._replace(
        last_press_started=torch.ones_like(st.last_press_started),
        last_press_amount=total.to(I32),
        cont_true=D._put(st.cont_true, m, 0),
        cont_false=torch.where(clear_false, 0, st.cont_false),
        press_timer=D._put(st.press_timer, p, press_time),
        press_mat=D._put(st.press_mat, p, m),
        press_n=D._put(st.press_n, p, total.to(I32)),
        press_q=D._put(st.press_q, p, q_cents.to(F64)))
    blocked = st._replace(
        press_penalty_flag=torch.ones_like(st.press_penalty_flag))
    st = R.select(busy, blocked, started)
    code = torch.where(busy, torch.where(press == 1, 111, 222),
                       (press - 1) * 5 + m + 1)
    return code.to(I32), st


def bale_quality_int_exact(q_cents: torch.Tensor) -> torch.Tensor:
    """``int(q * 100)`` where q is the f64 of cents/100: the truncation of
    the f64-rounded product, both roundings in integers.  int32."""
    x = SF.sf_div_int(q_cents.to(I32), 100)
    pm, e = SF._f64_round_times100(x.m, x.e)
    neg = e < 0
    s2 = torch.where(neg, -e, 0).clamp(0, 63)
    q_out = torch.where(neg, pm >> s2, pm << e.clamp(min=0))
    return torch.where(x.m == 0, 0, q_out).to(I32)


def check_press_status_exact(cfg: SimConfig, st: EnvState) -> EnvState:
    return D.check_press_status(cfg, st, bale_quality_int_exact)


def press_action_rules_exact(cfg: SimConfig, st: EnvState, press_id, m):
    """Tick the press timers, then dispatch; ``press_id`` 0 is a no-op."""
    st = check_press_status_exact(cfg, st)
    code, used = use_press_exact(cfg, st, press_id.clamp(min=1), m)
    noop = press_id == 0
    st = R.select(noop, st, used)
    return torch.where(noop, 0, code).to(I32), st


# ---------------------------------------------------------------------------
# Exact rewards: no f64 arithmetic on the device.  The sorting reward
# comes from the finite-domain lookup (reward_tables.py, NumPy's own tanh
# outputs); the press reward decomposes into integer cutoffs, one soft-
# float integer division, a host-enumerated action table and one
# correctly-rounded signed add.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _sort_tab_exact(cfg: SimConfig):
    from . import reward_tables as RT

    t = RT.build_sorting_table(cfg)
    return (t.idx2, t.idx3, t.idx4, t.reward_sign, t.reward_m, t.reward_e)


@functools.lru_cache(maxsize=4)
def _press_tab_exact(cfg: SimConfig):
    from . import reward_tables as RT

    # the exact engine supports the reference's 0.5 exactly (an exponent
    # decrement); any other value would need a general multiply
    if cfg.max_state_reward != 0.5:
        raise ValueError("the exact press reward needs max_state_reward 0.5")
    # the exact path keys the penalty on overflow *presence* and prefers
    # the severe constant: equal to the reference's accumulation only when
    # the penalties are ordered and negative
    if not (cfg.overflow_penalty_catastrophic <= cfg.overflow_penalty_severe
            <= cfg.overflow_penalty_mild < 0):
        raise ValueError("the exact press reward needs overflow penalties "
                         "catastrophic <= severe <= mild < 0")
    t = RT.build_press_table(cfg)

    def const(v):
        s, m, e = RT._decompose(np.asarray([v], np.float64))
        return (int(s[0]), int(m[0]), int(e[0]))

    return (t.cut_catastrophic, t.cut_severe, t.cut_mild,
            t.action_sign, t.action_m, t.action_e,
            const(cfg.overflow_penalty_catastrophic),
            const(cfg.overflow_penalty_severe),
            const(cfg.overflow_penalty_mild))


@functools.lru_cache(maxsize=16)
def _tables_on(cfg: SimConfig, which: str, device: str):
    """The reward tables as int tensors on ``device`` (u64 mantissas as
    int64 bit patterns)."""
    tabs = _sort_tab_exact(cfg) if which == "sort" else \
        _press_tab_exact(cfg)[3:6]
    out = []
    for a in tabs:
        a = np.asarray(a)
        if a.dtype == np.uint64:
            a = a.view(np.int64)
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return tuple(out)


def calculate_sorting_reward_exact(cfg: SimConfig, st: EnvState) -> SF.SFS:
    """The bit-exact sorting reward from the purity cents, through the
    finite-domain table."""
    idx2, idx3, idx4, s, m, e = _tables_on(cfg, "sort",
                                           str(st.cont_true.device))
    c = container_purity_cents(cfg, st).to(I64)
    k = idx4[idx3[idx2[c[:, 0], c[:, 1]].to(I64), c[:, 2]].to(I64), c[:, 3]]
    k = k.to(I64)
    return SF.SFS(s[k].to(I32), m[k].to(I64), e[k].to(I32))


def _sfs_const(c, device) -> SF.SFS:
    """A cached signed soft-float constant from host (s, m, e): scalars,
    or tuples for a row of constants."""
    s, m, e = c
    return SF.SFS(D._const(s, device, I32), D._const(m, device, I64),
                  D._const(e, device, I32))


def calculate_press_reward_exact(cfg: SimConfig, st: EnvState
                                 ) -> Tuple[SF.SFS, EnvState]:
    """The bit-exact press reward in integers and soft-float, with the
    flag-reset semantics of ``dynamics.calculate_press_reward``."""
    dev = st.cont_true.device
    (cut_cat, cut_sev, cut_mild, _, _, _,
     c_cat, c_sev, c_mild) = _press_tab_exact(cfg)
    asign, am, ae = _tables_on(cfg, "press", str(dev))

    levels = D._levels(st)
    catastrophic = (levels >= cut_cat).any(dim=1)
    severe = (levels >= cut_sev).any(dim=1)
    mild = (levels >= cut_mild).any(dim=1)

    total = levels.sum(dim=1, dtype=I64)
    overall = SF.sf_div_int(total, 5 * cfg.container_capacity)
    # * max_state_reward (0.5): an exact exponent decrement
    state = SF.SFJ(overall.m, overall.e - 1)

    bs = cfg.effective_balesize
    amount = st.last_press_amount.to(I64)
    rem = amount % bs
    dist = torch.minimum(rem, bs - rem)
    nb = torch.clamp(amount // bs, max=3)
    action = SF.SFS(asign[dist, nb].to(I32), am[dist, nb].to(I64),
                    ae[dist, nb].to(I32))
    zero = SF.sfs_zero(dev)
    action = SF.sfs_where(st.last_press_started, action, zero)

    normal = SF.sfs_clip1(SF.sfs_add(SF.sfs_of(state), action))
    penalized = SF.sfs_where(severe, _sfs_const(c_sev, dev),
                             _sfs_const(c_mild, dev))
    reward = SF.sfs_where(
        catastrophic, _sfs_const(c_cat, dev),
        SF.sfs_where(severe | mild, penalized, normal))
    reward = SF.SFS(*(x.expand(total.shape) for x in reward))

    keep = catastrophic | severe | mild
    return reward, st._replace(
        last_press_started=st.last_press_started & keep,
        last_press_amount=torch.where(keep, st.last_press_amount, 0))


# ---------------------------------------------------------------------------
# Steps.  Each returns (state, out), ``out`` the JAX package's dict:
# obs, terminated, action, purity_cents, press_log, reward_bits (IEEE bits
# as int64), the monolith's sort/press reward bits, and reward_sfs.
# ---------------------------------------------------------------------------

def _exact_prelude(cfg: SimConfig, st: EnvState) -> EnvState:
    return update_environment_exact(cfg, D.input_action_rules(cfg, st))


def _exact_apply_sort(cfg: SimConfig, st: EnvState, sort_mode):
    st = st._replace(sensor_setting=sort_mode.to(I32))
    st = update_accuracy_exact(cfg, st)
    return sort_material_exact(cfg, st)


def _finish(cfg: SimConfig, st: EnvState):
    st = st._replace(current_step=st.current_step + 1)
    return st, st.current_step >= cfg.max_steps


def _mono_rewards(cfg, st):
    sort_reward = calculate_sorting_reward_exact(cfg, st)
    press_reward, st = calculate_press_reward_exact(cfg, st)
    return st, sort_reward, press_reward, SF.sfs_add(sort_reward,
                                                     press_reward)


def _mono_out(cfg, st, action, purity_cents, log, sort_reward,
              press_reward, reward):
    obs = get_mono_obs_exact(cfg, st)
    st, terminated = _finish(cfg, st)
    return st, {
        "obs": obs,
        "terminated": terminated,
        "action": action.to(I32),
        "purity_cents": purity_cents,
        "press_log": log.to(I32),
        "reward_bits": SF.sfs_to_bits(reward),
        "sort_reward_bits": SF.sfs_to_bits(sort_reward),
        "press_reward_bits": SF.sfs_to_bits(press_reward),
        "reward_sfs": reward,
    }


def _as_action(action, st: EnvState) -> torch.Tensor:
    """The action as int32 [N]; a Python int is filled in on the device."""
    like = st.current_step
    if not isinstance(action, torch.Tensor):
        return torch.full(like.shape, int(action), dtype=I32,
                          device=like.device)
    return action.to(device=like.device, dtype=I32).expand(like.shape)


def step_mono_rule_exact(cfg: SimConfig, st: EnvState):
    """The exact equivalent of ``step.step_mono_rule``, with bit-exact
    rewards (emitted as IEEE-754 bit patterns)."""
    st = _exact_prelude(cfg, st)
    sort_mode = D.sorting_rules(st)
    press_id, mat = D.check_container_level(cfg, st)
    purity_cents, st = _exact_apply_sort(cfg, st, sort_mode)
    log, st = press_action_rules_exact(cfg, st, press_id, mat)
    st, sr, pr, reward = _mono_rewards(cfg, st)
    flat = sort_mode * 11 + torch.where(press_id == 0, 0,
                                        (press_id - 1) * 5 + mat + 1)
    return _mono_out(cfg, st, flat, purity_cents, log, sr, pr, reward)


def step_sort_exact(cfg: SimConfig, st: EnvState, action):
    """The exact Env_1_Sorting step: the agent's sort mode, a random
    *masked* press action from rng_pressing, the sorting reward only."""
    a = _as_action(action, st)
    st = _exact_prelude(cfg, st)
    purity_cents, st = _exact_apply_sort(cfg, st, a)
    press_id, mat, st = D.sample_masked_press_action(cfg, st)
    log, st = press_action_rules_exact(cfg, st, press_id, mat)
    reward = calculate_sorting_reward_exact(cfg, st)
    obs = get_sort_obs_exact(cfg, st)
    st, terminated = _finish(cfg, st)
    return st, {"obs": obs, "terminated": terminated, "action": a,
                "purity_cents": purity_cents, "press_log": log,
                "reward_bits": SF.sfs_to_bits(reward), "reward_sfs": reward}


def _press_tail(cfg, st, a, purity_cents, use_action_masking, extra=None):
    """The Env_2_Pressing step after its sort side: the agent's press
    action (sanitized when masking is off) and the press reward."""
    if use_action_masking:
        press_id, mat = D.press_discrete_to_action(a)
        log, st = press_action_rules_exact(cfg, st, press_id, mat)
    else:
        press_id, mat, _, invalid_code = D.sanitize_press_action(cfg, st, a)
        log, st = press_action_rules_exact(cfg, st, press_id, mat)
        log = torch.where(invalid_code != 0, invalid_code, log)
    reward, st = calculate_press_reward_exact(cfg, st)
    obs = get_press_obs_exact(cfg, st)
    st, terminated = _finish(cfg, st)
    out = {"obs": obs, "terminated": terminated, "action": a}
    out.update(extra or {})
    out.update({"purity_cents": purity_cents, "press_log": log.to(I32),
                "reward_bits": SF.sfs_to_bits(reward), "reward_sfs": reward})
    return st, out


def step_press_exact(cfg: SimConfig, st: EnvState, action,
                     use_action_masking: bool = True):
    """The exact Env_2_Pressing step with the rule-based sort side."""
    a = _as_action(action, st)
    st = _exact_prelude(cfg, st)
    purity_cents, st = _exact_apply_sort(cfg, st, D.sorting_rules(st))
    return _press_tail(cfg, st, a, purity_cents, use_action_masking)


def _mono_flat(cfg, st, a, use_action_masking):
    """Decode a flat monolith action and run it; without masking an
    invalid press part is sanitized and skips press_action_rules entirely
    (the press timers do not tick), logging its code."""
    sort_mode, press_disc = a // 11, a % 11
    if use_action_masking:
        press_id, mat = D.press_discrete_to_action(press_disc)
        skip = None
    else:
        press_id, mat, skip, inv_code = D.sanitize_press_action(
            cfg, st, press_disc)
    purity_cents, st = _exact_apply_sort(cfg, st, sort_mode)
    log, dispatched = press_action_rules_exact(cfg, st, press_id, mat)
    if skip is None:
        st = dispatched
    else:
        st = R.select(skip, st, dispatched)
        log = torch.where(skip, inv_code, log)
    st, sr, pr, reward = _mono_rewards(cfg, st)
    return _mono_out(cfg, st, a, purity_cents, log, sr, pr, reward)


def step_mono_external_exact(cfg: SimConfig, st: EnvState, action,
                             use_action_masking: bool = True):
    """The exact external-action monolith step, with the sanitize quirk."""
    a = _as_action(action, st)
    st = _exact_prelude(cfg, st)
    return _mono_flat(cfg, st, a, use_action_masking)


def step_mono_random_exact(cfg: SimConfig, st: EnvState, lr,
                           use_action_masking: bool = True):
    """The exact monolith ``mode='random'`` step: the legacy global
    MT19937 draws (``legacy_random.MTState`` ``lr``) and the masks are
    integers.  Returns (state, lr, out)."""
    from . import legacy_random as LR

    st = _exact_prelude(cfg, st)
    if use_action_masking:
        mask = D.monolith_action_masks(cfg, st)
        k, lr = LR.legacy_randint(lr, mask.sum(dim=1))
        a = D._kth_valid(mask, k)
    else:
        a, lr = LR.legacy_randint(lr, 22)
    st, out = _mono_flat(cfg, st, a, use_action_masking)
    return st, lr, out


def step_press_model_exact(cfg: SimConfig, st: EnvState, action, q_sort,
                           use_action_masking: bool = True):
    """The exact Env_2_Pressing step with the frozen sorting agent as an
    integer policy (``mlp_exact.QPolicy``) on the exact engine's f32 sort
    observation."""
    from ..models import mlp_exact as MX

    a = _as_action(action, st)
    st = _exact_prelude(cfg, st)
    sort_mode = MX.predict_deterministic_q(q_sort, get_sort_obs_exact(cfg, st))
    purity_cents, st = _exact_apply_sort(cfg, st, sort_mode)
    return _press_tail(cfg, st, a, purity_cents, use_action_masking,
                       {"sort_mode": sort_mode})


def step_mono_model_exact(cfg: SimConfig, st: EnvState, q_sort=None,
                          q_press=None, use_action_masking: bool = True):
    """The exact monolith 'model' path: modular integer-policy agents with
    the reference's random fallbacks (rng_sorting / rng_pressing).  The
    PPO Sort-Only and PPO Modular benchmark scenarios run through it."""
    from ..models import mlp_exact as MX

    st = _exact_prelude(cfg, st)
    if q_sort is not None:
        sort_mode = MX.predict_deterministic_q(q_sort,
                                               get_sort_obs_exact(cfg, st))
    else:
        # fallback: rng_sorting.choice([0, 1])
        idx, rs = R.choice_n(st.rng_sorting, 2)
        sort_mode = idx.to(I32)
        st = st._replace(rng_sorting=rs)

    if q_press is not None:
        press_obs = get_press_obs_exact(cfg, st)
        mask = D.press_action_masks(cfg, st) if use_action_masking else None
        press_disc = MX.predict_deterministic_q(q_press, press_obs, mask)
    else:
        if use_action_masking:
            # rng_pressing.choice(valid)
            mask = D.press_action_masks(cfg, st)
            k, rp = R._lemire32(st.rng_pressing, mask.sum(dim=1) - 1)
            press_disc = D._kth_valid(mask, k)
        else:
            k, rp = R.choice_n(st.rng_pressing, 11)
            press_disc = k.to(I32)
        st = st._replace(rng_pressing=rp)

    press_id, mat = D.press_discrete_to_action(press_disc)
    purity_cents, st = _exact_apply_sort(cfg, st, sort_mode)
    log, st = press_action_rules_exact(cfg, st, press_id, mat)
    st, sr, pr, reward = _mono_rewards(cfg, st)
    return _mono_out(cfg, st, sort_mode * 11 + press_disc, purity_cents, log,
                     sr, pr, reward)


def step_mono_policy_exact(cfg: SimConfig, st: EnvState, q_mono,
                           use_action_masking: bool = True):
    """The exact monolith-agent benchmark step: the integer policy
    predicts on the PRE-step observation (masked iff masking is on) and
    the flat action goes through the external path."""
    from ..models import mlp_exact as MX

    obs = get_mono_obs_exact(cfg, st)
    mask = D.monolith_action_masks(cfg, st) if use_action_masking else None
    flat = MX.predict_deterministic_q(q_mono, obs, mask)
    return step_mono_external_exact(cfg, st, flat, use_action_masking)


def rollout_rule_exact(cfg: SimConfig, st: EnvState, steps: int):
    """A rule-based episode with the cumulative return summed in signed
    soft-float (the reference's left-to-right Python-float sum).  Returns
    (state, outs stacked on a leading step axis, without ``reward_sfs``,
    the return's IEEE bits as int64 [N])."""
    acc = SF.sfs_zero(st.current_step.device)
    acc = SF.SFS(*(x.expand(st.current_step.shape) for x in acc))
    outs = []
    for _ in range(steps):
        st, out = step_mono_rule_exact(cfg, st)
        acc = SF.sfs_add(acc, out.pop("reward_sfs"))
        outs.append(out)
    stacked = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    return st, stacked, SF.sfs_to_bits(acc)


def to_parity_view(st: EnvState) -> dict:
    """The exact-mode fields (cents) in parity-engine terms, as numpy, for
    comparisons; the accuracies' IEEE bits as uint64 (decode with
    ``.view(np.float64)``)."""
    def a(x):
        return x.detach().cpu().numpy()

    return {
        "cont_true": a(st.cont_true),
        "cont_false": a(st.cont_false),
        "press_timer": a(st.press_timer),
        "press_n": a(st.press_n),
        "press_q_cents": a(st.press_q),
        "input_occupancy_cents": a(st.input_occupancy),
        "bale_size": a(st.bale_size),
        "bale_qual": a(st.bale_qual),
        "bale_cnt": a(st.bale_cnt),
        "current_step": a(st.current_step),
        "acc_belt_bits": a(st.acc_belt_bits).view(np.uint64),
        "acc_sorter_bits": a(st.acc_sorter_bits).view(np.uint64),
    }
