"""Batch-last fast engine in PyTorch, in both bale modes.

The port of ``marl_sortingenv_tpu.core.fastb``: the same dynamics, the
same threefry key chain (``core/threefry.py``) and the same float
association, so that for matching keys the two packages produce
bit-identical trajectories on the CPU (``tests/test_torch_fastb*.py``).
Every state leaf keeps the env batch on its LAST axis; ``key`` is
``int32[N, 2]`` holding the u32 threefry words.  ``cfg.bale_mode`` picks the
bale representation at reset: "events" ("auto") keeps an (E, N) log of
finished presses, "full" the (5, MAX, N) bale buffers; a step follows the
state it is given.

Dispatch follows the state's device and bale mode.  On CUDA an events-mode
step without a policy in it goes through the hand-written step kernel
(``ops/step_cuda.py``).  Every other step (full-bale mode, which the step
kernel does not carry, as in JAX; the press step with a frozen sort agent;
``step_mono_model`` and ``step_mono_random``) runs the eager body with its
sorting core on the sorting-core kernel (``ops/sort_cuda.py``).  On the CPU
every step runs the eager bodies below and launches nothing.  The eager
bodies also run on CUDA as the kernels' plain versions
(``step_cuda.step_mono_plain``, ``eager_step``), and then launch no kernel
either.

A step is replayed rather than dispatched where the evaluation runs it
(``eval/harness.policy_steps``, engine ``fastb``): on CUDA the Random,
PPO Sort-Only and PPO Modular steps (``step_mono_random`` and
``step_mono_model``, the eager bodies with kernel 2) are captured once per
step function, configuration, batch, device and agents into a CUDA graph
(``graphed_step``), which each step then replays with the same kernels and
the same bits.  The learner's rollout (``learn/ppo.py``, ``GraphedRollout``)
likewise replays its whole step, policy included, on CUDA.  Every other
step, and every step on the CPU, is dispatched op by op as above.

Float constants enter as device tensors, never as Python scalars in a
division: PyTorch's CUDA ``a / scalar`` multiplies by the reciprocal,
which would break the bitwise contract between CPU and CUDA.  They come
from the package's cache of constants (``const``), made once per value and
device: a blocking host-to-device copy per step would hold the host, and
a CUDA graph's capture refuses it.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import const, resolve_device
from ..config.config import SimConfig
from ..utils import profiling
from . import threefry as TF

I32 = torch.int32
I16 = torch.int16
F32 = torch.float32

_P0 = (0.40, 0.15, 0.35, 0.10)
_P1 = (0.15, 0.40, 0.10, 0.35)

_HG_SUPPORT = 104  # worst-case cap (= the JAX engines' cap)


def _support_for(cfg: SimConfig) -> int:
    """Static support bound for one hypergeometric draw.

    Every draw in the redistribution is n = false_val of one station,
    where false_val = target - rint(target*acc) <= target*(1-acc) + 0.5,
    acc >= min(baseline_accuracy) - noise, and target <= floor(0.4 *
    batch) + remainder.  Lanes past the bound carry zero probability, so
    the sampled value does not depend on the support beyond it."""
    bs = cfg.input_batch_size
    max_target = int(0.40 * bs) + 4
    min_acc = max(0.0, min(cfg.baseline_accuracy) - cfg.effective_noise)
    max_false = int(max_target * (1.0 - min_acc) + 0.5) + 1
    s = max(8, -(-(max_false + 2) // 8) * 8)
    if s > _HG_SUPPORT:
        raise ValueError(
            f"hypergeometric support {s} exceeds the engine cap "
            f"{_HG_SUPPORT}: config (input_batch_size="
            f"{cfg.input_batch_size}, min baseline_accuracy - noise = "
            f"{min_acc:.3f}) is outside the fast engines' sampling "
            "domain; truncating the pmf would silently corrupt the "
            "distribution")
    return s


class BState(NamedTuple):
    """Env state with the env batch on the last axis.  In events bale mode
    ``bale_*`` are None, in full mode ``ev_*``."""
    input_counts: torch.Tensor   # i32[4, N]
    belt_counts: torch.Tensor    # i32[4, N]
    sort_counts: torch.Tensor    # i32[4, N]
    acc_belt: torch.Tensor       # f32[4, N]
    acc_sorter: torch.Tensor     # f32[4, N]
    sensor_setting: torch.Tensor  # i32[N]
    input_occupancy: torch.Tensor  # f32[N]
    belt_occupancy: torch.Tensor   # f32[N]
    cont_true: torch.Tensor      # i32[5, N]
    cont_false: torch.Tensor     # i32[4, N]
    press_timer: torch.Tensor    # i32[2, N]
    press_mat: torch.Tensor      # i32[2, N]
    press_n: torch.Tensor        # i32[2, N]
    press_q: torch.Tensor        # f32[2, N]
    bale_size: Optional[torch.Tensor]  # i16[5, MAX, N]
    bale_qual: Optional[torch.Tensor]  # i16[5, MAX, N]
    bale_cnt: Optional[torch.Tensor]   # i32[5, N]
    last_press_started: torch.Tensor  # bool[N]
    last_press_amount: torch.Tensor   # i32[N]
    gen_pattern_first: torch.Tensor   # i32[N]
    gen_pattern_idx: torch.Tensor     # i32[N]
    gen_step_counter: torch.Tensor    # i32[N]
    current_step: torch.Tensor        # i32[N]
    total_input_units: torch.Tensor   # i32[N]
    key: torch.Tensor                 # i32[N, 2] threefry key words
    ev_mat: Optional[torch.Tensor] = None   # i16[E, N]
    ev_n: Optional[torch.Tensor] = None     # i16[E, N]
    ev_q: Optional[torch.Tensor] = None     # i16[E, N] (integer percent)
    ev_cnt: Optional[torch.Tensor] = None   # i32[N]


class BStepOut(NamedTuple):
    obs: torch.Tensor          # f32[N, obs_dim]
    reward: torch.Tensor       # f32[N]
    terminated: torch.Tensor   # bool[N]
    action: torch.Tensor       # i32[N]
    sort_reward: torch.Tensor  # f32[N]
    press_reward: torch.Tensor  # f32[N]
    purity: torch.Tensor       # f32[N]


def _bwhere(cond, a, b):
    """torch.where with a batch-(N,) cond broadcast over LEADING axes."""
    return torch.where(cond.reshape((1,) * (a.dim() - 1) + (-1,)), a, b)


def _select_state(pred, a: BState, b: BState) -> BState:
    """Per-env select over whole states: b where pred else a."""
    sel = {}
    for name, x, y in zip(BState._fields, a, b):
        if x is None:
            sel[name] = None
        elif name == "key":
            sel[name] = torch.where(pred[:, None], y, x)
        else:
            sel[name] = _bwhere(pred, y, x)
    return BState(**sel)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """An f32 constant on ``like``'s device (0-dim or from a sequence),
    from the cache of constants: never written to."""
    return const(x, F32, like.device)


def _recip(c, like: torch.Tensor) -> torch.Tensor:
    """``f32(1) / f32(c)`` on ``like``'s device.  The JAX engine runs under
    ``jit``, where XLA rewrites a division by a constant into a product
    with its f32 reciprocal; the port multiplies by the same reciprocal."""
    return const(np.float32(1.0) / np.asarray(c, np.float32), F32,
                 like.device)


# ---------------------------------------------------------------------------
# Reset
# ---------------------------------------------------------------------------

def resolved_bale_mode(cfg: SimConfig) -> str:
    """"auto" resolves to "events" (the production path)."""
    m = getattr(cfg, "bale_mode", "full")
    return "events" if m in ("auto", "events") else "full"


def _require_events(cfg: SimConfig):
    """The step kernel carries the event log only, as the JAX kernel does
    (``step_pallas.supported``)."""
    if resolved_bale_mode(cfg) != "events":
        raise ValueError(
            "the step kernel needs bale_mode='events'; a full-bale-mode "
            "step runs the eager body (fastb._dispatch)")


def _bale_zeros(cfg: SimConfig, n: int, dev) -> dict:
    if resolved_bale_mode(cfg) == "full":
        return dict(
            bale_size=torch.zeros((5, cfg.max_bales, n), dtype=I16,
                                  device=dev),
            bale_qual=torch.zeros((5, cfg.max_bales, n), dtype=I16,
                                  device=dev),
            bale_cnt=torch.zeros((5, n), dtype=I32, device=dev))
    e = cfg.max_press_events
    # guard the implicit default path only (see the JAX engine): users
    # routed to events by bale_mode="auto" must not overflow the log
    if getattr(cfg, "bale_mode", "full") == "auto":
        needed = (cfg.max_steps // max(1, cfg.press_time_1)
                  + cfg.max_steps // max(1, cfg.press_time_2))
        if e < needed:
            raise ValueError(
                f"max_press_events={e} cannot hold the {needed} press "
                f"completions a max_steps={cfg.max_steps} episode can "
                "produce — build the config via load_config() (which "
                "sizes it automatically), raise max_press_events, or "
                "set bale_mode explicitly")
    return dict(bale_size=None, bale_qual=None, bale_cnt=None,
                ev_mat=torch.zeros((e, n), dtype=I16, device=dev),
                ev_n=torch.zeros((e, n), dtype=I16, device=dev),
                ev_q=torch.zeros((e, n), dtype=I16, device=dev),
                ev_cnt=torch.zeros(n, dtype=I32, device=dev))


def _reset_from_keys(cfg: SimConfig, keys: torch.Tensor) -> BState:
    n = keys.shape[0]
    dev = keys.device
    ks = TF.split(keys)
    key, k1 = ks[:, 0], ks[:, 1]
    first = TF.bernoulli(k1).to(I32)

    def z(*shape, dtype=I32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    acc0 = _f32(cfg.baseline_accuracy, keys)[:, None].expand(4, n)
    return BState(
        input_counts=z(4, n),
        belt_counts=z(4, n),
        sort_counts=z(4, n),
        acc_belt=acc0.clone(),
        acc_sorter=acc0.clone(),
        sensor_setting=z(n),
        input_occupancy=z(n, dtype=F32),
        belt_occupancy=z(n, dtype=F32),
        cont_true=z(5, n),
        cont_false=z(4, n),
        press_timer=z(2, n),
        press_mat=z(2, n),
        press_n=z(2, n),
        press_q=z(2, n, dtype=F32),
        **_bale_zeros(cfg, n, dev),
        last_press_started=z(n, dtype=torch.bool),
        last_press_amount=z(n),
        gen_pattern_first=first,
        gen_pattern_idx=z(n),
        gen_step_counter=z(n),
        current_step=z(n),
        total_input_units=z(n),
        key=key.contiguous(),
    )


def reset_batch(cfg: SimConfig, key, n: int, device="cuda") -> BState:
    """``n`` fresh envs from ``key``: an int seed (``PRNGKey(seed)``, i.e.
    the words ``[seed >> 32, seed & 0xffffffff]``) or an ``int32[2]`` key.
    The keys of the envs are ``split(key, n)``, as in the JAX engine."""
    dev = resolve_device(device)
    if isinstance(key, int):
        key = TF.prng_key(key, dev)
    key = key.to(device=dev, dtype=I32)
    return _reset_from_keys(cfg, TF.split(key[None], n)[0])


def from_batch_first(st_bf) -> BState:
    """A batch-first state (``core/fast.FastEnvState``, batch on axis 0) as
    a ``BState``: every leaf of two or more axes takes its batch axis last
    (a view); ``key`` stays ``(N, 2)``."""
    kw = {name: (x if (x is None or name == "key" or x.dim() <= 1)
                 else x.movedim(0, -1))
          for name, x in zip(type(st_bf)._fields, st_bf)}
    return BState(**kw)


def to_batch_first(st: BState):
    """A full-bale-mode ``BState`` as a ``core/fast.FastEnvState`` (batch on
    axis 0, views).  An events-mode state raises: convert it with
    ``core/bale_events.events_to_full`` first."""
    from . import fast as FE
    if st.ev_cnt is not None:
        raise ValueError(
            "to_batch_first needs a full-bale-mode state; convert with "
            "core.bale_events.events_to_full(cfg, st) first")
    kw = {name: (x if (name == "key" or x.dim() <= 1) else x.movedim(-1, 0))
          for name, x in zip(BState._fields, st) if not name.startswith("ev_")}
    return FE.FastEnvState(**kw)


# ---------------------------------------------------------------------------
# Sampling helpers
# ---------------------------------------------------------------------------

def _prefix_sum0(x):
    """Inclusive prefix sum along axis 0 — Hillis-Steele, the JAX engine's
    association (torch.cumsum would round differently)."""
    idx = torch.arange(x.shape[0], device=x.device)[:, None]
    s = 1
    while s < x.shape[0]:
        x = x + torch.where(idx >= s, torch.roll(x, s, 0),
                            torch.zeros((), dtype=x.dtype, device=x.device))
        s *= 2
    return x


def _prefix_prod0(x):
    idx = torch.arange(x.shape[0], device=x.device)[:, None]
    s = 1
    while s < x.shape[0]:
        x = x * torch.where(idx >= s, torch.roll(x, s, 0),
                            torch.ones((), dtype=x.dtype, device=x.device))
        s *= 2
    return x


def _hypergeom_u(u, N, K, n, support=_HG_SUPPORT):
    """Batched X ~ Hypergeometric(N, K, n) by inverse CDF from the uniform
    u: f32[B]; N/K/n are i32[B].  The pmf is laid out (support, B)."""
    dev = u.device
    one = torch.ones((), dtype=F32, device=dev)
    Nf = torch.clamp(N, min=1).to(F32)[None, :]
    ks = torch.arange(support, dtype=I32, device=dev)[:, None]
    kf = ks.to(F32)
    Kf = K.to(F32)[None, :]
    nf = n.to(F32)[None, :]
    lo = torch.clamp(n - (N - K), min=0)
    hi = torch.minimum(K, n)
    num = (Kf - kf) * (nf - kf)
    den = (kf + one) * (Nf - Kf - nf + kf + one)
    in_band = (ks >= lo[None, :]) & (ks < hi[None, :])
    ratio = torch.where(in_band, num / den, one)
    pp = _prefix_prod0(ratio)
    pmf = torch.cat([torch.ones((1, pp.shape[1]), dtype=F32, device=dev),
                     pp[:-1]], dim=0)
    valid = (ks >= lo[None, :]) & (ks <= hi[None, :])
    pmf = torch.where(valid, pmf, torch.zeros((), dtype=F32, device=dev))
    cdf = _prefix_sum0(pmf)
    us = u * cdf[-1]
    x = (cdf < us[None, :]).to(I32).sum(dim=0, dtype=I32)
    return torch.clamp(x, lo, hi)


def _mvhg4_u(us, counts, n, support=_HG_SUPPORT):
    """Multivariate hypergeometric over 4 categories from the uniforms
    us: f32[3, B]; counts: i32[4, B]; n: i32[B] -> removed i32[4, B]."""
    N = counts.sum(dim=0, dtype=I32)
    n = torch.minimum(n, N)
    d0 = _hypergeom_u(us[0], N, counts[0], n, support)
    N1 = N - counts[0]
    n1 = n - d0
    d1 = _hypergeom_u(us[1], N1, counts[1], n1, support)
    N2 = N1 - counts[1]
    n2 = n1 - d1
    d2 = _hypergeom_u(us[2], N2, counts[2], n2, support)
    d3 = n2 - d2
    return torch.stack([d0, d1, d2, d3]).to(I32)


def redistribute_u(counts, acc_sorter, us, support=_HG_SUPPORT):
    """The redistribution core of ``_sort_material`` on pre-drawn uniforms
    ``us: f32[12, B]`` (3 draws x 4 stations, station-major).  Returns
    (leftover, true_arr, false_arr), each i32[4, B]."""
    leftover = counts.clone()
    true_arr = torch.zeros_like(counts)
    false_arr = torch.zeros_like(counts)
    for i in range(4):
        target = leftover[i]
        true_val = torch.round(target.to(F32) * acc_sorter[i]).to(I32)
        false_val = target - true_val
        true_arr[i] = true_val
        false_arr[i] = false_val
        leftover[i] = false_val
        removed = _mvhg4_u(us[3 * i:3 * i + 3], leftover, false_val, support)
        leftover = leftover - removed
    return leftover, true_arr, false_arr


# ---------------------------------------------------------------------------
# Plant dynamics
# ---------------------------------------------------------------------------

def _pattern_units(cfg: SimConfig):
    """Per-pattern units ``floor(f32(ratio) * f32(batch))`` and their
    remainders, computed on the host exactly as the f32 device op."""
    bs = cfg.input_batch_size
    u0 = [int(np.floor(np.float32(r) * np.float32(bs))) for r in _P0]
    u1 = [int(np.floor(np.float32(r) * np.float32(bs))) for r in _P1]
    return u0, u1, bs - sum(u0), bs - sum(u1)


def _generate_input(cfg: SimConfig, st: BState):
    switch = st.gen_step_counter >= cfg.steps_per_pattern
    pattern_idx = torch.where(switch, (st.gen_pattern_idx + 1) % 2,
                              st.gen_pattern_idx)
    step_counter = torch.where(switch, torch.zeros_like(st.gen_step_counter),
                               st.gen_step_counter)
    row0 = ((st.gen_pattern_first + pattern_idx) % 2 == 0)
    u0, u1, r0, r1 = _pattern_units(cfg)
    dev = st.key.device
    units = torch.where(row0[None, :], const(u0, I32, dev)[:, None],
                        const(u1, I32, dev)[:, None])
    remainder = torch.where(row0, r0, r1).to(I32)

    ks = TF.split(st.key)
    key, k1 = ks[:, 0], ks[:, 1]
    ms = TF.randint4(k1).T                                  # (4, N) draws
    active = torch.arange(4, device=dev)[:, None] < remainder[None, :]
    cats = torch.arange(4, dtype=I32, device=dev)[:, None, None]
    add = ((ms[None, :, :] == cats) & active[None, :, :]).sum(
        dim=1, dtype=I32)
    units = units + add
    st = st._replace(
        gen_pattern_idx=pattern_idx.to(I32),
        gen_step_counter=(step_counter + 1).to(I32),
        key=key.contiguous(),
    )
    return units, st


def _update_environment(cfg: SimConfig, st: BState) -> BState:
    st = st._replace(
        sort_counts=st.belt_counts,
        belt_counts=st.input_counts,
        belt_occupancy=st.input_occupancy,
    )
    counts, st = _generate_input(cfg, st)
    total = counts.sum(dim=0, dtype=I32)
    return st._replace(
        input_counts=counts,
        input_occupancy=total.to(F32) * _recip(100.0, total),
        acc_sorter=st.acc_belt,
        total_input_units=st.total_input_units + total,
    )


def _update_accuracy(cfg: SimConfig, st: BState) -> BState:
    like = st.acc_belt
    base = _f32(cfg.baseline_accuracy, like)[:, None]
    b = cfg.boost
    boost_ac = _f32([b, 0.0, b, 0.0], like)[:, None]
    boost_bd = _f32([0.0, b, 0.0, b], like)[:, None]
    zero = _f32(0.0, like)
    ss = st.sensor_setting[None, :]
    acc = base + torch.where(ss == 0, boost_ac,
                             torch.where(ss == 1, boost_bd, zero))
    ks = TF.split(st.key)
    key, k1 = ks[:, 0], ks[:, 1]
    n = cfg.effective_noise
    if n > 0:
        acc = acc + TF.uniform4(k1, -n, n).T
    return st._replace(acc_belt=torch.clamp(acc, 0.0, 1.0),
                       key=key.contiguous())


def _sort_uniforms(key):
    """The 12 uniforms of the sort section, drawn with the JAX engine's key
    chain: per station split(key) -> (key, sk), split(sk, 3), one uniform
    from each of the 3 keys.  The 4 splits of the chain run in turn; the
    station keys' splits and uniforms are drawn together (the same bits).
    Returns (us f32[12, N], station-major: row 3 * station + j; new key)."""
    sks = []
    for _ in range(4):
        ks = TF.split(key)
        key, sk = ks[:, 0], ks[:, 1]
        sks.append(sk)
    n = key.shape[0]
    k3 = TF.split(torch.stack(sks, dim=1).reshape(-1, 2), 3)   # (N*4, 3, 2)
    u = TF.uniform(k3.reshape(-1, 2)).reshape(n, 12)
    return u.T.contiguous(), key.contiguous()


def _sort_material(cfg: SimConfig, st: BState, plain: bool = False):
    """The sort section.  Its core (the 12 uniforms and the
    redistribution) goes through the sorting-core kernel for a state on
    CUDA (``ops/sort_cuda.py``) unless ``plain`` is set; with ``plain``, or
    on the CPU, it runs the plain version and launches nothing."""
    from ..ops import sort_cuda
    total_input = st.sort_counts.sum(dim=0, dtype=I32)      # (N,)
    core = sort_cuda.sort_material_plain if plain else sort_cuda.sort_material
    leftover, true_arr, false_arr, key = core(
        st.sort_counts.contiguous(), st.acc_sorter.contiguous(),
        st.key.contiguous(), _support_for(cfg))
    e_input = leftover.sum(dim=0, dtype=I32)
    cont_true = st.cont_true.clone()
    cont_true[:4] += true_arr
    cont_true[4] += e_input
    one = _f32(1.0, total_input)
    purity = torch.where(
        total_input > 0,
        one - (total_input - true_arr.sum(dim=0, dtype=I32)).to(F32)
        / torch.clamp(total_input, min=1).to(F32),
        _f32(0.0, total_input))
    st = st._replace(
        cont_true=cont_true,
        cont_false=st.cont_false + false_arr,
        key=key,
    )
    return purity, st


def _onehot_rows(m, nrows):
    """bool[(nrows, N)]: row r true where m == r."""
    return torch.arange(nrows, device=m.device)[:, None] == m[None, :]


def _row_at(arr, m):
    """arr[(nrows, N)] gathered at per-env row m -> (N,)."""
    return arr.gather(0, m[None, :].long())[0]


def _press_bale(cfg: SimConfig, st: BState, m, n, q, pred) -> BState:
    """Bale out the finished presses (predicated).  Events mode appends one
    (material, amount, quality%) event per finished press to the (E, N)
    log.  Full mode writes the bales into the (5, MAX, N) buffers as masked
    updates: ``n // bs`` full bales, then a remainder above the threshold
    (or any remainder of an empty list) as its own bale, else merged into
    the last bale."""
    q_int = (q * _f32(100.0, q)).to(I16)
    if st.ev_cnt is not None:
        lanes = torch.arange(st.ev_n.shape[0], device=m.device)[:, None]
        hit = (lanes == st.ev_cnt[None, :]) & pred[None, :]
        return st._replace(
            ev_mat=torch.where(hit, m[None, :].to(I16), st.ev_mat),
            ev_n=torch.where(hit, n[None, :].to(I16), st.ev_n),
            ev_q=torch.where(hit, q_int[None, :], st.ev_q),
            ev_cnt=st.ev_cnt + pred.to(I32),
        )
    bs = cfg.effective_balesize
    q3 = q_int[None, None, :]
    full = n // bs                                        # (N,)
    rem = (n % bs).to(I16)
    dev = m.device
    rows = torch.arange(5, device=dev)[:, None, None]
    lanes = torch.arange(st.bale_size.shape[1], device=dev)[None, :, None]
    sel = pred[None, None, :] & (rows == m[None, None, :])   # (5, 1, N)
    cnt_m = _row_at(st.bale_cnt, m)                       # (N,)

    cm = cnt_m[None, None, :]
    new_mask = sel & (lanes >= cm) & (lanes < cm + full[None, None, :])
    bale_size = torch.where(new_mask, const(bs, I16, dev), st.bale_size)
    bale_qual = torch.where(new_mask, q3, st.bale_qual)
    cnt2 = cnt_m + full                                   # (N,)

    big_rem = rem.to(F32) > _f32(np.float32(bs) * np.float32(
        cfg.bale_remainder_threshold), q)
    has_rem = rem > 0
    own = has_rem & (big_rem | (cnt2 == 0))               # (N,)
    app = sel & own[None, None, :] & (lanes == cnt2[None, None, :])
    rem3 = rem[None, None, :]
    bale_size = torch.where(app, rem3, bale_size)
    bale_qual = torch.where(app, q3, bale_qual)
    merge = has_rem & ~big_rem & (cnt2 > 0)
    mm = sel & merge[None, None, :] & (lanes == (cnt2 - 1)[None, None, :])
    bale_size = torch.where(mm, bale_size + rem3, bale_size)
    cnt3 = (cnt2 + own.to(I32)).to(I32)

    bale_cnt = torch.where(pred[None, :] & _onehot_rows(m, 5), cnt3[None, :],
                           st.bale_cnt)
    return st._replace(bale_size=bale_size, bale_qual=bale_qual,
                       bale_cnt=bale_cnt)


def _check_press_status(cfg: SimConfig, st: BState) -> BState:
    for p in range(2):
        busy = st.press_timer[p] > 0
        timer = torch.where(busy, st.press_timer[p] - 1, st.press_timer[p])
        done = busy & (timer == 0)
        st = _press_bale(cfg, st, st.press_mat[p], st.press_n[p],
                         st.press_q[p], done)
        press_timer = st.press_timer.clone()
        press_mat = st.press_mat.clone()
        press_n = st.press_n.clone()
        press_q = st.press_q.clone()
        press_timer[p] = timer
        press_mat[p] = torch.where(done, 0, st.press_mat[p])
        press_n[p] = torch.where(done, 0, st.press_n[p])
        press_q[p] = torch.where(done, _f32(0.0, press_q), st.press_q[p])
        st = st._replace(press_timer=press_timer, press_mat=press_mat,
                         press_n=press_n, press_q=press_q)
    return st


def _container_level(st: BState, m):
    ct = _row_at(st.cont_true, m)
    cf = _row_at(st.cont_false, torch.clamp(m, max=3))
    return torch.where(m < 4, ct + cf, st.cont_true[4])


def _use_press(cfg: SimConfig, st: BState, press, m, pred) -> BState:
    """Load a press (predicated); press/m are i32[N]."""
    p0 = press == 1                                       # True -> press row 0
    busy = torch.where(p0, st.press_timer[0], st.press_timer[1]) > 0
    go = pred & ~busy
    total = _container_level(st, m)
    true_m = torch.where(m < 4, _row_at(st.cont_true, m), total)
    quality = torch.where(
        (m < 4) & (total > 0),
        true_m.to(F32) / torch.clamp(total, min=1).to(F32),
        _f32(0.0, st.press_q))
    press_time = torch.where(p0, cfg.press_time_1, cfg.press_time_2).to(I32)
    clear_true = go[None, :] & _onehot_rows(m, 5)
    clear_false = (go & (m < 4))[None, :] & _onehot_rows(
        torch.clamp(m, max=3), 4)
    hit = _onehot_rows(torch.where(p0, 0, 1), 2)          # (2, N) press row
    upd = hit & go[None, :]
    return st._replace(
        last_press_started=st.last_press_started | go,
        last_press_amount=torch.where(go, total, st.last_press_amount),
        cont_true=torch.where(clear_true, 0, st.cont_true),
        cont_false=torch.where(clear_false, 0, st.cont_false),
        press_timer=torch.where(upd, press_time[None, :], st.press_timer),
        press_mat=torch.where(upd, m[None, :], st.press_mat),
        press_n=torch.where(upd, total[None, :], st.press_n),
        press_q=torch.where(upd, quality[None, :], st.press_q),
    )


def _press_action_rules(cfg: SimConfig, st: BState, press_id, m):
    st = _check_press_status(cfg, st)
    return _use_press(cfg, st, torch.clamp(press_id, min=1), m,
                      press_id != 0)


def _validate_press(cfg: SimConfig, st: BState, press_id, m):
    busy = torch.where(
        press_id == 1, st.press_timer[0] > 0,
        (press_id == 2) & (st.press_timer[1] > 0))
    level = _container_level(st, m)
    ok = (~busy) & (level >= cfg.effective_balesize)
    return torch.where(press_id == 0, True, ok)


def press_action_masks(cfg: SimConfig, st: BState):
    """bool[N, 11] (batch-first, as the JAX engine returns it)."""
    levels = torch.cat([st.cont_true[:4] + st.cont_false, st.cont_true[4:5]])
    enough = levels >= cfg.effective_balesize
    p1 = (st.press_timer[0] == 0)[None, :]
    p2 = (st.press_timer[1] == 0)[None, :]
    ones = torch.ones((1, enough.shape[1]), dtype=torch.bool,
                      device=enough.device)
    return torch.cat([ones, enough & p1, enough & p2]).T


def monolith_action_masks(cfg: SimConfig, st: BState):
    m = press_action_masks(cfg, st)
    return torch.cat([m, m], dim=1)


def _sorting_rules(st: BState):
    c = st.belt_counts
    return (c[0] + c[2] <= c[1] + c[3]).to(I32)


def _check_container_level(cfg: SimConfig, st: BState):
    free1 = st.press_timer[0] == 0
    free2 = st.press_timer[1] == 0
    free_press = torch.where(free1, 1, torch.where(free2, 2, 0)).to(I32)
    levels_ad = st.cont_true[:4] + st.cont_false          # (4, N)
    best_ad = torch.zeros_like(free_press)
    best_lvl = levels_ad[0]
    for j in (1, 2, 3):                  # first max wins, as jnp.argmax
        take = levels_ad[j] > best_lvl
        best_ad = torch.where(take, j, best_ad)
        best_lvl = torch.where(take, levels_ad[j], best_lvl)
    lvl_e = st.cont_true[4]
    best_idx = torch.where(lvl_e > best_lvl, 4, best_ad).to(I32)
    best_lvl = torch.maximum(best_lvl, lvl_e)
    ok = (free_press > 0) & (best_lvl > 0)
    zero = torch.zeros_like(free_press)
    return torch.where(ok, free_press, zero), torch.where(ok, best_idx, zero)


def _container_purities(cfg: SimConfig, st: BState):
    total = st.cont_true[:4] + st.cont_false
    purity = st.cont_true[:4].to(F32) / torch.clamp(total, min=1).to(F32)
    return torch.where(total > 0, purity,
                       _f32(cfg.quality_threshold, purity))


def get_sort_obs(cfg: SimConfig, st: BState):
    """f32[N, 13]."""
    total = st.belt_counts.sum(dim=0, dtype=I32)
    props = torch.where(total[None, :] > 0,
                        st.belt_counts.to(F32)
                        / torch.clamp(total, min=1).to(F32)[None, :],
                        _f32(0.0, st.acc_belt))
    diffs = _container_purities(cfg, st) - _f32(cfg.quality_threshold,
                                                st.acc_belt)
    obs = torch.cat([st.belt_occupancy[None, :], props, st.acc_belt, diffs])
    return torch.clamp(obs, -1.0, 1.0).T.contiguous()


def get_press_obs(cfg: SimConfig, st: BState):
    """f32[N, 16]."""
    like = st.acc_belt
    levels = torch.cat([st.cont_true[:4] + st.cont_false,
                        st.cont_true[4:5]]).to(F32) * _recip(
                            cfg.container_capacity, like)
    sorter = st.sort_counts.to(F32) * _recip(cfg.stage_capacity, like)
    timers = st.press_timer.to(F32) * _recip(
        [cfg.press_time_1, cfg.press_time_2], like)[:, None]
    return torch.clamp(torch.cat([levels, levels, sorter, timers]),
                       0.0, 1.0).T.contiguous()


def get_mono_obs(cfg: SimConfig, st: BState):
    return torch.cat([get_sort_obs(cfg, st), get_press_obs(cfg, st)], dim=1)


def _sorting_reward_arg(cfg: SimConfig, st: BState):
    """The argument of the sorting reward's tanh.  The 4 rows are summed
    left to right, the association of the JAX engine's reduction."""
    p = _container_purities(cfg, st) - _f32(cfg.purity_threshold_theta,
                                            st.acc_belt)
    score = ((p[0] + p[1]) + p[2]) + p[3]
    # XLA folds (score / 4) * psf into score * (0.25 * psf)
    return score * _f32(np.float32(0.25) * np.float32(
        cfg.purity_scaling_factor), score)


def sorting_reward_from_arg(cfg: SimConfig, raw):
    """tanh(raw / T), with the division as XLA does it (a product with the
    f32 reciprocal).  The reciprocal goes in as a Python float, exact in
    f32: a device tensor made from the host here would cost the CUDA path
    a blocking copy on every step."""
    recip = float(np.float32(1.0) / np.float32(cfg.tanh_temperature))
    return torch.tanh(raw * recip)


def _sorting_reward(cfg: SimConfig, st: BState):
    return sorting_reward_from_arg(cfg, _sorting_reward_arg(cfg, st))


def _press_reward_consts(cfg: SimConfig):
    """Host-folded f32 constants of the press reward, folded as XLA folds
    them under ``jit``: ``overall * msr`` becomes ``sum * (1/(5 cap) *
    msr)`` and ``4 * (dist / bs)`` becomes ``dist * (4 * (1/bs))``."""
    f = np.float32
    cap = f(cfg.container_capacity)
    return dict(
        recip_cap=f(1.0) / cap,
        state_scale=(f(1.0) / (f(5.0) * cap)) * f(cfg.max_state_reward),
        dist_scale=f(4.0) * (f(1.0) / f(cfg.effective_balesize)),
    )


def _press_reward(cfg: SimConfig, st: BState):
    """The press reward.  Three mul-adds are fused, as XLA fuses them on the
    CPU (checked expression by expression against the jitted JAX engine):
    ``1 - dist * c``, ``efficiency * bef + (peak - bef)`` and
    ``sum * state_scale + action_reward``."""
    like = st.acc_belt
    k = _press_reward_consts(cfg)
    levels = torch.cat([st.cont_true[:4] + st.cont_false,
                        st.cont_true[4:5]]).to(F32)
    fill = levels * _f32(k["recip_cap"], like)
    catastrophic = (fill > 1.0).any(dim=0)
    zero = _f32(0.0, like)
    max_penalty = torch.where(
        (fill > 0.95).any(dim=0), _f32(cfg.overflow_penalty_severe, like),
        torch.where((fill > 0.90).any(dim=0),
                    _f32(cfg.overflow_penalty_mild, like), zero))
    bs = cfg.effective_balesize
    amount = st.last_press_amount
    num_bales = amount // bs
    rem = amount % bs
    dist = torch.minimum(rem, bs - rem).to(F32)
    bef = _f32(cfg.bale_efficiency_factor, like)
    one = _f32(1.0, like)
    efficiency = TF.fma_f32(-dist, _f32(k["dist_scale"], like).expand_as(dist),
                            one.expand_as(dist))
    w = torch.clamp(num_bales, max=3)
    peak = torch.where(w == 0, zero,
                       torch.where(w == 1, _f32(1.0 / 3.0, like),
                                   torch.where(w == 2, _f32(2.0 / 3.0, like),
                                               one)))
    action_reward = torch.where(
        st.last_press_started,
        TF.fma_f32(efficiency, bef.expand_as(efficiency), peak - bef), zero)
    # integer-valued f32 rows: the sum is exact in any order
    total = levels.sum(dim=0)
    unclipped = TF.fma_f32(total, _f32(k["state_scale"], like).expand_as(
        total), action_reward)
    normal = torch.clamp(unclipped, -1.0, 1.0)
    reward = torch.where(
        catastrophic, _f32(cfg.overflow_penalty_catastrophic, like),
        torch.where(max_penalty < 0.0, max_penalty, normal))
    early = catastrophic | (max_penalty < 0.0)
    st = st._replace(
        last_press_started=st.last_press_started & early,
        last_press_amount=torch.where(early, st.last_press_amount, 0),
    )
    return reward, st


def _finish(cfg: SimConfig, st: BState):
    st = st._replace(current_step=st.current_step + 1)
    return st, st.current_step >= cfg.max_steps


def _apply_sort(cfg, st, sort_mode, plain: bool = False):
    st = st._replace(sensor_setting=sort_mode.to(I32))
    st = _update_accuracy(cfg, st)
    return _sort_material(cfg, st, plain)


def masked_uniform_choice(mask, u):
    """Uniform pick over the True entries of ``mask[..., A]`` from ONE f32
    uniform: rank r = floor(u * n_valid) (clamped), return the index of
    the (r+1)-th valid entry via an inclusive prefix count."""
    c = torch.cumsum(mask.to(I32), dim=-1, dtype=I32)
    nv = c[..., -1]
    r = torch.minimum((u * nv.to(F32)).to(I32), nv - 1)
    return (c <= r[..., None]).sum(dim=-1, dtype=I32)


def _sample_masked_press(cfg, st: BState):
    mask = press_action_masks(cfg, st)                   # (N, 11)
    ks = TF.split(st.key)
    key, sk = ks[:, 0], ks[:, 1]
    a = masked_uniform_choice(mask, TF.uniform(sk))
    press_id, mat = _decode_press(a)
    return press_id, mat, st._replace(key=key.contiguous())


def _decode_press(a):
    """11-way press choice -> (press_id 0/1/2, material 0..4)."""
    zero = torch.zeros_like(a)
    press_id = torch.where(a == 0, zero, torch.where(a <= 5, 1, 2)).to(I32)
    mat = torch.where(a == 0, zero, (a - 1) % 5).to(I32)
    return press_id, mat


# ---------------------------------------------------------------------------
# Variant steps (batched: action is i32[N]).  The _*_body functions are the
# eager steps; the public ones dispatch on the state's device.  A body's
# sorting core goes through the sorting-core kernel for a state on CUDA
# unless ``plain`` is set; ``eager_step`` sets it, so the bodies it returns
# (the kernels' plain versions) launch no kernel.
# ---------------------------------------------------------------------------

@profiling.spanned("fastb.eager", body="sort")
def _sort_body(cfg: SimConfig, st: BState, action, plain: bool = False):
    a = action.to(I32)
    st = _update_environment(cfg, st)
    purity, st = _apply_sort(cfg, st, a, plain)
    press_id, mat, st = _sample_masked_press(cfg, st)
    st = _press_action_rules(cfg, st, press_id, mat)
    reward = _sorting_reward(cfg, st)
    obs = get_sort_obs(cfg, st)
    st, terminated = _finish(cfg, st)
    return st, BStepOut(obs, reward, terminated, a, reward,
                        torch.zeros_like(reward), purity)


def agent_argmax(logits):
    """An agent's deterministic action: the first maximum of its logits, as
    ``jnp.argmax`` (int32[N])."""
    return torch.argmax(logits, dim=-1).to(I32)


def frozen_sort_mode(cfg: SimConfig, st: BState, sort_policy):
    """The frozen sort agent's action: the argmax of its logits on the sort
    observation."""
    with torch.no_grad():
        logits = sort_policy.policy_logits(get_sort_obs(cfg, st))
    return agent_argmax(logits)


def _sanitize_press(cfg, st, press_id, mat, use_action_masking):
    """Unmasked invalid presses become no-ops (the timers still tick)."""
    if not use_action_masking:
        valid = _validate_press(cfg, st, press_id, mat)
        press_id = torch.where(valid, press_id, 0)
        mat = torch.where(valid, mat, 0)
    return press_id, mat


def _mono_tail(cfg, st, a, purity):
    """A monolith step after its press phase: the rewards, the obs, the
    step count; ``a`` is the flat action."""
    sr = _sorting_reward(cfg, st)
    pr, st = _press_reward(cfg, st)
    obs = get_mono_obs(cfg, st)
    st, terminated = _finish(cfg, st)
    return st, BStepOut(obs, sr + pr, terminated, a.to(I32), sr, pr, purity)


@profiling.spanned("fastb.eager", body="press")
def _press_body(cfg: SimConfig, st: BState, action,
                use_action_masking: bool = True, sort_policy=None,
                plain: bool = False):
    a = action.to(I32)
    st = _update_environment(cfg, st)
    if sort_policy is not None:
        sort_mode = frozen_sort_mode(cfg, st, sort_policy)
    else:
        sort_mode = _sorting_rules(st)
    purity, st = _apply_sort(cfg, st, sort_mode, plain)
    press_id, mat = _sanitize_press(cfg, st, *_decode_press(a),
                                    use_action_masking)
    st = _press_action_rules(cfg, st, press_id, mat)
    reward, st = _press_reward(cfg, st)
    obs = get_press_obs(cfg, st)
    st, terminated = _finish(cfg, st)
    return st, BStepOut(obs, reward, terminated, a,
                        torch.zeros_like(reward), reward, purity)


@profiling.spanned("fastb.eager", body="external")
def _external_body(cfg: SimConfig, st: BState, action,
                   use_action_masking: bool = True, plain: bool = False):
    a = action.to(I32)
    st = _update_environment(cfg, st)
    purity, st = _apply_sort(cfg, st, a // 11, plain)
    press_id, mat = _decode_press(a % 11)
    if not use_action_masking:
        # an invalid press leaves no trace: not even the timers tick
        valid = _validate_press(cfg, st, press_id, mat)
        dispatched = _press_action_rules(cfg, st, press_id, mat)
        st = _select_state(valid, st, dispatched)
    else:
        st = _press_action_rules(cfg, st, press_id, mat)
    return _mono_tail(cfg, st, a, purity)


@profiling.spanned("fastb.eager", body="rule")
def _rule_body(cfg: SimConfig, st: BState, action=None,
               plain: bool = False):
    st = _update_environment(cfg, st)
    sort_mode = _sorting_rules(st)
    press_id, mat = _check_container_level(cfg, st)
    purity, st = _apply_sort(cfg, st, sort_mode, plain)
    st = _press_action_rules(cfg, st, press_id, mat)
    flat = sort_mode * 11 + torch.where(press_id == 0, 0,
                                        (press_id - 1) * 5 + mat + 1)
    return _mono_tail(cfg, st, flat, purity)


def _vcategorical(keys, logits):
    """``vmap(jax.random.categorical)``: one draw per env (int32[N])."""
    return TF.vcategorical(keys, logits).to(I32)


def _neg_inf_where_not(mask, logits):
    return torch.where(mask, logits, torch.full_like(logits, float("-inf")))


@profiling.spanned("fastb.eager", body="model")
def _model_body(cfg: SimConfig, st: BState, sort_policy=None,
                press_policy=None, use_action_masking: bool = True,
                plain: bool = False):
    """The modular agents on the monolith: both act on the post-update,
    pre-sort state.  A missing sort agent draws a uniform 2-way mode, a
    missing press agent a masked (or uniform 11-way) press, each from its
    own split of the env's key."""
    st = _update_environment(cfg, st)
    n = st.current_step.shape[0]
    dev = st.current_step.device

    def draw(logits):
        nonlocal st
        ks = TF.split(st.key)
        st = st._replace(key=ks[:, 0].contiguous())
        return _vcategorical(ks[:, 1].contiguous(), logits)

    if sort_policy is not None:
        sort_mode = frozen_sort_mode(cfg, st, sort_policy)
    else:
        sort_mode = draw(torch.zeros((n, 2), dtype=F32, device=dev))
    if press_policy is not None:
        with torch.no_grad():
            logits = press_policy.policy_logits(get_press_obs(cfg, st))
        if use_action_masking:
            logits = _neg_inf_where_not(press_action_masks(cfg, st), logits)
        press_disc = agent_argmax(logits)
    elif use_action_masking:
        mask = press_action_masks(cfg, st)
        press_disc = draw(_neg_inf_where_not(
            mask, torch.zeros(mask.shape, dtype=F32, device=dev)))
    else:
        press_disc = draw(torch.zeros((n, 11), dtype=F32, device=dev))
    a_flat = sort_mode * 11 + press_disc

    purity, st = _apply_sort(cfg, st, sort_mode, plain)
    press_id, mat = _sanitize_press(cfg, st, *_decode_press(press_disc),
                                    use_action_masking)
    st = _press_action_rules(cfg, st, press_id, mat)
    return _mono_tail(cfg, st, a_flat, purity)


@profiling.spanned("fastb.eager", body="random")
def _random_body(cfg: SimConfig, st: BState, use_action_masking: bool = True,
                 plain: bool = False):
    """A uniform (masked) monolith action from a split of the env's key."""
    st = _update_environment(cfg, st)
    n = st.current_step.shape[0]
    dev = st.current_step.device
    ks = TF.split(st.key)
    st = st._replace(key=ks[:, 0].contiguous())
    if use_action_masking:
        mask = monolith_action_masks(cfg, st)
        logits = _neg_inf_where_not(
            mask, torch.zeros(mask.shape, dtype=F32, device=dev))
    else:
        logits = torch.zeros((n, 22), dtype=F32, device=dev)
    a = _vcategorical(ks[:, 1].contiguous(), logits)
    purity, st = _apply_sort(cfg, st, a // 11, plain)
    press_id, mat = _sanitize_press(cfg, st, *_decode_press(a % 11),
                                    use_action_masking)
    st = _press_action_rules(cfg, st, press_id, mat)
    return _mono_tail(cfg, st, a, purity)


VARIANTS = ("rule", "external", "sort", "press")


def _body(variant: str, use_action_masking: bool = True, sort_policy=None,
          press_policy=None, plain: bool = False):
    """The eager body of a variant as ``(cfg, st, action) -> (st, out)``
    ('rule', 'model' and 'random' ignore the action)."""
    if sort_policy is not None and variant not in ("press", "model"):
        raise ValueError("only the press and model steps take a sort_policy")
    if press_policy is not None and variant != "model":
        raise ValueError("only the model step takes a press_policy")
    m = use_action_masking
    if variant == "rule":
        return lambda c, s, a=None: _rule_body(c, s, a, plain=plain)
    if variant == "external":
        return lambda c, s, a: _external_body(c, s, a, m, plain=plain)
    if variant == "sort":
        return lambda c, s, a: _sort_body(c, s, a, plain=plain)
    if variant == "press":
        return lambda c, s, a: _press_body(c, s, a, m, sort_policy,
                                           plain=plain)
    if variant == "model":
        return lambda c, s, a=None: _model_body(c, s, sort_policy,
                                                press_policy, m, plain=plain)
    if variant == "random":
        return lambda c, s, a=None: _random_body(c, s, m, plain=plain)
    raise ValueError(f"unknown variant {variant!r}")


def eager_step(variant: str, use_action_masking: bool = True,
               sort_policy=None, press_policy=None):
    """The eager body of a variant ('rule', 'external', 'sort', 'press',
    'model', 'random') as ``(cfg, st, action) -> (st, out)``; it runs on
    whatever device the state lies on and launches no kernel: the kernels'
    plain version.  ``sort_policy`` (press and model) and ``press_policy``
    (model) are agents, as ``step_press`` and ``step_mono_model`` take
    them."""
    return _body(variant, use_action_masking, sort_policy, press_policy,
                 plain=True)


def _dispatch(cfg, st, action, variant, masked=True, autoreset=False):
    """An events-mode state goes to the step kernel's wrapper, which
    launches the CUDA kernel for a state on CUDA and runs the eager body for
    a state on the CPU.  A full-bale-mode state runs the eager body on its
    device (its sorting core on the sorting-core kernel on CUDA), wrapped in
    ``with_autoreset`` when ``autoreset`` is set: the JAX engine's choice,
    whose step kernel needs events mode."""
    if st.ev_cnt is None:
        body = _body(variant, masked)
        if autoreset:
            return with_autoreset(cfg, body)(st, action)
        return body(cfg, st, action)
    from ..ops import step_cuda
    return step_cuda.step_mono(cfg, st, action, variant=variant,
                               masked=masked, autoreset=autoreset)


def step_sort(cfg: SimConfig, st: BState, action):
    return _dispatch(cfg, st, action, "sort")


def step_press(cfg: SimConfig, st: BState, action, sort_policy=None,
               use_action_masking: bool = True):
    """The press step.  Without ``sort_policy`` the sorter follows its
    rules and, in events mode, the step is one launch of the step kernel on
    CUDA.  With one, ``sort_policy`` is a frozen sort agent, an
    ``ActorCritic`` whose parameters take no gradient (the port's
    counterpart of the JAX package's ``(apply_fn, params)`` pair): the
    argmax of its logits on the post-update sort observation sets the
    sorter, and the eager step runs with its sorting core on the
    sorting-core kernel (CUDA) or the plain core (CPU).  That step is not
    fused with the autoreset: the learner wraps it in ``with_autoreset``."""
    if sort_policy is not None:
        return _press_body(cfg, st, action, use_action_masking, sort_policy)
    return _dispatch(cfg, st, action, "press", use_action_masking)


def step_mono_external(cfg: SimConfig, st: BState, action,
                       use_action_masking: bool = True):
    return _dispatch(cfg, st, action, "external", use_action_masking)


def step_mono_rule(cfg: SimConfig, st: BState, action=None):
    return _dispatch(cfg, st, None, "rule")


def step_mono_model(cfg: SimConfig, st: BState, sort_policy=None,
                    press_policy=None, use_action_masking: bool = True):
    """The monolith driven by the modular agents (``ActorCritic`` modules,
    or None for the random fallbacks of ``_model_body``): the engine
    benchmark's Sort-Only and Modular policies.  The eager step, with its
    sorting core on the sorting-core kernel for a state on CUDA."""
    return _model_body(cfg, st, sort_policy, press_policy,
                       use_action_masking)


def step_mono_random(cfg: SimConfig, st: BState,
                     use_action_masking: bool = True):
    """The monolith driven by uniform (masked) random actions; unmasked
    invalid presses become no-ops.  The eager step, with its sorting core
    on the sorting-core kernel for a state on CUDA."""
    return _random_body(cfg, st, use_action_masking)


def autoreset(cfg: SimConfig, st: BState) -> BState:
    return _reset_from_keys(cfg, st.key)


def with_autoreset(cfg: SimConfig, step_fn):
    """step_fn(cfg, st, action) batched; resets terminated instances."""
    def stepped(st, action):
        st, out = step_fn(cfg, st, action)
        fresh = autoreset(cfg, st)
        return _select_state(out.terminated, st, fresh), out
    return stepped


def mono_autoreset_step(cfg: SimConfig, variant: str,
                        use_action_masking: bool = True):
    """Autoreset rollout step ``(st, action) -> (st, out)`` for any
    kernel-covered variant ('rule' | 'external' | 'sort' | 'press').  On
    CUDA an events-mode state's terminated-env reset is fused into the step
    kernel; on the CPU, and in full-bale mode, it is ``with_autoreset`` over
    the eager step, with the same bits."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")

    def stepped(st, action):
        return _dispatch(cfg, st, None if variant == "rule" else action,
                         variant, use_action_masking, autoreset=True)
    return stepped


# ---------------------------------------------------------------------------
# Graphed steps: an eager step of a CUDA state, captured once into a CUDA
# graph and replayed.  The eager bodies launch some 1,700 small device
# operations a step, each dispatched from Python; a replay launches the same
# kernels, in the same order, on the same data, with one call.
# ---------------------------------------------------------------------------

GRAPH_CAPTURES = 0     # graphs captured
GRAPH_REPLAYS = 0      # steps replayed

_GRAPHS: "dict[tuple, GraphedStep]" = {}


def _kernel_counters():
    from ..ops import mvhg_cuda, sort_cuda, step_cuda
    return step_cuda, sort_cuda, mvhg_cuda


def copy_leaves(dst, src) -> None:
    """``d.copy_(s)`` for each pair whose ``d`` is not None, as one
    multi-tensor copy per pair of dtypes: a CUDA graph records a few
    copies, not one per leaf."""
    groups: dict = {}
    for d, s in zip(dst, src):
        if d is None:
            continue
        ds, ss = groups.setdefault((d.dtype, s.dtype), ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def _store(static, new, keep=()) -> tuple:
    """Write each leaf of ``new`` into the leaf of ``static`` at its place
    (None leaves, and leaves that are the static one, are skipped), and
    return ``keep``.  A new leaf, or a kept tensor, that shares memory with
    ``static`` is copied out first, so that no write clobbers what a later
    one reads (a step hands leaves on: the belt's counts become the
    sorter's)."""
    held = {x.untyped_storage().data_ptr() for x in static if x is not None}

    def own(x):
        return x.clone() if x.untyped_storage().data_ptr() in held else x
    keep = tuple(map(own, keep))
    writes = [(s, own(x)) for s, x in zip(static, new)
              if s is not None and x is not s]
    if writes:
        copy_leaves(*zip(*writes))
    return keep


def capture_graph(device, run):
    """``run()`` warmed up once on a side stream (lazy set-up stays outside
    the capture), then captured into a CUDA graph: (the graph, what the
    captured ``run()`` returned, the kernel launches the capture recorded).
    The warm-up runs for real and its launches count; the capture's are
    taken off the launch counters, which ``count_launches`` adds them to at
    each replay."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        mods = _kernel_counters()
        before = [m.LAUNCHES for m in mods]
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            out = run()
        launches = [m.LAUNCHES - n for m, n in zip(mods, before)]
        for m, n in zip(mods, before):
            m.LAUNCHES = n
    return graph, out, launches


def count_launches(launches) -> None:
    """Add one replay's kernel launches (``capture_graph``'s record) to the
    launch counters."""
    for m, k in zip(_kernel_counters(), launches):
        m.LAUNCHES += k


class GraphedStep:
    """``fn(cfg, state, *args) -> (state, BStepOut)`` on a CUDA ``BState``,
    captured once into a CUDA graph that also writes the new state back
    into its input state.  ``load(st)`` sets that state (the capture leaves
    it a step past ``st``), and each ``step()`` is one replay.  The graph
    replays the kernels the capture recorded on the memory it recorded:
    ``args`` (agents included) are held, and a replay reads their
    parameters as they are then."""

    def __init__(self, cfg: SimConfig, fn, args: tuple, st: BState,
                 body: str):
        global GRAPH_CAPTURES
        self.body, self.busy = body, False
        self.state = BState(*(None if x is None else x.clone() for x in st))
        self._args = args      # the graph reads their memory

        def run():
            new, out = fn(cfg, self.state, *args)
            return BStepOut(*_store(self.state, new, out))
        self.graph, self.out, self.launches = self._capture(run)
        GRAPH_CAPTURES += 1

    def _capture(self, run):
        return capture_graph(self.state.key.device, run)

    def load(self, st: BState) -> None:
        """Copy ``st`` into the graph's input state."""
        copy_leaves(self.state, st)

    @contextlib.contextmanager
    def loaded(self, st: BState):
        """The stepper at ``st``, held as in use (``graphed_step`` hands it
        to no one else) until the block ends."""
        self.load(st)
        self.busy = True
        try:
            yield self
        finally:
            self.busy = False

    def step(self) -> BStepOut:
        """One step: a replay, then the outputs as fresh tensors (the next
        replay overwrites the graph's own)."""
        global GRAPH_REPLAYS
        with profiling.span("fastb.eager", body=self.body, graph=True):
            self.graph.replay()
            out = BStepOut(*(x.clone() for x in self.out))
        GRAPH_REPLAYS += 1
        count_launches(self.launches)
        return out


def _graph_key(arg):
    """An agent keys a graph by its parameters' storages, anything else by
    itself."""
    if isinstance(arg, torch.nn.Module):
        return tuple((p.data_ptr(), tuple(p.shape), p.dtype)
                     for p in arg.parameters())
    return arg


def graphed_step(cfg: SimConfig, fn, args: tuple, st: BState,
                 body: str) -> Optional[GraphedStep]:
    """The graphed stepper of ``fn(cfg, st, *args)`` for states of
    ``st``'s batch and device, captured at its first request and kept, with
    its agents, for the life of the process: an evaluation keeps three, and
    a caller that loads new agents for each evaluation adds two more each
    time.  It is keyed on the step function itself (a patched one is
    captured anew), the configuration, the batch, the device, ``args`` (an
    agent by its parameters' storages) and whether products may run in
    TF32.  ``body`` names the step in its ``fastb.eager`` spans.
    Returns None while the stepper of that key is in use: its input state
    is taken, and the caller steps eagerly."""
    key = (fn, cfg, tuple(st.key.shape), st.key.device,
           tuple(map(_graph_key, args)),
           torch.backends.cuda.matmul.allow_tf32)
    g = _GRAPHS.get(key)
    if g is None:
        g = _GRAPHS[key] = GraphedStep(cfg, fn, args, st, body)
    elif g.busy:
        return None
    return g
