"""The whole fastb env step as one hand-written CUDA kernel.

Replaces the TPU kernel ``marl_sortingenv_tpu/ops/step_pallas.py::step_mono``.
The kernel (``csrc/step_mono.cu``, CUDA C++ for sm_90a) computes, bit for
bit, what the eager step of ``core/fastb.py`` computes, for every variant
('rule', 'external', 'sort', 'press'), masked flag and autoreset flag.  It
returns the pre-tanh sorting-reward argument; the wrapper applies the tanh
as the eager step does.  It comes in the designs of ``STEP_DESIGNS``,
its own list (a group of ``lanes`` lanes per env, supports up to ``cap``):
exactly those of the table that the card's timings chose (``PERF.md``),
from which ``lanes_for(support, n)`` picks one.

``step_mono`` launches the kernel for a state on CUDA and runs the plain
version ``step_mono_plain`` for a state on the CPU.  ``LAUNCHES`` counts
the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config.config import SimConfig
from ..core import fastb as FB
from ..utils import profiling
from ._build import DesignSet

LAUNCHES = 0

_VARIANT_ID = {"rule": 0, "external": 1, "sort": 2, "press": 3}
_OBS_ROWS = {"sort": 13, "press": 16}

IN_NAMES = ("input_counts", "belt_counts", "acc_belt", "input_occupancy",
            "cont_true", "cont_false", "press_timer", "press_mat", "press_n",
            "press_q", "ev_mat", "ev_n", "ev_q", "ev_cnt",
            "last_press_started", "last_press_amount", "gen_pattern_first",
            "gen_pattern_idx", "gen_step_counter", "current_step",
            "total_input_units", "key")            # then the action
STATE_OUT = ("input_counts", "belt_counts", "sort_counts", "acc_belt",
             "acc_sorter", "sensor_setting", "input_occupancy",
             "belt_occupancy", "cont_true", "cont_false", "press_timer",
             "press_mat", "press_n", "press_q", "ev_mat", "ev_n", "ev_q",
             "ev_cnt", "last_press_started", "last_press_amount",
             "gen_pattern_first", "gen_pattern_idx", "gen_step_counter",
             "current_step", "total_input_units", "key")
EXTRA_OUT = ("obs", "raw_sort", "press_reward", "purity", "action", "term")


# the designs csrc/step_mono.cu builds (STEP_DESIGNS there)
STEP_DESIGNS = ((1, 16), (8, 16), (16, 16), (8, 32), (16, 32), (8, 64),
                (16, 64), (16, 128))
DESIGN_SET = DesignSet(STEP_DESIGNS, FB._HG_SUPPORT)

# lanes_for's table (see _build.DesignSet.pick), from the design sweep of
# chip_smoke.py on an H100 (PERF.md): the fastest design at 4096, 8192,
# 16384, 32768 and 65536 envs, switching halfway between measured widths.
# Wide groups win while the batch fits in one wave of the card; past that
# their registers times lanes cost more waves than the shorter chain saves.
# Supports 33-64 take the rows measured at support 40, 65-104 those at 88.
LANES_TABLE = ((16, 12288, (1, 16)), (16, 6144, (8, 16)), (16, 0, (16, 16)),
               (32, 6144, (8, 32)), (32, 0, (16, 32)),
               (64, 6144, (8, 64)), (64, 0, (16, 64)), (104, 0, (16, 128)))


def lanes_for(support: int, n: int) -> tuple:
    """The step kernel's design ``(lanes, cap)`` for ``support`` and ``n``
    envs."""
    return DESIGN_SET.pick(LANES_TABLE, support, n)


class StepConsts(ctypes.Structure):
    """Mirror of ``struct StepConsts`` in csrc/step_mono.cu."""
    _fields_ = (
        [(nm, ctypes.c_int) for nm in ("n", "E", "steps_per_pattern")]
        + [("units0", ctypes.c_int * 4), ("units1", ctypes.c_int * 4)]
        + [(nm, ctypes.c_int) for nm in (
            "rem0", "rem1", "balesize", "press_time_1", "press_time_2",
            "max_steps", "variant", "masked", "autoreset", "support")]
        + [("base_acc", ctypes.c_float * 4)]
        + [(nm, ctypes.c_float) for nm in (
            "boost", "noise", "noise_lo", "noise_span", "quality_threshold",
            "theta", "sort_scale", "recip_cap", "recip_stage", "recip_pt1",
            "recip_pt2", "recip_100", "pen_severe", "pen_mild",
            "pen_catastrophic", "state_scale", "dist_scale", "bale_eff",
            "third", "two_thirds")])


@functools.lru_cache(maxsize=64)
def _consts(cfg: SimConfig, n: int, variant: str, masked: bool,
            autoreset: bool) -> StepConsts:
    """Host constants, computed in f32 as the eager step computes them.
    Cached: the launcher only reads the structure."""
    f = np.float32
    u0, u1, r0, r1 = FB._pattern_units(cfg)
    rk = FB._press_reward_consts(cfg)
    noise = f(cfg.effective_noise)
    c = StepConsts()
    c.n, c.E, c.steps_per_pattern = n, cfg.max_press_events, \
        cfg.steps_per_pattern
    c.units0[:] = u0
    c.units1[:] = u1
    c.rem0, c.rem1 = r0, r1
    c.balesize = cfg.effective_balesize
    c.press_time_1, c.press_time_2 = cfg.press_time_1, cfg.press_time_2
    c.max_steps = cfg.max_steps
    c.variant = _VARIANT_ID[variant]
    c.masked, c.autoreset = int(masked), int(autoreset)
    c.support = FB._support_for(cfg)
    c.base_acc[:] = [f(a) for a in cfg.baseline_accuracy]
    c.boost = f(cfg.boost)
    c.noise = noise
    c.noise_lo = f(-cfg.effective_noise)
    c.noise_span = f(cfg.effective_noise) - f(-cfg.effective_noise)
    c.quality_threshold = f(cfg.quality_threshold)
    c.theta = f(cfg.purity_threshold_theta)
    c.sort_scale = f(0.25) * f(cfg.purity_scaling_factor)
    c.recip_cap = rk["recip_cap"]
    c.recip_stage = f(1.0) / f(cfg.stage_capacity)
    c.recip_pt1 = f(1.0) / f(cfg.press_time_1)
    c.recip_pt2 = f(1.0) / f(cfg.press_time_2)
    c.recip_100 = f(1.0) / f(100.0)
    c.pen_severe = f(cfg.overflow_penalty_severe)
    c.pen_mild = f(cfg.overflow_penalty_mild)
    c.pen_catastrophic = f(cfg.overflow_penalty_catastrophic)
    c.state_scale = rk["state_scale"]
    c.dist_scale = rk["dist_scale"]
    c.bale_eff = f(cfg.bale_efficiency_factor)
    c.third, c.two_thirds = f(1.0 / 3.0), f(2.0 / 3.0)
    return c


def _library():
    from . import _build
    lib = _build.load("step_mono")
    if not getattr(lib, "_step_mono_bound", False):
        lib.step_mono_consts_size.restype = ctypes.c_int
        lib.step_mono_consts_size.argtypes = []
        lib.step_mono_n_ptrs.restype = ctypes.c_int
        lib.step_mono_n_ptrs.argtypes = []
        lib.step_mono_launch.restype = ctypes.c_int
        lib.step_mono_launch.argtypes = [
            ctypes.POINTER(StepConsts), ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        DESIGN_SET.bind(lib, "step_mono")
        if lib.step_mono_consts_size() != ctypes.sizeof(StepConsts):
            raise RuntimeError("StepConsts layout differs from step_mono.cu")
        want = (len(IN_NAMES) + 1) * 100 + len(STATE_OUT) + len(EXTRA_OUT)
        if lib.step_mono_n_ptrs() != want:
            raise RuntimeError("pointer lists differ from step_mono.cu")
        lib._step_mono_bound = True
    return lib


_I32, _F32 = torch.int32, torch.float32
# (leading rows, dtype) of every leaf the kernel reads or writes: rows 0
# means (N,), "E" the event log's (E, N), "key" (N, 2), "obs" (N, rows)
_LEAVES = {
    "input_counts": (4, _I32), "belt_counts": (4, _I32),
    "sort_counts": (4, _I32), "acc_belt": (4, _F32), "acc_sorter": (4, _F32),
    "sensor_setting": (0, _I32), "input_occupancy": (0, _F32),
    "belt_occupancy": (0, _F32), "cont_true": (5, _I32),
    "cont_false": (4, _I32), "press_timer": (2, _I32),
    "press_mat": (2, _I32), "press_n": (2, _I32), "press_q": (2, _F32),
    "ev_mat": ("E", torch.int16), "ev_n": ("E", torch.int16),
    "ev_q": ("E", torch.int16), "ev_cnt": (0, _I32),
    "last_press_started": (0, torch.bool), "last_press_amount": (0, _I32),
    "gen_pattern_first": (0, _I32), "gen_pattern_idx": (0, _I32),
    "gen_step_counter": (0, _I32), "current_step": (0, _I32),
    "total_input_units": (0, _I32), "key": ("key", _I32),
    "obs": ("obs", _F32), "raw_sort": (0, _F32), "press_reward": (0, _F32),
    "purity": (0, _F32), "action": (0, _I32), "term": (0, torch.bool),
}


def _shape(name: str, n: int, E: int, variant: str) -> tuple:
    rows = _LEAVES[name][0]
    if rows == 0:
        return (n,)
    return {"E": (E, n), "key": (n, 2),
            "obs": (n, _OBS_ROWS.get(variant, 29))}.get(rows, (rows, n))


@profiling.spanned("step_mono.launch")
def step_mono_kernel(cfg: SimConfig, st: FB.BState, action, *, variant: str,
                     masked: bool = True, autoreset: bool = False,
                     design=None):
    """One step of every env of ``st`` (on CUDA) through the kernel.
    ``design`` is a ``(lanes, cap)`` of ``STEP_DESIGNS``; by default
    ``lanes_for(support, N)``."""
    global LAUNCHES
    FB._require_events(cfg)
    if variant not in _VARIANT_ID:
        raise ValueError(f"unknown variant {variant!r}")
    dev = st.current_step.device
    if dev.type != "cuda":
        raise ValueError(f"the step kernel needs a CUDA state, got {dev}")
    n, E = st.current_step.shape[0], cfg.max_press_events
    if n < 1:
        raise ValueError("the step kernel needs at least one env")
    support = FB._support_for(cfg)
    lanes, cap = DESIGN_SET.check_design(
        lanes_for(support, n) if design is None else design, support)
    for name in IN_NAMES:
        x, shape, dtype = getattr(st, name), _shape(name, n, E, variant), \
            _LEAVES[name][1]
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"state.{name}: expected {dtype} {shape} on {dev}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"state.{name} must be contiguous")
    ins = [getattr(st, name) for name in IN_NAMES]
    if variant == "rule":
        ins.append(None)
    else:
        a = torch.as_tensor(action, device=dev).to(torch.int32).contiguous()
        if tuple(a.shape) != (n,):
            raise ValueError(f"action must have shape ({n},), got "
                             f"{tuple(a.shape)}")
        ins.append(a)
    out = {name: torch.empty(_shape(name, n, E, variant),
                             dtype=_LEAVES[name][1], device=dev)
           for name in STATE_OUT + EXTRA_OUT}

    in_ptrs = (ctypes.c_void_p * len(ins))(
        *[None if x is None else x.data_ptr() for x in ins])
    out_ptrs = (ctypes.c_void_p * len(out))(*[x.data_ptr()
                                              for x in out.values()])
    consts = _consts(cfg, n, variant, masked, autoreset)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.step_mono_launch(ctypes.byref(consts), in_ptrs, out_ptrs,
                                  lanes, cap, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"step_mono kernel launch failed: cudaError_t {rc}")
    LAUNCHES += 1

    new_st = FB.BState(bale_size=None, bale_qual=None, bale_cnt=None,
                       **{nm: out[nm] for nm in STATE_OUT})
    sr = FB.sorting_reward_from_arg(cfg, out["raw_sort"])
    pr = out["press_reward"]
    if variant == "sort":
        reward, srr, prr = sr, sr, torch.zeros_like(sr)
    elif variant == "press":
        reward, srr, prr = pr, torch.zeros_like(pr), pr
    else:
        reward, srr, prr = sr + pr, sr, pr
    return new_st, FB.BStepOut(obs=out["obs"], reward=reward,
                               terminated=out["term"], action=out["action"],
                               sort_reward=srr, press_reward=prr,
                               purity=out["purity"])


def step_mono_plain(cfg: SimConfig, st: FB.BState, action, *, variant: str,
                    masked: bool = True, autoreset: bool = False):
    """The kernel's plain PyTorch version: the eager fastb step, plus
    ``with_autoreset`` when ``autoreset`` is set.  It runs on the state's
    device."""
    FB._require_events(cfg)
    body = FB.eager_step(variant, masked)
    if autoreset:
        return FB.with_autoreset(cfg, body)(st, action)
    return body(cfg, st, action)


def step_mono(cfg: SimConfig, st: FB.BState, action, *, variant: str,
              masked: bool = True, autoreset: bool = False):
    """One env step: the CUDA kernel for a state on CUDA, the plain version
    for a state on the CPU.  Any other device raises."""
    dev = st.current_step.device
    if dev.type == "cuda":
        return step_mono_kernel(cfg, st, action, variant=variant,
                                masked=masked, autoreset=autoreset)
    if dev.type == "cpu":
        return step_mono_plain(cfg, st, action, variant=variant,
                               masked=masked, autoreset=autoreset)
    raise ValueError(f"step_mono runs on CUDA or the CPU, got {dev}")
