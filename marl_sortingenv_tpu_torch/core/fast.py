"""The per-env fast engine, as a batch-first view over ``core/fastb.py``.

The port of ``marl_sortingenv_tpu.core.fast``: the same f32/i32/threefry
dynamics with the env batch on the FIRST axis of every state leaf
(``FastEnvState``: counts ``(N, 4)``, containers ``(N, 5)``, bales
``(N, 5, MAX)``).  The JAX package writes it per env and its callers
``vmap`` it; here every function takes a batch-first state, and an
unbatched call is a batch of one.

JAX holds ``fast`` equal to ``fastb`` bit for bit (``tests/test_fastb.py``)
and ``fast`` keeps the bale buffers whatever ``cfg.bale_mode`` says, so
each function converts its state with ``fastb.from_batch_first``, runs the
``fastb`` function in full-bale mode and converts back with
``fastb.to_batch_first``.  A full-bale-mode step is ``fastb``'s eager body,
so on CUDA its sorting core runs on the sorting-core kernel
(``ops/sort_cuda.py``) and on the CPU on its plain version
(``tests/test_torch_fast.py`` holds the view to JAX's ``vmap``ped engine).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import resolve_device
from ..config.config import SimConfig
from . import fastb as FB
from . import threefry as TF

_HG_SUPPORT = FB._HG_SUPPORT


def _check_support(cfg: SimConfig) -> None:
    """Refuse a config whose largest hypergeometric draw could pass the
    sampler's support (the bound of ``fastb._support_for``)."""
    bs = cfg.input_batch_size
    max_target = int(0.40 * bs) + 4
    min_acc = max(0.0, min(cfg.baseline_accuracy) - cfg.effective_noise)
    max_false = int(max_target * (1.0 - min_acc) + 0.5) + 1
    if max_false + 2 > _HG_SUPPORT:
        raise ValueError(
            f"hypergeometric support bound {max_false + 2} exceeds the "
            f"fast engine cap {_HG_SUPPORT}: config is outside the "
            "sampling domain (input_batch_size/baseline_accuracy/noise)")


class FastEnvState(NamedTuple):
    """``fastb.BState`` in full-bale mode with the batch on axis 0."""
    input_counts: torch.Tensor   # i32[N, 4]
    belt_counts: torch.Tensor    # i32[N, 4]
    sort_counts: torch.Tensor    # i32[N, 4]
    acc_belt: torch.Tensor       # f32[N, 4]
    acc_sorter: torch.Tensor     # f32[N, 4]
    sensor_setting: torch.Tensor  # i32[N]
    input_occupancy: torch.Tensor  # f32[N]
    belt_occupancy: torch.Tensor   # f32[N]
    cont_true: torch.Tensor      # i32[N, 5]
    cont_false: torch.Tensor     # i32[N, 4]
    press_timer: torch.Tensor    # i32[N, 2]
    press_mat: torch.Tensor      # i32[N, 2]
    press_n: torch.Tensor        # i32[N, 2]
    press_q: torch.Tensor        # f32[N, 2]
    bale_size: torch.Tensor      # i16[N, 5, MAX]
    bale_qual: torch.Tensor      # i16[N, 5, MAX]
    bale_cnt: torch.Tensor       # i32[N, 5]
    last_press_started: torch.Tensor  # bool[N]
    last_press_amount: torch.Tensor   # i32[N]
    gen_pattern_first: torch.Tensor   # i32[N]
    gen_pattern_idx: torch.Tensor     # i32[N]
    gen_step_counter: torch.Tensor    # i32[N]
    current_step: torch.Tensor        # i32[N]
    total_input_units: torch.Tensor   # i32[N]
    key: torch.Tensor                 # i32[N, 2] threefry key words


class FastStepOut(NamedTuple):
    obs: torch.Tensor          # f32[N, obs_dim]
    reward: torch.Tensor       # f32[N]
    terminated: torch.Tensor   # bool[N]
    action: torch.Tensor       # i32[N]
    sort_reward: torch.Tensor  # f32[N]
    press_reward: torch.Tensor  # f32[N]
    purity: torch.Tensor       # f32[N]


@functools.lru_cache(maxsize=32)
def _full(cfg: SimConfig) -> SimConfig:
    return cfg if cfg.bale_mode == "full" else cfg.with_(bale_mode="full")


def _batched(fn):
    """``fn(cfg, BState, ...)`` as a function of a ``FastEnvState``."""
    @functools.wraps(fn)
    def view(cfg: SimConfig, st: FastEnvState, *args, **kw):
        return fn(_full(cfg), FB.from_batch_first(st), *args, **kw)
    return view


def _stepper(fn):
    """``fn(cfg, BState, ...) -> (BState, BStepOut)`` as a step of
    ``FastEnvState``."""
    view = _batched(fn)

    @functools.wraps(fn)
    def step(cfg: SimConfig, st: FastEnvState, *args, **kw):
        st, out = view(cfg, st, *args, **kw)
        return FB.to_batch_first(st), FastStepOut(*out)
    return step


def reset(cfg: SimConfig, key: torch.Tensor) -> FastEnvState:
    """Fresh states from threefry keys: ``int32[N, 2]`` gives N envs,
    ``int32[2]`` a batch of one.  The states lie on the keys' device."""
    _check_support(cfg)
    keys = key.to(torch.int32)
    if keys.dim() == 1:
        keys = keys[None]
    return FB.to_batch_first(FB._reset_from_keys(_full(cfg), keys))


def reset_batch(cfg: SimConfig, key, n: int, device="cuda") -> FastEnvState:
    """``n`` fresh envs from ``key`` (an int seed or an ``int32[2]`` key),
    with the keys ``split(key, n)``: the envs of ``fastb.reset_batch``."""
    dev = resolve_device(device)
    if isinstance(key, int):
        key = TF.prng_key(key, dev)
    key = key.to(device=dev, dtype=torch.int32)
    return reset(cfg, TF.split(key[None], n)[0])


press_action_masks = _batched(FB.press_action_masks)          # bool[N, 11]
monolith_action_masks = _batched(FB.monolith_action_masks)    # bool[N, 22]
get_sort_obs = _batched(FB.get_sort_obs)                      # f32[N, 13]
get_press_obs = _batched(FB.get_press_obs)                    # f32[N, 16]
get_mono_obs = _batched(FB.get_mono_obs)                      # f32[N, 29]

step_sort = _stepper(FB.step_sort)
step_press = _stepper(FB.step_press)
step_mono_external = _stepper(FB.step_mono_external)
step_mono_rule = _stepper(FB.step_mono_rule)
step_mono_model = _stepper(FB.step_mono_model)
step_mono_random = _stepper(FB.step_mono_random)


def autoreset(cfg: SimConfig, st: FastEnvState) -> FastEnvState:
    return reset(cfg, st.key)


def with_autoreset(cfg: SimConfig, step_fn):
    """``step_fn(cfg, st, action)`` on batch-first states; the envs it
    terminates restart from their keys."""
    def stepped(st, action):
        st, out = step_fn(cfg, st, action)
        fresh = autoreset(cfg, st)
        t = out.terminated
        st = FastEnvState(*(
            torch.where(t.reshape((-1,) + (1,) * (a.dim() - 1)), b, a)
            for a, b in zip(st, fresh)))
        return st, out
    return stepped
