"""Auto-reset, overflow termination and rollouts around the parity
engine's steps, in PyTorch.

The port of ``marl_sortingenv_tpu.core.wrappers``.  The step functions of
``core/step.py`` are batched already (``N`` envs on the first axis), so
``batched_step`` only adds the auto-reset, and where the JAX package
``lax.scan``\\ s over time the port loops over the steps in Python.

Auto-reset: a terminated env is reset in the call that reports its
terminal step.  Its plant state is zeroed, its five RNG streams keep
running and its pattern permutation is redrawn from the continuing
generator stream, as in the JAX package (deterministic, where the
reference's unseeded reset is not).
"""

from __future__ import annotations

from typing import Callable

import torch

from . import dynamics as D
from . import rng as R
from .state import EnvState, _pattern_seq
from ..config.config import SimConfig

I32 = torch.int32
F64 = torch.float64


def autoreset(cfg: SimConfig, st: EnvState) -> EnvState:
    """Every env's plant state reset, its RNG streams kept (see the
    module docstring)."""
    j, gen_rng = R.random_interval32(st.gen_rng, 1)
    n, dev = st.current_step.shape[0], st.current_step.device

    def z(*dims, dtype=I32):
        return torch.zeros((n,) + dims, dtype=dtype, device=dev)

    base_acc = D._const(tuple(cfg.baseline_accuracy), dev).expand(n, 4)
    return st._replace(
        input_counts=z(4), belt_counts=z(4), sort_counts=z(4),
        acc_belt=base_acc, acc_sorter=base_acc,
        sensor_setting=z(), input_occupancy=z(dtype=F64),
        belt_occupancy=z(dtype=F64),
        cont_true=z(5), cont_false=z(4),
        press_timer=z(2), press_mat=z(2), press_n=z(2),
        press_q=z(2, dtype=F64),
        bale_size=z(5, cfg.max_bales), bale_qual=z(5, cfg.max_bales),
        bale_cnt=z(5),
        last_press_started=z(dtype=torch.bool), last_press_amount=z(),
        press_penalty_flag=z(),
        gen_pattern_seq=_pattern_seq(j), gen_pattern_idx=z(),
        gen_step_counter=z(), current_step=z(), total_input_units=z(),
        gen_rng=gen_rng)


def _reset_where(cfg: SimConfig, st: EnvState, done: torch.Tensor):
    """``st`` with the envs of ``done`` reset; nothing is built when no
    env is done (one host read)."""
    if not R.host_any(done):
        return st
    return R.select(done, autoreset(cfg, st), st)


def with_autoreset(cfg: SimConfig, step_fn: Callable):
    """Wrap a step ``(cfg, st, action) -> (st, out)`` so that terminated
    envs reset in place; ``out`` is the terminal step's output."""

    def stepped(st, action):
        st, out = step_fn(cfg, st, action)
        return _reset_where(cfg, st, out.terminated), out

    return stepped


def with_overflow_termination(cfg: SimConfig, step_fn: Callable,
                              variant: str = "mono"):
    """``step(check_overflow=True)`` semantics: if any container exceeds
    its capacity after the step, the episode terminates with
    ``overflow_termination_penalty``, logged as (0, pen) for the sort and
    press envs and (pen/2, pen/2) for the monolith.  As in the JAX
    package, the already-computed rewards are replaced (the reference
    checks before computing them; the flag difference matters only after
    termination)."""
    pen = float(cfg.overflow_termination_penalty)

    def stepped(st, action):
        st, out = step_fn(cfg, st, action)
        overflow = D.detect_overflow(cfg, st)
        if variant == "mono":
            sr = torch.where(overflow, pen / 2.0, out.sort_reward)
            pr = torch.where(overflow, pen / 2.0, out.press_reward)
        else:
            sr = torch.where(overflow, 0.0, out.sort_reward)
            pr = torch.where(overflow, pen, out.press_reward)
        return st, out._replace(
            reward=torch.where(overflow, pen, out.reward),
            sort_reward=sr, press_reward=pr,
            terminated=out.terminated | overflow)

    return stepped


def batched_step(cfg: SimConfig, step_fn: Callable, auto_reset: bool = True):
    """The batched step ``(st, actions) -> (st, out)``, with auto-reset
    unless ``auto_reset`` is False."""
    if auto_reset:
        return with_autoreset(cfg, step_fn)
    return lambda st, a: step_fn(cfg, st, a)


def _stack(outs):
    return type(outs[0])(*(torch.stack(xs) for xs in zip(*outs)))


def rollout(cfg: SimConfig, step_fn: Callable, st: EnvState, actions,
            auto_reset: bool = True):
    """Step the batch through ``actions`` [T, N].  Returns (final state,
    the StepOut fields stacked [T, N, ...])."""
    step = batched_step(cfg, step_fn, auto_reset)
    outs = []
    for a in actions:
        st, out = step(st, a)
        outs.append(out)
    return st, _stack(outs)


def rollout_policy(cfg: SimConfig, step_fn: Callable, st: EnvState,
                   policy_fn: Callable, obs0, pstate0, n_steps: int,
                   auto_reset: bool = True):
    """Closed-loop rollout: ``policy_fn(obs_batch, mask_batch, pstate) ->
    (actions, aux, pstate')`` picks each step's actions on the device (the
    masks are ``press_action_masks``, as in the JAX package).  Returns
    ((state, obs, pstate), (outs, actions, aux)), each stacked [T, ...]."""
    step = batched_step(cfg, step_fn, auto_reset)
    obs, pstate = obs0, pstate0
    ys = []
    for _ in range(n_steps):
        actions, aux, pstate = policy_fn(obs, D.press_action_masks(cfg, st),
                                         pstate)
        st, out = step(st, actions)
        obs = out.obs
        ys.append((out, actions, aux))
    outs = _stack([y[0] for y in ys])
    return (st, obs, pstate), (outs, torch.stack([y[1] for y in ys]),
                               _stack_tree([y[2] for y in ys]))


def _stack_tree(xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    if isinstance(xs[0], tuple):
        return type(xs[0])(*(_stack_tree(list(c)) for c in zip(*xs)))
    if isinstance(xs[0], dict):
        return {k: _stack_tree([x[k] for x in xs]) for k in xs[0]}
    return xs
