"""Step functions of the three environment variants on the bit-exact
parity engine, batched, in PyTorch.

The port of ``marl_sortingenv_tpu.core.step``: the reference's
``env_1_sort`` / ``env_2_press`` / ``env_monolith`` steps share one
dynamics core (``core/dynamics.py``) parameterized by the action source,
and the monolith's five action-source paths are separate functions.

Signature convention (``N`` envs on the first axis of every leaf)::

    step_x(cfg, state, action, ...) -> (state', StepOut)

``StepOut`` carries obs / reward / terminated and the per-step log fields
the reference records (``info['action']``, the press log codes, the
sorting purity).  Frozen policies inside a step are ``ActorCritic``
modules (``models/mlp.py``), the port's stand-in for the JAX package's
``(apply_fn, params)`` pairs; they act deterministically (the argmax of
their f32 logits, ``agent_argmax``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import dynamics as D
from . import rng as R
from .state import EnvState
from ..config import SimConfig

I32 = torch.int32
F64 = torch.float64


class StepOut(NamedTuple):
    obs: torch.Tensor         # f32 [N, 13/16/29] depending on variant
    reward: torch.Tensor      # f64 [N]
    terminated: torch.Tensor  # bool [N]
    action: torch.Tensor      # i32 [N]: chosen action (info['action'])
    press_log: torch.Tensor   # i32 [N]: executed press code / 111 / 222 / 0
    purity: torch.Tensor      # f64 [N]: sort_material's mean purity
    sort_reward: torch.Tensor  # f64 [N] (the monolith logs both parts)
    press_reward: torch.Tensor  # f64 [N]


def _common_prelude(cfg: SimConfig, st: EnvState) -> EnvState:
    """The input rule's draw and the material flow, first in every
    variant's step."""
    return D.update_environment(cfg, D.input_action_rules(cfg, st))


def _apply_sort(cfg: SimConfig, st: EnvState, sort_mode
                ) -> Tuple[torch.Tensor, EnvState]:
    st = st._replace(sensor_setting=sort_mode.to(I32))
    st = D.update_accuracy(cfg, st)
    return D.sort_material(cfg, st)


def _finish(cfg: SimConfig, st: EnvState):
    st = st._replace(current_step=st.current_step + 1)
    return st, st.current_step >= cfg.max_steps


def agent_argmax(logits: torch.Tensor) -> torch.Tensor:
    """An agent's deterministic action: the first maximum of its logits,
    as ``jnp.argmax`` (int32 [N])."""
    return torch.argmax(logits, dim=-1).to(I32)


def _mlp_predict(agent, obs) -> torch.Tensor:
    """SB3's deterministic ``predict``: the argmax of the logits."""
    with torch.no_grad():
        return agent_argmax(agent.policy_logits(obs))


def _masked_mlp_predict(agent, obs, mask) -> torch.Tensor:
    with torch.no_grad():
        logits = agent.policy_logits(obs)
    neg = torch.finfo(logits.dtype).min
    return agent_argmax(torch.where(mask, logits,
                                    torch.full_like(logits, neg)))


def _zeros64(st: EnvState) -> torch.Tensor:
    return torch.zeros(st.current_step.shape, dtype=F64,
                       device=st.current_step.device)


# ---------------------------------------------------------------------------
# Env_1_Sorting
# ---------------------------------------------------------------------------

def step_sort(cfg: SimConfig, st: EnvState, action
              ) -> Tuple[EnvState, StepOut]:
    """The agent picks the sort mode; the press side takes a random
    masked action from rng_pressing; the reward is the sorting reward."""
    action = torch.as_tensor(action, device=st.current_step.device).to(I32)
    st = _common_prelude(cfg, st)
    purity, st = _apply_sort(cfg, st, action)
    press_id, mat, st = D.sample_masked_press_action(cfg, st)
    log, st = D.press_action_rules(cfg, st, press_id, mat)
    reward = D.calculate_sorting_reward(cfg, st)
    obs = D.get_sort_obs(cfg, st)
    st, terminated = _finish(cfg, st)
    return st, StepOut(obs=obs, reward=reward, terminated=terminated,
                       action=action, press_log=log, purity=purity,
                       sort_reward=reward, press_reward=_zeros64(st))


# ---------------------------------------------------------------------------
# Env_2_Pressing
# ---------------------------------------------------------------------------

def step_press(cfg: SimConfig, st: EnvState, action, sort_policy=None,
               use_action_masking: bool = True
               ) -> Tuple[EnvState, StepOut]:
    """The sort side is driven by the frozen sort agent if given (an
    ``ActorCritic``), else by the rule; the agent's press action runs
    (sanitized when masking is off)."""
    a = torch.as_tensor(action, device=st.current_step.device).to(I32)
    st = _common_prelude(cfg, st)
    if sort_policy is not None:
        sort_mode = _mlp_predict(sort_policy, D.get_sort_obs(cfg, st))
    else:
        sort_mode = D.sorting_rules(st)
    purity, st = _apply_sort(cfg, st, sort_mode)
    if use_action_masking:
        press_id, mat = D.press_discrete_to_action(a)
        log, st = D.press_action_rules(cfg, st, press_id, mat)
    else:
        press_id, mat, _, invalid_code = D.sanitize_press_action(cfg, st, a)
        log, st = D.press_action_rules(cfg, st, press_id, mat)
        log = torch.where(invalid_code != 0, invalid_code, log)
    reward, st = D.calculate_press_reward(cfg, st)
    obs = D.get_press_obs(cfg, st)
    st, terminated = _finish(cfg, st)
    return st, StepOut(obs=obs, reward=reward, terminated=terminated,
                       action=a, press_log=log, purity=purity,
                       sort_reward=_zeros64(st), press_reward=reward)


# ---------------------------------------------------------------------------
# Env_3_Monolith
# ---------------------------------------------------------------------------

def _mono_apply(cfg, st, sort_mode, press_id, mat, skip_press, flat_action):
    """The monolith step after its decision.  ``skip_press`` (bool [N], or
    None for none): an invalid (sanitized) external action skips
    press_action_rules entirely, so the press timers do not tick."""
    purity, st = _apply_sort(cfg, st, sort_mode)
    log, dispatched = D.press_action_rules(cfg, st, press_id, mat)
    if skip_press is None:
        st = dispatched
    else:
        st = R.select(skip_press, st, dispatched)
        log = torch.where(skip_press, 0, log)
    sort_reward = D.calculate_sorting_reward(cfg, st)
    press_reward, st = D.calculate_press_reward(cfg, st)
    obs = D.get_mono_obs(cfg, st)
    st, terminated = _finish(cfg, st)
    return st, StepOut(obs=obs, reward=sort_reward + press_reward,
                       terminated=terminated, action=flat_action.to(I32),
                       press_log=log.to(I32), purity=purity,
                       sort_reward=sort_reward, press_reward=press_reward)


def _mono_flat(cfg, st, a, use_action_masking):
    """Decode a flat monolith action and run it: ``sort = a // 11``,
    ``press = a % 11``; without masking the press part is sanitized and an
    invalid one skips the press dispatch, logging its code."""
    sort_mode, press_disc = a // 11, a % 11
    if use_action_masking:
        press_id, mat = D.press_discrete_to_action(press_disc)
        return _mono_apply(cfg, st, sort_mode, press_id, mat, None, a)
    press_id, mat, skip, inv_code = D.sanitize_press_action(cfg, st,
                                                            press_disc)
    st, out = _mono_apply(cfg, st, sort_mode, press_id, mat, skip, a)
    return st, out._replace(press_log=torch.where(skip, inv_code,
                                                  out.press_log))


def step_mono_external(cfg: SimConfig, st: EnvState, action,
                       use_action_masking: bool = True):
    """Path 1: the flat action from the learner."""
    a = torch.as_tensor(action, device=st.current_step.device).to(I32)
    st = _common_prelude(cfg, st)
    return _mono_flat(cfg, st, a, use_action_masking)


def step_mono_rule(cfg: SimConfig, st: EnvState):
    """Path 4: rule-based sorting + rule-based pressing (the first free
    press x the fullest container)."""
    st = _common_prelude(cfg, st)
    sort_mode = D.sorting_rules(st)
    press_id, mat = D.check_container_level(cfg, st)
    flat = sort_mode * 11 + torch.where(press_id == 0, 0,
                                        (press_id - 1) * 5 + mat + 1)
    return _mono_apply(cfg, st, sort_mode, press_id, mat, None, flat)


def _mono_decide_model(cfg, st, sort_policy, press_policy,
                       use_action_masking, press_is_maskable):
    """Path 5: the modular agents with random fallbacks (rng_sorting /
    rng_pressing), both acting on the post-update state."""
    st = _common_prelude(cfg, st)
    if sort_policy is not None:
        sort_mode = _mlp_predict(sort_policy, D.get_sort_obs(cfg, st))
    else:
        # fallback: rng_sorting.choice([0, 1])
        idx, rs = R.choice_n(st.rng_sorting, 2)
        sort_mode = idx.to(I32)
        st = st._replace(rng_sorting=rs)

    if press_policy is not None:
        press_obs = D.get_press_obs(cfg, st)
        if use_action_masking and press_is_maskable:
            press_disc = _masked_mlp_predict(
                press_policy, press_obs, D.press_action_masks(cfg, st))
        else:
            press_disc = _mlp_predict(press_policy, press_obs)
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
    return st, sort_mode, press_disc


def step_mono_model(cfg: SimConfig, st: EnvState, sort_policy=None,
                    press_policy=None, use_action_masking: bool = True,
                    press_is_maskable: bool = True):
    st, sort_mode, press_disc = _mono_decide_model(
        cfg, st, sort_policy, press_policy, use_action_masking,
        press_is_maskable)
    press_id, mat = D.press_discrete_to_action(press_disc)
    return _mono_apply(cfg, st, sort_mode, press_id, mat, None,
                       sort_mode * 11 + press_disc)


def step_mono_policy(cfg: SimConfig, st: EnvState, agent,
                     use_action_masking: bool = True):
    """The benchmark's monolith scenario: ``agent`` (an ``ActorCritic``)
    predicts on the previous step's observation (masked iff masking is
    on) and its flat action goes through the external path."""
    obs = D.get_mono_obs(cfg, st)
    if use_action_masking:
        flat = _masked_mlp_predict(agent, obs,
                                   D.monolith_action_masks(cfg, st))
    else:
        flat = _mlp_predict(agent, obs)
    return step_mono_external(cfg, st, flat, use_action_masking)


def step_mono_agent(cfg: SimConfig, st: EnvState, agent,
                    use_action_masking: bool = True):
    """Path 2: the internally stored monolith agent, a masked
    deterministic predict on the combined obs (the reference passes the
    mask on this path whatever the masking flag says)."""
    st = _common_prelude(cfg, st)
    flat = _masked_mlp_predict(agent, D.get_mono_obs(cfg, st),
                               D.monolith_action_masks(cfg, st))
    press_id, mat = D.press_discrete_to_action(flat % 11)
    return _mono_apply(cfg, st, flat // 11, press_id, mat, None, flat)
