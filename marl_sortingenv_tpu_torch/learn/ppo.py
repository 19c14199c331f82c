"""Policy evaluation on the batch-last engine — the first part of the port
of ``marl_sortingenv_tpu.learn.ppo``.

``VariantSpec`` / ``spec_for`` describe an env variant to the learner, and
``evaluate`` is SB3's ``evaluate_policy``: deterministic (masked) argmax
actions of an ``ActorCritic`` on ``n_envs`` envs for ``n_steps`` steps,
returning each env's return.  Only the ``fastb`` engine is ported; the
rollout buffer, GAE, the PPO update and the trainer come in later slices
(ROADMAP.md Queue 1, item 4).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from ..config.config import SimConfig
from ..core import fastb as FB
from ..models import mlp


def _todo(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md Queue 1, item 4)")


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """Learner-facing description of one env variant.  The port has the
    batch-last ``engine='fastb'`` only."""
    name: str                 # 'sort' | 'press' | 'mono'
    obs_dim: int
    n_actions: int
    use_mask: bool
    engine: str = "fastb"

    def __post_init__(self):
        if self.engine != "fastb":
            _todo(f"engine={self.engine!r}")

    def mask_fn(self, cfg: SimConfig, st: FB.BState):
        if self.name == "press":
            return FB.press_action_masks(cfg, st)
        if self.name == "mono":
            return FB.monolith_action_masks(cfg, st)
        return torch.ones((st.current_step.shape[0], self.n_actions),
                          dtype=torch.bool, device=st.current_step.device)

    def obs_fn(self, cfg: SimConfig, st: FB.BState):
        if self.name == "sort":
            return FB.get_sort_obs(cfg, st)
        if self.name == "press":
            return FB.get_press_obs(cfg, st)
        return FB.get_mono_obs(cfg, st)

    def step_fn(self, sort_policy=None, use_action_masking=True):
        if self.name == "sort":
            return FB.step_sort
        if self.name == "press":
            return lambda cfg, st, a: FB.step_press(
                cfg, st, a, sort_policy, use_action_masking)
        return lambda cfg, st, a: FB.step_mono_external(
            cfg, st, a, use_action_masking)

    def reset_batch(self, cfg: SimConfig, n_envs: int, seed0: int = 0,
                    device="cuda"):
        return FB.reset_batch(cfg, seed0, n_envs, device=device)


SORT_SPEC = VariantSpec("sort", 13, 2, use_mask=False)
PRESS_SPEC = VariantSpec("press", 16, 11, use_mask=True)
MONO_SPEC = VariantSpec("mono", 29, 22, use_mask=True)


def spec_for(name: str, engine: str = "fastb") -> VariantSpec:
    base = {"sort": SORT_SPEC, "press": PRESS_SPEC, "mono": MONO_SPEC}[name]
    return dataclasses.replace(base, engine=engine)


@torch.no_grad()
def evaluate(cfg: SimConfig, spec: VariantSpec, params: mlp.ActorCritic,
             n_envs: int, n_steps: int, seed0: int = 10_000,
             sort_policy=None, use_action_masking: bool = True,
             deterministic: bool = True, device="cuda") -> torch.Tensor:
    """SB3 ``evaluate_policy`` equivalent: run episodes with the
    deterministic policy, return per-env cumulative rewards f32[n_envs].
    Episodes run without autoreset; rewards after an env's first terminal
    step do not count."""
    if not deterministic:
        _todo("evaluate(deterministic=False)")
    dev = resolve_device(device)
    step_fn = spec.step_fn(sort_policy, use_action_masking)
    st = spec.reset_batch(cfg, n_envs, seed0, device=dev)
    obs = spec.obs_fn(cfg, st)
    total = torch.zeros(n_envs, dtype=torch.float32, device=dev)
    alive = torch.ones(n_envs, dtype=torch.bool, device=dev)
    for _ in range(n_steps):
        logits = params.policy_logits(obs)
        if use_action_masking:
            # SB3 predict receives the mask only when masking is enabled;
            # without it the env sanitizes invalid actions
            logits = mlp.masked_logits(logits, spec.mask_fn(cfg, st))
        action = torch.argmax(logits, dim=-1).to(torch.int32)
        st, out = step_fn(cfg, st, action)
        total = total + out.reward * alive.to(total.dtype)
        alive = alive & ~out.terminated
        obs = out.obs
    return total
