"""The PPO learner's plain version: a frozen copy of the port's
``learn/ppo.py`` on the ``fastb`` engine's plain version, in one process.

The learner's key chain (``TrainState.key``, on the CPU), the
Gumbel-max action draws, the minibatch permutation, SB3's GAE and clipped
loss, and ``optax``'s ``clip_by_global_norm`` + ``adam`` over one flat
parameter vector (``ClipAdam``), as the port computes them.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple

import torch

from . import fastb as FB
from . import mlp
from . import threefry as TF
from ._device import resolve_device
from .config import SimConfig

F32, I32 = torch.float32, torch.int32


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    n_steps: int = 2048          # steps per env per iteration
    batch_size: int = 64         # minibatch size (flattened samples)
    n_epochs: int = 10
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_range: float = 0.2
    ent_coef: float = 0.05       # reference training.py:128/140
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    learning_rate: float = 3e-4
    adam_eps: float = 1e-5
    normalize_advantage: bool = True
    # minibatch shuffle granularity: 1 = a uniform permutation of all T*N
    # samples per epoch (SB3); B > 1 permutes contiguous B-sample blocks of
    # the [T, N]-flattened batch (B envs at one timestep).  Falls back to 1
    # when B does not divide the batch or the minibatch.
    shuffle_block: int = 1

@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """Learner-facing description of one env variant on the fastb
    engine."""
    name: str                 # 'sort' | 'press' | 'mono'
    obs_dim: int
    n_actions: int
    use_mask: bool

    def mask_fn(self, cfg: SimConfig, st):
        if self.name == "press":
            return FB.press_action_masks(cfg, st)
        if self.name == "mono":
            return FB.monolith_action_masks(cfg, st)
        return torch.ones((st.current_step.shape[0], self.n_actions),
                          dtype=torch.bool, device=st.current_step.device)

    def obs_fn(self, cfg: SimConfig, st):
        if self.name == "sort":
            return FB.get_sort_obs(cfg, st)
        if self.name == "press":
            return FB.get_press_obs(cfg, st)
        return FB.get_mono_obs(cfg, st)

    def step_fn(self, sort_policy=None, use_action_masking=True):
        """``(cfg, st, action) -> (st, out)``.  ``sort_policy`` (press only)
        is a frozen sort agent, an ``ActorCritic``."""
        if self.name == "sort":
            return FB.step_sort
        if self.name == "press":
            return lambda cfg, st, a: FB.step_press(
                cfg, st, a, sort_policy, use_action_masking)
        return lambda cfg, st, a: FB.step_mono_external(
            cfg, st, a, use_action_masking)

    def reset_batch(self, cfg: SimConfig, n_envs: int, seed0: int = 0,
                    device="cuda"):
        """``n_envs`` fresh envs from the threefry key of ``seed0``."""
        return FB.reset_batch(cfg, seed0, n_envs, device=device)

    def batched_obs(self, cfg: SimConfig):
        return lambda st: self.obs_fn(cfg, st)

    def batched_masks(self, cfg: SimConfig):
        return lambda st: self.mask_fn(cfg, st)

    def batched_autoreset_step(self, cfg: SimConfig, step_fn):
        """The rollout's step: ``with_autoreset`` over ``step_fn``."""
        return FB.with_autoreset(cfg, step_fn)


SORT_SPEC = VariantSpec("sort", 13, 2, use_mask=False)
PRESS_SPEC = VariantSpec("press", 16, 11, use_mask=True)
MONO_SPEC = VariantSpec("mono", 29, 22, use_mask=True)


def spec_for(name: str) -> VariantSpec:
    return {"sort": SORT_SPEC, "press": PRESS_SPEC, "mono": MONO_SPEC}[name]


class Transition(NamedTuple):
    """Rollout buffer, batch-last for obs and mask (the update's layout)."""
    obs: torch.Tensor      # [T, obs_dim, N] f32
    mask: torch.Tensor     # [T, A, N] bool
    action: torch.Tensor   # [T, N] i32
    logp: torch.Tensor     # [T, N] f32
    value: torch.Tensor    # [T, N] f32
    reward: torch.Tensor   # [T, N] f32
    done: torch.Tensor     # [T, N] bool


class AdamState(NamedTuple):
    count: torch.Tensor    # i32 scalar
    mu: torch.Tensor       # f32, one entry per parameter
    nu: torch.Tensor


class TrainState(NamedTuple):
    params: mlp.ActorCritic
    opt_state: AdamState
    env_state: FB.BState
    obs: torch.Tensor            # [N, obs_dim]
    key: torch.Tensor            # int32[2] threefry key, on the CPU
    # running episode-return accumulators (device-side Monitor), f32
    ep_return_acc: torch.Tensor  # [N]
    last_ep_return: torch.Tensor  # [N]
    update_count: torch.Tensor   # i32 scalar


def flat_parameters(model: mlp.ActorCritic) -> torch.Tensor:
    """Point every parameter of ``model`` into ONE flat f32 buffer (in
    ``model.parameters()`` order) and return the buffer; an in-place update
    of the buffer updates the module."""
    params = list(model.parameters())
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    off = 0
    for p in params:
        p.data = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
    return flat


class ClipAdam:
    """``optax.flatten(optax.chain(clip_by_global_norm(max_norm),
    adam(lr, eps=eps)))`` over one flat gradient vector, written as optax
    writes it: the gradient is scaled by ``max_norm / norm`` only when
    ``norm >= max_norm`` (``clip_grad_norm_`` would add 1e-6 to the norm);
    moments ``(1 - b) * g + b * m``; bias corrections ``1 - b ** count``
    (formed in f64);
    the step ``-lr * mu_hat / (sqrt(nu_hat) + eps)``."""

    def __init__(self, max_norm: float, lr: float, eps: float,
                 b1: float = 0.9, b2: float = 0.999):
        self.max_norm, self.lr, self.eps = max_norm, lr, eps
        self.b1, self.b2 = b1, b2

    def init(self, params: mlp.ActorCritic) -> AdamState:
        n = sum(p.numel() for p in params.parameters())
        dev = next(params.parameters()).device
        z = torch.zeros(n, dtype=F32, device=dev)
        return AdamState(torch.zeros((), dtype=I32, device=dev), z, z.clone())

    def update(self, grad: torch.Tensor, state: AdamState):
        """(the update to add to the flat parameters, the new state)."""
        g_norm = torch.sqrt((grad * grad).sum())
        grad = torch.where(g_norm < self.max_norm, grad,
                           (grad / g_norm) * self.max_norm)
        # optax's safe increment: the count saturates at the int32 maximum
        count = state.count + (state.count < torch.iinfo(torch.int32).max
                               ).to(I32)
        mu = (1 - self.b1) * grad + self.b1 * state.mu
        nu = (1 - self.b2) * (grad * grad) + self.b2 * state.nu
        # the bias corrections 1 - b ** count in f64, cast to f32 (JAX
        # forms them in the default float type: f64 under jax_enable_x64)
        c = count.to(torch.float64)
        mu_hat = mu / (1 - self.b1 ** c).to(F32)
        nu_hat = nu / (1 - self.b2 ** c).to(F32)
        upd = (mu_hat / (torch.sqrt(nu_hat) + self.eps)) * -self.lr
        return upd, AdamState(count, mu, nu)


def make_optimizer(pcfg: PPOConfig) -> ClipAdam:
    return ClipAdam(pcfg.max_grad_norm, pcfg.learning_rate, pcfg.adam_eps)


def init_train_state(cfg: SimConfig, pcfg: PPOConfig, spec: VariantSpec,
                     n_envs: int, seed: int = 42, env_seed0: int = 0,
                     device="cuda") -> TrainState:
    """A fresh train state, as the JAX learner makes it: ``PRNGKey(seed)``
    splits into the learner's key chain and the key of the initial weights
    (``mlp.init_params``)."""
    dev = resolve_device(device)
    key, pkey = TF.split_key(TF.prng_key(seed, device="cpu"))
    params = mlp.init_params(pkey, spec.obs_dim, spec.n_actions, device=dev)
    env_state = spec.reset_batch(cfg, n_envs, env_seed0, device=dev)
    acc = F32
    return TrainState(
        params=params,
        opt_state=make_optimizer(pcfg).init(params),
        env_state=env_state,
        obs=spec.batched_obs(cfg)(env_state),
        key=key,
        ep_return_acc=torch.zeros(n_envs, dtype=acc, device=dev),
        last_ep_return=torch.zeros(n_envs, dtype=acc, device=dev),
        update_count=torch.zeros((), dtype=I32, device=dev),
    )


def _onehot_select(logp_all: torch.Tensor, action: torch.Tensor, dim: int):
    """logp_all at ``action`` along ``dim`` as a masked sum (one non-zero
    addend: the same value as a gather)."""
    a = logp_all.shape[dim]
    iota = torch.arange(a, device=logp_all.device)
    if dim == -1:
        onehot = iota[None, :] == action[:, None]
    else:
        onehot = iota[:, None] == action[None, :]
    return torch.where(onehot, logp_all, torch.zeros((), dtype=F32,
                                                     device=logp_all.device)
                       ).sum(dim=dim)


def _forward(params: mlp.ActorCritic, obs):
    """(logits, values) of the batch ``obs``."""
    return params.policy_logits(obs), params.value_fn(obs)


def _sample(params: mlp.ActorCritic, obs, mask, key):
    """Masked categorical sample + logp + value (batch)."""
    logits, value = _forward(params, obs)
    logits = mlp.masked_logits(logits, mask)
    logp_all = torch.log_softmax(logits, dim=-1)
    action = TF.categorical(key, logits, 0).to(I32)
    logp = _onehot_select(logp_all, action, -1)
    return action, logp, value


@torch.no_grad()
def collect_rollout(cfg: SimConfig, pcfg: PPOConfig, spec: VariantSpec,
                    ts: TrainState, step_fn, use_action_masking: bool = True):
    """``n_steps`` of policy + autoreset env step; returns (ts, the
    transitions, the last values)."""
    batched = spec.batched_autoreset_step(cfg, step_fn)
    masks_of = spec.batched_masks(cfg)
    n, dev, T = ts.obs.shape[0], ts.obs.device, pcfg.n_steps
    A = spec.n_actions
    trs = Transition(
        obs=torch.empty((T, ts.obs.shape[1], n), dtype=F32, device=dev),
        mask=torch.empty((T, A, n), dtype=torch.bool, device=dev),
        action=torch.empty((T, n), dtype=I32, device=dev),
        logp=torch.empty((T, n), dtype=F32, device=dev),
        value=torch.empty((T, n), dtype=F32, device=dev),
        reward=torch.empty((T, n), dtype=F32, device=dev),
        done=torch.empty((T, n), dtype=torch.bool, device=dev))
    ones = torch.ones((n, A), dtype=torch.bool, device=dev)
    env_state, obs, key = ts.env_state, ts.obs, ts.key
    acc, last_ret = ts.ep_return_acc, ts.last_ep_return
    for t in range(T):
        mask = masks_of(env_state) if use_action_masking else ones
        key, sk = TF.split_key(key)
        action, logp, value = _sample(ts.params, obs, mask, sk)
        env_state, out = batched(env_state, action)
        acc = acc + out.reward
        last_ret = torch.where(out.terminated, acc, last_ret)
        acc = torch.where(out.terminated, 0.0, acc)
        trs.obs[t] = obs.T
        trs.mask[t] = mask.T
        trs.action[t] = action
        trs.logp[t] = logp
        trs.value[t] = value
        trs.reward[t] = out.reward
        trs.done[t] = out.terminated
        obs = out.obs
    last_value = _forward(ts.params, obs)[1]
    ts = ts._replace(env_state=env_state, obs=obs, key=key,
                     ep_return_acc=acc, last_ep_return=last_ret)
    return ts, trs, last_value


@torch.no_grad()
def compute_gae(pcfg: PPOConfig, trs: Transition, last_value):
    """SB3 GAE: deltas with (1 - done) bootstrapping, in reverse."""
    T = trs.reward.shape[0]
    advantages = torch.empty_like(trs.reward)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    gl = pcfg.gamma * pcfg.gae_lambda       # folded in Python, as in JAX
    for t in reversed(range(T)):
        nonterminal = 1.0 - trs.done[t].to(F32)
        delta = trs.reward[t] + pcfg.gamma * next_value * nonterminal \
            - trs.value[t]
        gae = delta + gl * nonterminal * gae
        advantages[t] = gae
        next_value = trs.value[t]
    return advantages, advantages + trs.value


def _loss_fn(params: mlp.ActorCritic, pcfg: PPOConfig, batch):
    """PPO clipped loss on a batch-last minibatch: obs (D, B), mask
    (A, B), action/old_logp/advantage/ret (B,).  Returns (loss, stats)."""
    obs, mask, action, old_logp, advantage, ret = batch
    logits = mlp.masked_logits(params.policy_logits_bl(obs), mask)
    logp_all = torch.log_softmax(logits, dim=0)             # (A, B)
    logp = _onehot_select(logp_all, action, 0)
    value = params.value_fn_bl(obs)

    if pcfg.normalize_advantage:
        # jnp.std is the population std
        advantage = (advantage - advantage.mean()) / (
            advantage.std(correction=0) + 1e-8)

    ratio = torch.exp(logp - old_logp)
    pg1 = advantage * ratio
    pg2 = advantage * torch.clamp(ratio, 1.0 - pcfg.clip_range,
                                  1.0 + pcfg.clip_range)
    policy_loss = -torch.minimum(pg1, pg2).mean()
    value_loss = ((ret - value) ** 2).mean()

    # masked-categorical entropy: invalid actions have p ~= 0
    p = torch.exp(logp_all)
    ent_terms = torch.where(mask, p * logp_all,
                            torch.zeros((), dtype=F32, device=p.device))
    entropy = -ent_terms.sum(dim=0).mean()

    loss = (policy_loss + pcfg.vf_coef * value_loss
            - pcfg.ent_coef * entropy)
    stats = {
        "loss": loss, "policy_loss": policy_loss, "value_loss": value_loss,
        "entropy": entropy,
        "approx_kl": (old_logp - logp).mean(),
        "clip_frac": ((ratio - 1.0).abs() > pcfg.clip_range).to(F32).mean(),
    }
    return loss, {k: v.detach() for k, v in stats.items()}


def minibatch_layout(pcfg: PPOConfig, total: int):
    """(n_mb, mb_size, block, n_blocks, mb_blocks) of the update, with
    the JAX learner's ``shuffle_block`` fall-back rule."""
    n_mb = max(1, total // pcfg.batch_size)
    mb_size = total // n_mb
    block = pcfg.shuffle_block
    if block < 1 or total % block or mb_size % block:
        block = 1
    return n_mb, mb_size, block, total // block, mb_size // block


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """bool[A, B] -> f32[B] bit field ``sum_j mask_j 2**j`` (exact for
    A <= 22)."""
    A = mask.shape[0]
    if A > 22:
        raise ValueError("mask bit-packing needs A <= 22 for exact f32")
    shifts = torch.arange(A, dtype=I32, device=mask.device)[:, None]
    return (mask.to(I32) << shifts).sum(dim=0, dtype=I32).to(F32)


def unpack_mask(bits: torch.Tensor, A: int) -> torch.Tensor:
    shifts = torch.arange(A, dtype=I32, device=bits.device)[:, None]
    return ((bits.to(I32)[None, :] >> shifts) & 1) > 0


def ppo_update(pcfg: PPOConfig, ts: TrainState, trs: Transition,
               advantages, returns):
    """``n_epochs`` x shuffled minibatches, as SB3's training loop, on the
    packed batch-last buffer ``[D + 5, n_blocks, block]`` (obs, the mask as
    one bit-field row, action, logp, advantage, return) that the JAX
    learner builds.  The new parameters live in a copy of ``ts.params``:
    the incoming train state is left as it was."""
    T, N = trs.action.shape
    total = T * N
    n_mb, mb_size, block, n_blocks, mb_blocks = minibatch_layout(pcfg, total)
    D, A = trs.obs.shape[1], trs.mask.shape[1]
    dev = trs.obs.device
    packed = torch.cat([
        trs.obs.transpose(0, 1).reshape(D, total),
        pack_mask(trs.mask.transpose(0, 1).reshape(A, total))[None],
        trs.action.reshape(1, total).to(F32),
        trs.logp.reshape(1, total),
        advantages.reshape(1, total).to(F32),
        returns.reshape(1, total).to(F32),
    ]).reshape(D + 5, n_blocks, block)

    def unpack(g):
        return (g[:D], unpack_mask(g[D], A), g[D + 1].to(I32), g[D + 2],
                g[D + 3], g[D + 4])

    model = copy.deepcopy(ts.params)
    params = list(model.parameters())
    flat = flat_parameters(model)
    optimizer = make_optimizer(pcfg)
    opt_state, key = ts.opt_state, ts.key
    epoch_stats = []
    for _ in range(pcfg.n_epochs):
        key, pk = TF.split_key(key)
        perm = TF.permutation(pk, n_blocks, dev)[: n_mb * mb_blocks]
        perm = perm.reshape(n_mb, mb_blocks)
        mb_stats = []
        for j in range(n_mb):
            g = packed[:, perm[j]].reshape(-1, mb_size)
            loss, stats = _loss_fn(model, pcfg, unpack(g))
            grads = torch.autograd.grad(loss, params)
            upd, opt_state = optimizer.update(
                torch.cat([x.reshape(-1) for x in grads]), opt_state)
            with torch.no_grad():
                flat.add_(upd)
            mb_stats.append(stats)
        epoch_stats.append({k: torch.stack([s[k] for s in mb_stats]).mean()
                            for k in mb_stats[0]})
    stats = {k: torch.stack([s[k] for s in epoch_stats]).mean()
             for k in epoch_stats[0]}
    ts = ts._replace(params=model, opt_state=opt_state, key=key,
                     update_count=ts.update_count + 1)
    return ts, stats


def make_train_iteration(cfg: SimConfig, pcfg: PPOConfig, spec: VariantSpec,
                         sort_policy=None, use_action_masking=True):
    """One PPO iteration ``ts -> (ts, stats)``: rollout + GAE + update."""
    step_fn = spec.step_fn(sort_policy, use_action_masking)

    def train_iteration(ts: TrainState):
        ts, trs, last_value = collect_rollout(cfg, pcfg, spec, ts, step_fn,
                                              use_action_masking)
        advantages, returns = compute_gae(pcfg, trs, last_value)
        ts, stats = ppo_update(pcfg, ts, trs, advantages, returns)
        stats["mean_episode_return"] = ts.last_ep_return.mean()
        return ts, stats

    return train_iteration
