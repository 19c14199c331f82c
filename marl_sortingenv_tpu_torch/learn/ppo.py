"""On-device (Maskable) PPO learner on the fast engines (the batch-last
``fastb`` and its batch-first view ``fast``) and the bit-exact ``parity``
engine: the port of ``marl_sortingenv_tpu.learn.ppo`` (SB3's ``PPO`` /
``MaskablePPO``).

The same algorithm and the same random streams as the JAX learner: the
learner's key chain (``TrainState.key``) is split exactly as the JAX
learner splits it, the actions are ``jax.random.categorical``'s Gumbel-max
draws (``core/threefry.categorical``) and the per-epoch minibatch
permutation is ``jax.random.permutation``'s (``core/threefry.permutation``),
so for the same parameters and key the port forms the same minibatches.
The policy and the update are held to the JAX learner by tolerance, not
bitwise (``tests/test_torch_ppo.py``): products and reductions round
differently in PyTorch and XLA.

What replaces JAX's machinery: the rollout ``lax.scan`` is a Python loop
over ``n_steps`` (a fastb env step is one kernel launch on CUDA; on CUDA
without a mesh each step of a ``fastb`` rollout, policy included, is one
replay of a captured CUDA graph, ``GraphedRollout``), the update
scans are Python loops over epochs and minibatches with ``torch.autograd``
for the gradient (on CUDA each minibatch is one replay of a captured CUDA
graph, ``GraphedUpdate``), and ``optax``'s
``flatten(chain(clip_by_global_norm, adam))`` is ``ClipAdam`` over ONE
flattened parameter vector.  The learner's key lives on the CPU as an
int32[2] tensor: its splits are host arithmetic, and the draws it seeds
run on the device of the env state.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..config.config import SimConfig
from ..core import fast as FE
from ..core import fastb as FB
from ..core import parity as PE
from ..core import threefry as TF
from ..models import mlp
from ..ops import graphs
from ..parallel import distributed as DI
from ..parallel import mesh as M
from ..utils import profiling

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

    @classmethod
    def tuned(cls, **over) -> "PPOConfig":
        """The JAX package's swept preset (lr 1e-3, entropy 0.01), which
        beats the reference-mirroring defaults at the 100k-step budget."""
        kw = dict(learning_rate=1e-3, ent_coef=0.01)
        kw.update(over)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """Learner-facing description of one env variant on
    ``engine='parity'`` (the bit-exact u64/f64 engine, ``core/parity.py``),
    the batch-last ``engine='fastb'`` or the batch-first ``engine='fast'``
    (its view, ``core/fast.py``)."""
    name: str                 # 'sort' | 'press' | 'mono'
    obs_dim: int
    n_actions: int
    use_mask: bool
    engine: str = "parity"

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}")

    def _mod(self):
        return ENGINES[self.engine]

    def mask_fn(self, cfg: SimConfig, st):
        if self.name == "press":
            return self._mod().press_action_masks(cfg, st)
        if self.name == "mono":
            return self._mod().monolith_action_masks(cfg, st)
        return torch.ones((st.current_step.shape[0], self.n_actions),
                          dtype=torch.bool, device=st.current_step.device)

    def obs_fn(self, cfg: SimConfig, st):
        mod = self._mod()
        if self.name == "sort":
            return mod.get_sort_obs(cfg, st)
        if self.name == "press":
            return mod.get_press_obs(cfg, st)
        return mod.get_mono_obs(cfg, st)

    def step_fn(self, sort_policy=None, use_action_masking=True):
        """``(cfg, st, action) -> (st, out)``.  ``sort_policy`` (press only)
        is a frozen sort agent, an ``ActorCritic`` (see
        ``fastb.step_press``), which the press step carries as its
        ``_agents`` (a rollout graph is keyed on their storages)."""
        mod = self._mod()
        if self.name == "sort":
            return mod.step_sort
        if self.name == "press":
            def p(cfg, st, a):
                return mod.step_press(cfg, st, a, sort_policy,
                                      use_action_masking)
            p._agents = () if sort_policy is None else (sort_policy,)
            return p

        def f(cfg, st, a):
            return mod.step_mono_external(cfg, st, a, use_action_masking)
        # the tag lets batched_autoreset_step prove that the fused-autoreset
        # step it substitutes is this very step
        f._mono_step = ("external", use_action_masking)
        return f

    def wrap_autoreset(self, cfg: SimConfig, step_fn):
        return self._mod().with_autoreset(cfg, step_fn)

    def reset_batch(self, cfg: SimConfig, n_envs: int, seed0: int = 0,
                    device="cuda"):
        """``n_envs`` fresh envs: on 'parity' the envs of seeds seed0,
        seed0 + 1, ..., on the fast engines the threefry key of seed0."""
        return self._mod().reset_batch(cfg, seed0, n_envs, device=device)

    # every engine's functions are batched: obs [N, d], masks [N, A]

    def batched_obs(self, cfg: SimConfig):
        return lambda st: self.obs_fn(cfg, st)

    def batched_masks(self, cfg: SimConfig):
        return lambda st: self.mask_fn(cfg, st)

    def batched_step(self, cfg: SimConfig, step_fn):
        return lambda st, a: step_fn(cfg, st, a)

    def batched_autoreset_step(self, cfg: SimConfig, step_fn,
                               use_action_masking: bool = True):
        """The autoreset step of the rollout.  On ``fastb`` a tagged mono
        step becomes ``mono_autoreset_step``, whose step kernel fuses the
        reset in (bitwise the same as the generic wrapper); every other step
        takes ``with_autoreset``."""
        tag = getattr(step_fn, "_mono_step", None)
        if self.engine == "fastb" and self.name == "mono" and tag is not None:
            variant, masked = tag
            if masked != use_action_masking:
                raise ValueError(
                    "step_fn was built with use_action_masking="
                    f"{masked} but batched_autoreset_step got "
                    f"{use_action_masking}")
            return FB.mono_autoreset_step(cfg, variant, masked)
        return self.wrap_autoreset(cfg, step_fn)


ENGINES = {"parity": PE, "fast": FE, "fastb": FB}
SORT_SPEC = VariantSpec("sort", 13, 2, use_mask=False)
PRESS_SPEC = VariantSpec("press", 16, 11, use_mask=True)
MONO_SPEC = VariantSpec("mono", 29, 22, use_mask=True)


def spec_for(name: str, engine: str = "parity") -> VariantSpec:
    base = {"sort": SORT_SPEC, "press": PRESS_SPEC, "mono": MONO_SPEC}[name]
    return dataclasses.replace(base, engine=engine)


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
    env_state: FB.BState         # a FastEnvState ('fast'), EnvState ('parity')
    obs: torch.Tensor            # [N, obs_dim]
    key: torch.Tensor            # int32[2] threefry key, on the CPU
    # running episode-return accumulators (device-side Monitor): f64 on
    # the parity engine, f32 on the fast ones
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
                     device="cuda", mesh=None) -> TrainState:
    """A fresh train state, as the JAX learner makes it: ``PRNGKey(seed)``
    splits into the learner's key chain and the key of the initial weights
    (``mlp.init_params``).

    ``mesh`` (a ``parallel.mesh`` DeviceMesh; ``fastb`` only): this rank's
    dp shard of the state over ``n_envs`` global envs, built without the
    global batch and equal to ``parallel.fastb_shard.shard_train_state``
    of the unsharded state: the parameters, the optimizer state, the key
    and the update count whole; the env state the rank's rows of the global
    reset (``parallel.distributed.make_global_bstate``), and the obs and
    the return accumulators cut to them."""
    dev = resolve_device(device)
    key, pkey = TF.split_key(TF.prng_key(seed, device="cpu"))
    params = mlp.init_params(pkey, spec.obs_dim, spec.n_actions, device=dev)
    if mesh is None:
        env_state = spec.reset_batch(cfg, n_envs, env_seed0, device=dev)
        n_local = n_envs
    else:
        if spec.engine != "fastb":
            raise ValueError("a sharded train state is built on the fastb "
                             f"engine only, not {spec.engine!r}")
        env_state = DI.make_global_bstate(cfg, env_seed0, n_envs,
                                          M.check_mesh(mesh), device=dev)
        n_local = env_state.key.shape[0]
    acc = _return_dtype(spec)
    return TrainState(
        params=params,
        opt_state=make_optimizer(pcfg).init(params),
        env_state=env_state,
        obs=spec.batched_obs(cfg)(env_state),
        key=key,
        ep_return_acc=torch.zeros(n_local, dtype=acc, device=dev),
        last_ep_return=torch.zeros(n_local, dtype=acc, device=dev),
        update_count=torch.zeros((), dtype=I32, device=dev),
    )


def _return_dtype(spec: VariantSpec) -> torch.dtype:
    """The dtype of returns summed over steps: the parity engine's f64
    rewards are summed in f64, the fast engines' in f32."""
    return torch.float64 if spec.engine == "parity" else F32


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


def _forward(params: mlp.ActorCritic, obs, mesh=None, rows=None):
    """(logits, values) of the batch ``obs``.  With a mesh, ``obs`` is this
    rank's rows ``rows`` of the global batch: the products run on the
    gathered global obs and the rank keeps its rows, because cuBLAS picks
    its kernel by the batch size, and a shard's rows of a product may
    round apart from the same rows of the whole batch."""
    if mesh is not None:
        obs = M.all_gather_dp(mesh, obs, 0)
    logits, value = params.policy_logits(obs), params.value_fn(obs)
    if mesh is not None:
        logits, value = logits[rows], value[rows]
    return logits, value


def _sample(params: mlp.ActorCritic, obs, mask, draw, mesh=None,
            rows=None):
    """Masked categorical sample + logp + value (batch); ``draw(logits)``
    is the categorical draw (``threefry.categorical`` of the step's key, or
    ``categorical_at`` of its words on the device).  With a mesh the batch
    is this rank's rows ``rows`` of the global one (``_forward``)."""
    logits, value = _forward(params, obs, mesh, rows)
    logits = mlp.masked_logits(logits, mask)
    logp_all = torch.log_softmax(logits, dim=-1)
    action = draw(logits).to(I32)
    logp = _onehot_select(logp_all, action, -1)
    return action, logp, value


def _returns(acc, last_ret, out):
    """The episode-return accumulators after a step's ``out``."""
    acc = acc + out.reward
    last_ret = torch.where(out.terminated, acc, last_ret)
    return torch.where(out.terminated, 0.0, acc), last_ret


def _transitions(T: int, n: int, obs_dim: int, A: int, dev) -> Transition:
    return Transition(
        obs=torch.empty((T, obs_dim, n), dtype=F32, device=dev),
        mask=torch.empty((T, A, n), dtype=torch.bool, device=dev),
        action=torch.empty((T, n), dtype=I32, device=dev),
        logp=torch.empty((T, n), dtype=F32, device=dev),
        value=torch.empty((T, n), dtype=F32, device=dev),
        reward=torch.empty((T, n), dtype=F32, device=dev),
        done=torch.empty((T, n), dtype=torch.bool, device=dev))


# ---------------------------------------------------------------------------
# The graphed rollout: on CUDA, one rollout step of a fastb train state
# (masks, policy, draw, autoreset env step, accumulators, the transitions'
# writes) is captured once into a CUDA graph (``ops/graphs.py``) and
# replayed at every step.  Eagerly, each step dispatches some 450 small
# device operations from Python.
# ---------------------------------------------------------------------------

_NS = len(FB.BState._fields)


def _carried(ts: TrainState) -> tuple:
    """What a rollout step carries to the next, as one flat tuple: the env
    state's leaves (None where absent), the obs, the accumulators."""
    return (*ts.env_state, ts.obs, ts.ep_return_acc, ts.last_ep_return)


class GraphedRollout:
    """The rollout step of one train-state layout as a CUDA graph over
    static buffers: the carried state (env state, obs, the return
    accumulators), the policy's parameters, the rollout's keys, the step
    index and the transitions.  ``run`` loads a train state into them,
    captures the step at the first call (its warm-up is the rollout's first
    step), replays it for the others, and hands everything out as fresh
    tensors: the caller's states stay values."""

    def __init__(self, spec: VariantSpec, ts: TrainState, T: int,
                 masks_of, use_action_masking: bool):
        n, dev = ts.obs.shape[0], ts.obs.device
        self.variant, self.n = spec.name, n
        self.masks_of, self.masking = masks_of, use_action_masking
        self.params = copy.deepcopy(ts.params).requires_grad_(False)
        self.carry = [None if x is None else x.clone()
                      for x in _carried(ts)]
        self.keys = torch.zeros((T, 2), dtype=torch.int64, device=dev)
        self.t = torch.zeros(1, dtype=torch.int64, device=dev)
        self.ones = torch.ones((n, spec.n_actions), dtype=torch.bool,
                               device=dev)
        self.trs = _transitions(T, n, ts.obs.shape[1], spec.n_actions, dev)
        self.graph = None

    def _step(self, batched) -> None:
        """One rollout step on the static buffers, as ``collect_rollout``'s
        eager loop takes it, with the key of step ``t`` read from device
        memory; the transitions go to row ``t``, and ``t`` moves on."""
        st, (obs, acc, last_ret) = (FB.BState(*self.carry[:_NS]),
                                    self.carry[_NS:])
        mask = self.masks_of(st) if self.masking else self.ones
        words = self.keys.index_select(0, self.t)[0]
        action, logp, value = _sample(
            self.params, obs, mask, lambda lg: TF.categorical_at(words, lg))
        st, out = batched(st, action)
        acc, last_ret = _returns(acc, last_ret, out)
        for buf, x in zip(self.trs, (obs.T, mask.T, action, logp, value,
                                     out.reward, out.terminated)):
            buf.index_copy_(0, self.t, x[None])
        graphs.store(self.carry, (*st, out.obs, acc, last_ret))
        self.t.add_(1)

    def run(self, batched, ts: TrainState):
        """The rollout of ``ts``: (the train state after it, the
        transitions).  ``batched`` is the autoreset step, which only a
        capture calls."""
        T, dev = self.keys.shape[0], self.t.device
        key, words = TF.split_chain(ts.key, T)
        graphs.copy_leaves(list(self.params.parameters()),
                           list(ts.params.parameters()))
        graphs.copy_leaves(self.carry, _carried(ts))
        host = torch.tensor(words, dtype=torch.int64)
        if dev.type == "cuda":
            host = host.pin_memory()
        self.keys.copy_(host, non_blocking=True)
        self.t.zero_()
        for _ in range(T):
            with profiling.span("rollout.graph", variant=self.variant,
                                batch=self.n):
                if self.graph is None:
                    self.graph = graphs.Graph(
                        dev, lambda: self._step(batched))
                else:
                    self.graph.replay()
        leaves = [None if x is None else x.clone() for x in self.carry]
        obs, acc, last_ret = leaves[_NS:]
        ts = ts._replace(env_state=FB.BState(*leaves[:_NS]), obs=obs,
                         key=key, ep_return_acc=acc, last_ep_return=last_ret)
        return ts, Transition(*(x.clone() for x in self.trs))


def graphed_rollout(cfg: SimConfig, pcfg: PPOConfig, spec: VariantSpec,
                    ts: TrainState, step_fn, use_action_masking: bool,
                    mesh=None):
    """The graphed rollout for ``ts`` (``graphs.cached``: keyed also on the
    spec's autoreset-step method, so a patched one is captured anew; the
    parameters are loaded at every rollout), or None where the rollout runs
    eagerly (``graphs.eligible``)."""
    if not graphs.eligible(spec.engine, ts.obs.device, mesh):
        return None
    return graphs.cached(
        step_fn, (type(spec).batched_autoreset_step, cfg, spec,
                  use_action_masking, pcfg.n_steps,
                  *getattr(step_fn, "_agents", ())),
        (*_carried(ts), *ts.params.parameters()),
        lambda: GraphedRollout(spec, ts, pcfg.n_steps,
                               spec.batched_masks(cfg), use_action_masking))


@torch.no_grad()
def collect_rollout(cfg: SimConfig, pcfg: PPOConfig, spec: VariantSpec,
                    ts: TrainState, step_fn, use_action_masking: bool = True,
                    mesh=None):
    """``n_steps`` of policy + autoreset env step; returns (ts, the
    transitions, the last values).  With masking off the policy samples
    the plain categorical and the env sanitizes invalid actions.  Where
    ``graphed_rollout`` gives a graph (``fastb`` on CUDA, no mesh), each
    step is a replay of it, with the same bits.

    ``mesh`` (a ``parallel.mesh`` DeviceMesh): ``ts`` holds this rank's dp
    shard of the envs (``parallel.fastb_shard.shard_train_state``); the
    rank steps its shard, its categorical draws are its rows of the global
    batch's draw, the policy's products run on the gathered obs
    (``_forward``), and the results are the shard's."""
    rows = None
    if mesh is not None:
        M.check_mesh(mesh)
        rows = M.local_rows(mesh, ts.obs.shape[0] * M.dp_size(mesh))
    batched = spec.batched_autoreset_step(cfg, step_fn, use_action_masking)
    graph = graphed_rollout(cfg, pcfg, spec, ts, step_fn, use_action_masking,
                            mesh)
    if graph is not None:
        ts, trs = graph.run(batched, ts)
        return ts, trs, _forward(ts.params, ts.obs)[1]
    masks_of = spec.batched_masks(cfg)
    n, dev, T = ts.obs.shape[0], ts.obs.device, pcfg.n_steps
    A = spec.n_actions
    trs = _transitions(T, n, ts.obs.shape[1], A, dev)
    ones = torch.ones((n, A), dtype=torch.bool, device=dev)
    env_state, obs, key = ts.env_state, ts.obs, ts.key
    acc, last_ret = ts.ep_return_acc, ts.last_ep_return
    row0 = 0 if rows is None else rows.start
    for t in range(T):
        with profiling.span("rollout.policy"):
            mask = masks_of(env_state) if use_action_masking else ones
            key, sk = TF.split_key(key)
            action, logp, value = _sample(
                ts.params, obs, mask,
                lambda lg: TF.categorical(sk, lg, row0), mesh, rows)
        with profiling.span("rollout.env"):
            env_state, out = batched(env_state, action)
        acc, last_ret = _returns(acc, last_ret, out)
        for buf, x in zip(trs, (obs.T, mask.T, action, logp, value,
                                out.reward, out.terminated)):
            buf[t] = x
        obs = out.obs
    last_value = _forward(ts.params, obs, mesh, rows)[1]
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


def _pack(trs: Transition, advantages, returns, n_blocks: int, block: int):
    """The packed batch-last buffer ``[D + 5, n_blocks, block]`` (obs, the
    mask as one bit-field row, action, logp, advantage, return) that the
    JAX learner builds."""
    T, N = trs.action.shape
    total = T * N
    D, A = trs.obs.shape[1], trs.mask.shape[1]
    return torch.cat([
        trs.obs.transpose(0, 1).reshape(D, total),
        pack_mask(trs.mask.transpose(0, 1).reshape(A, total))[None],
        trs.action.reshape(1, total).to(F32),
        trs.logp.reshape(1, total),
        advantages.reshape(1, total).to(F32),
        returns.reshape(1, total).to(F32),
    ]).reshape(D + 5, n_blocks, block)


def _permutations(pcfg: PPOConfig, key, n_blocks: int, n_mb: int,
                  mb_blocks: int, dev):
    """(the key after the update, the minibatches' rows of blocks
    ``[n_epochs * n_mb, mb_blocks]``, epoch after epoch): one ``split_key``
    and one ``permutation`` an epoch, as the JAX learner draws them."""
    perms = []
    for _ in range(pcfg.n_epochs):
        key, pk = TF.split_key(key)
        perms.append(TF.permutation(pk, n_blocks, dev)[: n_mb * mb_blocks]
                     .reshape(n_mb, mb_blocks))
    return key, torch.cat(perms)


def _minibatch(pcfg: PPOConfig, model: mlp.ActorCritic, flat, opt_state,
               packed, rows, A: int, loss_fn, span):
    """One minibatch: the blocks ``rows`` of ``packed`` gathered and
    unpacked, ``loss_fn``'s loss and its gradient, and the clipped Adam
    step added to ``flat``, the buffer of ``model``'s parameters; (Adam's
    new state, the minibatch's stats).  ``span`` records its phases."""
    D = packed.shape[0] - 5
    with span("update.loss"):
        g = packed.index_select(1, rows).reshape(D + 5, -1)
        loss, stats = loss_fn(model, pcfg, (
            g[:D], unpack_mask(g[D], A), g[D + 1].to(I32), g[D + 2],
            g[D + 3], g[D + 4]))
    with span("update.backward"):
        grads = torch.autograd.grad(loss, list(model.parameters()))
    with span("update.optim"):
        upd, opt_state = make_optimizer(pcfg).update(
            torch.cat([x.reshape(-1) for x in grads]), opt_state)
        with torch.no_grad():
            flat.add_(upd)
    return opt_state, stats


# ---------------------------------------------------------------------------
# The graphed update: on CUDA, one minibatch of the PPO update (the gather,
# the loss, autograd's backward, the clipped Adam step, the parameters'
# add) is captured once into a CUDA graph (``ops/graphs.py``) and replayed
# for every minibatch of every epoch.  Eagerly, each minibatch dispatches
# some 200 small device operations from Python.
# ---------------------------------------------------------------------------

class GraphedUpdate:
    """The minibatch of one update layout as a CUDA graph over static
    buffers: the packed batch, the epochs' minibatch rows, a parameter
    module over one flat buffer, Adam's state, the minibatch index ``j``
    and the stats, ``[stat, epoch, minibatch]``.  ``run`` loads an update
    into them, captures the minibatch at the first call (its warm-up is the
    update's first minibatch), replays it for the others, and hands the
    parameters, Adam's state and the stats out as fresh tensors: the
    caller's train state stays a value."""

    def __init__(self, pcfg: PPOConfig, ts: TrainState, packed, perms,
                 A: int):
        self.pcfg, self.A = pcfg, A
        self.model = copy.deepcopy(ts.params)
        self.flat = flat_parameters(self.model)
        self.opt = [x.clone() for x in ts.opt_state]
        self.packed = torch.empty_like(packed)
        self.perms = torch.empty_like(perms)
        self.j = torch.zeros(1, dtype=torch.int64, device=packed.device)
        self.names, self.stats = None, None     # made by the warm-up
        self.graph = None

    def _step(self, loss_fn) -> None:
        """Minibatch ``j`` on the static buffers, as the eager loop takes
        it, with its rows read from device memory; its stats go to column
        ``j``, and ``j`` moves on."""
        rows = self.perms.index_select(0, self.j)[0]
        opt, stats = _minibatch(self.pcfg, self.model, self.flat,
                                AdamState(*self.opt), self.packed, rows,
                                self.A, loss_fn,
                                lambda name: contextlib.nullcontext())
        if self.stats is None:
            self.names = list(stats)
            self.stats = torch.empty(
                (len(stats), self.pcfg.n_epochs,
                 self.perms.shape[0] // self.pcfg.n_epochs),
                dtype=F32, device=self.j.device)
        graphs.store(self.opt, opt)
        self.stats.view(len(self.names), -1).index_copy_(
            1, self.j, torch.stack(list(stats.values()))[:, None])
        self.j.add_(1)

    def run(self, ts: TrainState, packed, perms, loss_fn):
        """The update of ``ts`` on ``packed`` by the rows ``perms``:
        (the parameters, Adam's state, the stats).  ``loss_fn`` is the
        loss, which only a capture calls."""
        self.packed.copy_(packed)
        self.perms.copy_(perms)
        with torch.no_grad():
            graphs.copy_leaves(list(self.model.parameters()),
                               list(ts.params.parameters()))
        graphs.copy_leaves(self.opt, ts.opt_state)
        self.j.zero_()
        batch = perms.shape[1] * packed.shape[2]
        for _ in range(perms.shape[0]):
            with profiling.span("update.graph", batch=batch):
                if self.graph is None:
                    self.graph = graphs.Graph(
                        self.j.device, lambda: self._step(loss_fn))
                else:
                    self.graph.replay()
        # each epoch's mean over a fresh copy of its contiguous row: the
        # eager loop's reduction over a freshly stacked one, bit for bit
        stats = {k: torch.stack([row.clone().mean() for row in s]).mean()
                 for k, s in zip(self.names, self.stats)}
        # the parameters in one flat buffer of their own, as the eager
        # loop hands them out
        model = copy.deepcopy(self.model)
        flat_parameters(model)
        return model, AdamState(*(x.clone() for x in self.opt)), stats


def graphed_update(pcfg: PPOConfig, ts: TrainState, packed, perms, A: int,
                   loss_fn):
    """The graphed update for this layout (``graphs.cached``: keyed on the
    loss function, so a patched one is captured anew, on the whole
    ``pcfg``, whose constants the graph holds, on ``A``, and on the shapes
    of the packed batch, the rows, the parameters and Adam's state, which
    carry the minibatch layout and ``D``), or None where the update runs
    eagerly (``graphs.eligible``: the update holds no env step and no
    collective, so it graphs on CUDA on any engine, with a mesh or
    without)."""
    if not graphs.eligible(None, packed.device):
        return None
    return graphs.cached(
        loss_fn, (pcfg, A),
        (packed, perms, *ts.params.parameters(), *ts.opt_state),
        lambda: GraphedUpdate(pcfg, ts, packed, perms, A))


def ppo_update(pcfg: PPOConfig, ts: TrainState, trs: Transition,
               advantages, returns):
    """``n_epochs`` x shuffled minibatches, as SB3's training loop, on the
    packed batch-last buffer ``[D + 5, n_blocks, block]`` (``_pack``).
    Where ``graphed_update`` gives a graph (on CUDA), each minibatch is a
    replay of it, with the same bits.  The new parameters live in a copy
    of ``ts.params``: the incoming train state is left as it was."""
    T, N = trs.action.shape
    n_mb, _, block, n_blocks, mb_blocks = minibatch_layout(pcfg, T * N)
    A = trs.mask.shape[1]
    packed = _pack(trs, advantages, returns, n_blocks, block)
    key, perms = _permutations(pcfg, ts.key, n_blocks, n_mb, mb_blocks,
                               packed.device)
    graph = graphed_update(pcfg, ts, packed, perms, A, _loss_fn)
    if graph is not None:
        model, opt_state, stats = graph.run(ts, packed, perms, _loss_fn)
    else:
        model = copy.deepcopy(ts.params)
        flat = flat_parameters(model)
        opt_state, epoch_stats = ts.opt_state, []
        for rows in perms.split(n_mb):
            mb_stats = []
            for r in rows:
                opt_state, s = _minibatch(pcfg, model, flat, opt_state,
                                          packed, r, A, _loss_fn,
                                          profiling.span)
                mb_stats.append(s)
            epoch_stats.append({k: torch.stack([s[k] for s in mb_stats])
                                .mean() for k in mb_stats[0]})
        stats = {k: torch.stack([s[k] for s in epoch_stats]).mean()
                 for k in epoch_stats[0]}
    ts = ts._replace(params=model, opt_state=opt_state, key=key,
                     update_count=ts.update_count + 1)
    return ts, stats


def make_train_iteration(cfg: SimConfig, pcfg: PPOConfig, spec: VariantSpec,
                         sort_policy=None, use_action_masking=True,
                         mesh=None):
    """One PPO iteration ``ts -> (ts, stats)``: rollout + GAE + update.

    ``mesh`` (a ``parallel.mesh`` DeviceMesh; ``ts`` a rank's shard, from
    ``init_train_state(mesh=)``): each rank steps its env
    shard and runs GAE on it, the transitions are gathered over dp, and
    every rank runs the same update on the global batch with its replicated
    parameters.  The parameters and the loss stats are then bitwise those
    of the unsharded iteration; an all-reduce of per-rank gradients would
    sum in another order and lose that."""
    if mesh is not None:
        M.check_mesh(mesh)
    step_fn = spec.step_fn(sort_policy, use_action_masking)

    @profiling.spanned("learner.iteration")
    def train_iteration(ts: TrainState):
        with profiling.span("learner.rollout"):
            ts, trs, last_value = collect_rollout(
                cfg, pcfg, spec, ts, step_fn, use_action_masking, mesh)
        with profiling.span("learner.gae"):
            advantages, returns = compute_gae(pcfg, trs, last_value)
        last_ret = ts.last_ep_return
        if mesh is not None:
            with profiling.span("learner.gather"):
                trs, advantages, returns, last_ret = gather_rollout(
                    mesh, trs, advantages, returns, last_ret)
        with profiling.span("learner.update"):
            ts, stats = ppo_update(pcfg, ts, trs, advantages, returns)
        stats["mean_episode_return"] = last_ret.mean()
        return ts, stats

    return train_iteration


def gather_rollout(mesh, trs: Transition, advantages, returns, last_ret):
    """The dp ranks' transitions, advantages, returns and last episode
    returns concatenated along the env axis in rank order: the unsharded
    rollout's, on every rank."""
    def g(x):
        return M.all_gather_dp(mesh, x, x.dim() - 1)
    return (Transition(*(g(x) for x in trs)), g(advantages), g(returns),
            g(last_ret))


def make_train_run(cfg: SimConfig, pcfg: PPOConfig, spec: VariantSpec,
                   n_iters: int, sort_policy=None,
                   use_action_masking=True, mesh=None):
    """``n_iters`` PPO iterations ``ts -> (ts, stats)``, each stats entry
    stacked ``[n_iters]``."""
    it = make_train_iteration(cfg, pcfg, spec, sort_policy,
                              use_action_masking, mesh=mesh)

    def segment(ts: TrainState):
        history = []
        for _ in range(n_iters):
            ts, stats = it(ts)
            history.append(stats)
        return ts, {k: torch.stack([s[k] for s in history])
                    for k in history[0]}

    return segment


@torch.no_grad()
def evaluate(cfg: SimConfig, spec: VariantSpec, params: mlp.ActorCritic,
             n_envs: int, n_steps: int, seed0: int = 10_000,
             sort_policy=None, use_action_masking: bool = True,
             deterministic: bool = True, key=None,
             device="cuda") -> torch.Tensor:
    """SB3 ``evaluate_policy`` equivalent: run episodes with the
    (deterministic) policy, return per-env cumulative rewards [n_envs]
    (f64 on the parity engine, f32 on the fast ones).
    Episodes run without autoreset; rewards after an env's first terminal
    step do not count.  With ``deterministic=False`` the actions are
    categorical draws from ``key`` (default ``PRNGKey(0)``), split once per
    step as the JAX learner splits it."""
    dev = resolve_device(device)
    step_fn = spec.step_fn(sort_policy, use_action_masking)
    st = spec.reset_batch(cfg, n_envs, seed0, device=dev)
    obs = spec.obs_fn(cfg, st)
    if key is None:
        key = TF.prng_key(0, device="cpu")
    total = torch.zeros(n_envs, dtype=_return_dtype(spec), device=dev)
    alive = torch.ones(n_envs, dtype=torch.bool, device=dev)
    for _ in range(n_steps):
        logits = params.policy_logits(obs)
        if use_action_masking:
            # SB3 predict receives the mask only when masking is enabled;
            # without it the env sanitizes invalid actions
            logits = mlp.masked_logits(logits, spec.mask_fn(cfg, st))
        if deterministic:
            action = torch.argmax(logits, dim=-1).to(I32)
        else:
            key, sk = TF.split_key(key)
            action = TF.categorical(sk, logits).to(I32)
        st, out = step_fn(cfg, st, action)
        total = total + out.reward * alive.to(total.dtype)
        alive = alive & ~out.terminated
        obs = out.obs
    return total


def stats_to_numpy(stats: dict) -> dict:
    """Stats tensors as numpy (one device-to-host copy each)."""
    return {k: np.asarray(v.detach().cpu()) for k, v in stats.items()}
