"""The actor-critic MLP's plain version: a frozen copy of the port's
``models/mlp.py`` (SB3's ``MlpPolicy`` with ``net_arch=dict(pi=[32, 32],
vf=[32, 32])``: separate Linear + Tanh towers, an action head and a value
head, f32, the products ``torch.matmul``), with its ``.npz`` reader and the
initial weights from a threefry key.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ._device import resolve_device
from . import threefry as TF


def _tower(obs_dim: int, hidden: Sequence[int]) -> nn.Sequential:
    layers = []
    d_in = obs_dim
    for d_out in hidden:
        layers += [nn.Linear(d_in, d_out), nn.Tanh()]
        d_in = d_out
    return nn.Sequential(*layers)


class ActorCritic(nn.Module):
    def __init__(self, obs_dim: int, n_actions: int,
                 hidden: Sequence[int] = (32, 32), *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.obs_dim, self.n_actions = obs_dim, n_actions
        self.mlp_extractor = nn.Module()
        self.mlp_extractor.policy_net = _tower(obs_dim, hidden)
        self.mlp_extractor.value_net = _tower(obs_dim, hidden)
        last = hidden[-1] if hidden else obs_dim
        self.action_net = nn.Linear(last, n_actions)
        self.value_net = nn.Linear(last, 1)
        # initialised on the CPU from a CPU generator, then moved, so a seed
        # gives the same weights on every device
        gains = [(m, float(np.sqrt(2))) for tower in (
            self.mlp_extractor.policy_net, self.mlp_extractor.value_net)
            for m in tower if isinstance(m, nn.Linear)]
        gains += [(self.action_net, 0.01), (self.value_net, 1.0)]
        with torch.no_grad():
            for lin, gain in gains:
                nn.init.orthogonal_(lin.weight, gain, generator=generator)
                lin.bias.zero_()
        self.to(dev)

    def policy_logits(self, obs: torch.Tensor) -> torch.Tensor:
        """Action logits for a single obs or a batch (f32)."""
        return self.action_net(self.mlp_extractor.policy_net(obs.float()))

    def value_fn(self, obs: torch.Tensor) -> torch.Tensor:
        return self.value_net(self.mlp_extractor.value_net(obs.float()))[
            ..., 0]

    def forward(self, obs: torch.Tensor):
        return self.policy_logits(obs), self.value_fn(obs)

    # batch-last (feature-major) forwards, the PPO update's layout: the
    # same products as above on (feat, batch) operands, W @ x + b[:, None]

    @staticmethod
    def _tower_bl(tower: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        for m in tower:
            if isinstance(m, nn.Linear):
                x = torch.tanh(m.weight @ x + m.bias[:, None])
        return x

    def policy_logits_bl(self, obs_bl: torch.Tensor) -> torch.Tensor:
        """Action logits for a batch-last obs (D, B) -> (A, B)."""
        h = self._tower_bl(self.mlp_extractor.policy_net, obs_bl.float())
        return self.action_net.weight @ h + self.action_net.bias[:, None]

    def value_fn_bl(self, obs_bl: torch.Tensor) -> torch.Tensor:
        """Values for a batch-last obs (D, B) -> (B,)."""
        h = self._tower_bl(self.mlp_extractor.value_net, obs_bl.float())
        return (self.value_net.weight @ h + self.value_net.bias[:, None])[0]

    def predict_deterministic(self, obs: torch.Tensor, mask=None):
        """SB3 ``predict(deterministic=True)``: argmax over (masked) logits."""
        logits = self.policy_logits(obs)
        if mask is not None:
            logits = masked_logits(logits, mask)
        return torch.argmax(logits, dim=-1).to(torch.int32)


def masked_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MaskableCategorical semantics: invalid logits -> dtype min."""
    neg = torch.finfo(logits.dtype).min
    return torch.where(mask, logits, torch.full_like(logits, neg))


class Dense(NamedTuple):
    """One layer as the JAX package stores it: ``w`` is ``[in, out]``."""
    w: np.ndarray
    b: np.ndarray


class ACParams(NamedTuple):
    """The JAX package's parameter layout, as numpy arrays; its leaves in
    order (pi (w, b) per layer, vf (w, b) per layer, action, value) are the
    ``leaf_i`` of the JAX package's ``.npz`` files."""
    pi: Tuple[Dense, ...]
    vf: Tuple[Dense, ...]
    action: Dense
    value: Dense


def params_from_jax(params_np, device="cuda") -> ActorCritic:
    """An ``ActorCritic`` computing the same function as the JAX package's
    ``ACParams`` given as numpy arrays (``Dense.w`` is ``[in, out]``); any
    object with the fields ``pi``, ``vf``, ``action`` and ``value`` will
    do, ``ACParams`` above among them."""
    pi, vf = list(params_np.pi), list(params_np.vf)
    obs_dim = np.asarray(pi[0].w).shape[0]
    n_actions = np.asarray(params_np.action.w).shape[1]
    hidden = [np.asarray(d.w).shape[1] for d in pi]
    if [np.asarray(d.w).shape[1] for d in vf] != hidden:
        raise ValueError("pi and vf towers of different widths")
    model = ActorCritic(obs_dim, n_actions, hidden, device="cpu")
    lins = ([m for m in model.mlp_extractor.policy_net
             if isinstance(m, nn.Linear)],
            [m for m in model.mlp_extractor.value_net
             if isinstance(m, nn.Linear)])
    pairs = list(zip(lins[0], pi)) + list(zip(lins[1], vf)) + [
        (model.action_net, params_np.action), (model.value_net,
                                               params_np.value)]
    with torch.no_grad():
        for lin, d in pairs:
            lin.weight.copy_(torch.tensor(np.asarray(d.w, np.float32).T))
            lin.bias.copy_(torch.tensor(np.asarray(d.b, np.float32)))
    return model.to(resolve_device(device))


def load_npz(path: str, device="cuda") -> ActorCritic:
    """An ``ActorCritic`` from an ``ACParams`` ``.npz`` written by the JAX
    package's ``utils/checkpoint.save_pytree`` (or by the port's
    ``utils/checkpoint.save_model``), read with numpy alone: the leaves
    ``leaf_0 .. leaf_{n-1}`` are pi (w, b) per hidden layer, vf (w, b) per
    hidden layer, then action (w, b) and value (w, b)."""
    with np.load(path) as data:
        n = int(data["__num_leaves__"])
        leaves = [np.asarray(data[f"leaf_{i}"], np.float32) for i in range(n)]
    if n < 4 or n % 4:
        raise ValueError(f"{path}: {n} leaves is not an actor-critic")
    layers = (n - 4) // 4
    dense = [Dense(leaves[2 * i], leaves[2 * i + 1]) for i in range(n // 2)]
    params = ACParams(tuple(dense[:layers]), tuple(dense[layers:2 * layers]),
                      dense[2 * layers], dense[2 * layers + 1])
    return params_from_jax(params, device)


def _orthogonal(key, shape, gain: float) -> np.ndarray:
    """The JAX package's orthogonal init of a ``[in, out]`` weight from one
    threefry key: the Q of a QR of a standard normal matrix, its columns'
    signs set by R's diagonal, times ``gain``."""
    n_rows, n_cols = shape
    # drawn on the CPU, so that a key gives the same weights on every device
    flat = TF.normal(key, (max(n_rows, n_cols), min(n_rows, n_cols)),
                     device="cpu")
    q, r = torch.linalg.qr(flat)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.T
    return (gain * q[:n_rows, :n_cols]).numpy()


def init_params(key, obs_dim: int, n_actions: int,
                hidden: Sequence[int] = (32, 32), device="cuda"
                ) -> ActorCritic:
    """An ``ActorCritic`` with the JAX package's ``init_params`` weights for
    ``key`` (an ``int32[2]`` tensor or a pair of ints): the key splits into
    one key per layer (pi tower, vf tower, action head, value head), each
    layer orthogonal with gain sqrt(2), 0.01 or 1.0, biases zero.  Neither
    ``erfinv`` nor the QR is bitwise between the packages: the weights agree
    with JAX's to a tolerance (``tests/test_torch_mlp_init.py``)."""
    keys = iter(TF.split_key(key, 2 * len(hidden) + 2))

    def tower():
        layers, d_in = [], obs_dim
        for d_out in hidden:
            layers.append(Dense(_orthogonal(next(keys), (d_in, d_out),
                                            float(np.sqrt(2))),
                                np.zeros(d_out, np.float32)))
            d_in = d_out
        return tuple(layers), d_in

    pi, d_pi = tower()
    vf, d_vf = tower()
    action = Dense(_orthogonal(next(keys), (d_pi, n_actions), 0.01),
                   np.zeros(n_actions, np.float32))
    value = Dense(_orthogonal(next(keys), (d_vf, 1), 1.0),
                  np.zeros(1, np.float32))
    return params_from_jax(ACParams(pi, vf, action, value), device)
