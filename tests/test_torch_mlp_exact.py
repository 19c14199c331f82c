"""The port's integer policy (marl_sortingenv_tpu_torch/models/mlp_exact.py)
against the JAX package's, on the CPU, bit for bit: the tanh table and its
pinned checksum, the quantized weights of the trained agents and of
random ones, the Q28 logits, the (masked) deterministic predict, and an
exact tie of integer logits, which both resolve to the first maximal
index.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from marl_sortingenv_tpu.models import mlp as jmlp
from marl_sortingenv_tpu.models import mlp_exact as JMX
from marl_sortingenv_tpu.utils.checkpoint import load_model
from marl_sortingenv_tpu_torch.models import mlp
from marl_sortingenv_tpu_torch.models import mlp_exact as MX

torch.set_num_threads(1)

MODELS = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                      "models_masked")
AGENTS = {"sort": ("PPO_Sorting_Masked_100000.npz", 13, 2),
          "press": ("PPO_Pressing_Masked_100000.npz", 16, 11),
          "mono": ("PPO_Monolith_Masked_100000.npz", 29, 22)}


def pair(name):
    """(the JAX package's QPolicy, the port's) of an agent: a trained one
    from its ``.npz``, or ``random`` (drawn by JAX, handed to the port
    through ``params_from_jax``)."""
    if name == "random":
        jp = jmlp.init_params(jax.random.PRNGKey(9), 16, 11)
        tp = mlp.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    else:
        f, d, a = AGENTS[name]
        jp = load_model(os.path.join(MODELS, f),
                        jmlp.init_params(jax.random.PRNGKey(0), d, a))
        tp = mlp.load_npz(os.path.join(MODELS, f), device="cpu")
    return JMX.quantize_policy(jp), MX.quantize_policy(tp, device="cpu")


def test_tanh_table_pinned():
    assert MX.tanh_table_checksum() == 1467280001
    assert MX.tanh_table_checksum() == JMX.tanh_table_checksum()
    assert np.array_equal(MX._TANH_TABLE, JMX._TANH_TABLE)
    assert MX._TANH_TABLE[MX.TANH_IN_MAX] == 0
    assert np.array_equal(MX._TANH_TABLE, -MX._TANH_TABLE[::-1])


@pytest.mark.parametrize("name", ["sort", "press", "mono", "random"])
def test_policy_bitwise(name):
    qj, qt = pair(name)
    for lj, lt in zip(qj.pi + (qj.action,), qt.pi + (qt.action,)):
        assert np.array_equal(np.asarray(lj.w), lt.w.numpy())
        assert np.array_equal(np.asarray(lj.b), lt.b.numpy())
        assert lt.w.dtype == torch.int32 and lt.b.dtype == torch.int64
    d = qt.pi[0].w.shape[0]
    rng = np.random.default_rng(len(name))
    obs = rng.uniform(-1, 1, (256, d)).astype(np.float32)
    obs[:4] = np.float32([-1.0, 1.0, 0.250244140625, 0.0])[:, None]
    oq_j = np.asarray(JMX.quantize_obs(obs))
    oq_t = MX.quantize_obs(torch.from_numpy(obs))
    assert np.array_equal(oq_j, oq_t.numpy()) and oq_t.dtype == torch.int32
    lg_j = np.asarray(JMX.policy_logits_q(qj, jnp.asarray(oq_j)))
    lg_t = MX.policy_logits_q(qt, oq_t)
    assert lg_t.dtype == torch.int64 and np.array_equal(lg_j, lg_t.numpy())
    assert np.array_equal(np.asarray(JMX.logits_q_as_f64(qj, obs)),
                          MX.logits_q_as_f64(qt, torch.from_numpy(obs))
                          .numpy())
    mask = rng.random((256, lg_t.shape[1])) < 0.5
    mask[:, 0] = True
    for m in (None, mask):
        pj = np.asarray(JMX.predict_deterministic_q(
            qj, obs, None if m is None else jnp.asarray(m)))
        pt = MX.predict_deterministic_q(
            qt, torch.from_numpy(obs), None if m is None
            else torch.from_numpy(m))
        assert pt.dtype == torch.int32 and np.array_equal(pj, pt.numpy())


def test_exact_tie_takes_the_first_index():
    """Zero weights: every logit is its bias, and three actions share the
    largest; the first of them wins, masked or not, in both packages."""
    b = np.zeros(11, np.int64)
    b[[2, 5, 7]] = 1 << 28
    w0 = np.zeros((16, 32), np.int32)
    wa = np.zeros((32, 11), np.int32)
    qt = MX.QPolicy(pi=(MX.QDense(torch.from_numpy(w0),
                                  torch.zeros(32, dtype=torch.int64)),),
                    action=MX.QDense(torch.from_numpy(wa),
                                     torch.from_numpy(b)))
    qj = JMX.QPolicy(pi=(JMX.QDense(jnp.asarray(w0),
                                    jnp.zeros(32, jnp.int64)),),
                     action=JMX.QDense(jnp.asarray(wa), jnp.asarray(b)))
    obs = np.random.default_rng(0).uniform(-1, 1, (4, 16)).astype(np.float32)
    mask = np.ones((4, 11), bool)
    mask[1, 2] = False
    mask[2, [2, 5]] = False
    mask[3, [2, 5, 7]] = False
    pt = MX.predict_deterministic_q(qt, torch.from_numpy(obs),
                                    torch.from_numpy(mask))
    pj = JMX.predict_deterministic_q(qj, obs, jnp.asarray(mask))
    assert pt.tolist() == [2, 5, 7, 0] == np.asarray(pj).tolist()
    assert MX.predict_deterministic_q(qt, torch.from_numpy(obs)).tolist() \
        == [2, 2, 2, 2]
