"""The port's actor-critic initialisation and SB3 loaders
(marl_sortingenv_tpu_torch/models/mlp.py: ``init_params``, ``_orthogonal``,
``from_torch_state_dict``, ``load_sb3_zip``; core/threefry.py: ``normal``)
against the JAX package's, on the CPU.

Tolerances, and why:
* ``normal``: the uniform it maps is bitwise, but ``torch.erfinv`` and
  XLA's ``erf_inv`` are different approximations (up to ~50 ulp apart):
  rtol 2e-5, atol 1e-6;
* ``init_params``: those normals, then a QR (LAPACK's in both, another
  order of operations) with the same sign fix: every weight to atol 1e-5,
  every bias exactly zero;
* the loaders convert exactly: the weights equal JAX's bit for bit.
"""
import io
import zipfile

import numpy as np
import pytest
import torch

from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import threefry as TF
from marl_sortingenv_tpu_torch.learn import ppo
from marl_sortingenv_tpu_torch.models import mlp

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)


def _key(k):
    return torch.from_numpy(np.asarray(k).view(np.int32).copy())


@pytest.mark.parametrize("shape", [(32, 29), (32, 32), (22, 32), (1, 32),
                                   (3, 4, 5)])
def test_normal_matches_jax(shape):
    import jax

    for seed in (0, 1, 42, 2**35 + 7):
        k = jax.random.PRNGKey(seed)
        ref = np.asarray(jax.random.normal(k, shape, np.float32))
        got = TF.normal(_key(k), shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("dims", [(13, 2), (16, 11), (29, 22)])
def test_init_params_matches_jax(dims):
    import jax
    from marl_sortingenv_tpu.models import mlp as jmlp

    for seed in (0, 3, 42):
        k = jax.random.PRNGKey(seed)
        ref = jax.tree.leaves(jmlp.init_params(k, *dims))
        model = mlp.init_params(_key(k), *dims, device="cpu")
        got = mlp.params_leaves(mlp.params_to_jax(model))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            b = np.asarray(b)
            assert a.shape == b.shape
            if b.ndim == 1:
                assert not a.any()
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        # orthogonal columns (rows for a wide matrix), scaled by the gain
        for lin, gain in ((model.mlp_extractor.policy_net[0], np.sqrt(2)),
                          (model.action_net, 0.01)):
            w = lin.weight.detach().double()
            g = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
            np.testing.assert_allclose(g.numpy(), gain ** 2 * np.eye(
                len(g)), atol=1e-5)


def test_init_train_state_weights_are_jax_learners():
    """``init_train_state`` splits ``PRNGKey(seed)`` as the JAX learner
    does: the key chain bitwise, the weights to the tolerance above."""
    import jax
    from marl_sortingenv_tpu.config.config import load_config as jload
    from marl_sortingenv_tpu.learn import ppo as jppo

    kw = dict(max_steps=50)
    for name in ("sort", "mono"):
        ts_j = jppo.init_train_state(jload(**kw), jppo.PPOConfig(),
                                     jppo.spec_for(name, "fastb"), 4, seed=42)
        ts_t = ppo.init_train_state(load_config(**kw), ppo.PPOConfig(),
                                    ppo.spec_for(name, "fastb"), 4, seed=42,
                                    device="cpu")
        assert torch.equal(ts_t.key, _key(ts_j.key))
        for a, b in zip(mlp.params_leaves(mlp.params_to_jax(ts_t.params)),
                        jax.tree.leaves(ts_j.params)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


def _state_dict(obs_dim, n_act, seed):
    """An SB3 policy state dict (random weights), with a key of another
    part of the policy that the loaders skip."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for i, din in ((0, obs_dim), (2, 32)):
        for net in ("policy_net", "value_net"):
            sd[f"mlp_extractor.{net}.{i}.weight"] = torch.randn(
                32, din, generator=g)
            sd[f"mlp_extractor.{net}.{i}.bias"] = torch.randn(32, generator=g)
    sd["action_net.weight"] = torch.randn(n_act, 32, generator=g)
    sd["action_net.bias"] = torch.randn(n_act, generator=g)
    sd["value_net.weight"] = torch.randn(1, 32, generator=g)
    sd["value_net.bias"] = torch.randn(1, generator=g)
    sd["log_std"] = torch.zeros(n_act)
    return sd


def _assert_same_params(model, params_j):
    import jax

    for a, b in zip(mlp.params_leaves(mlp.params_to_jax(model)),
                    jax.tree.leaves(params_j)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_from_torch_state_dict_matches_jax():
    from marl_sortingenv_tpu.models import mlp as jmlp

    sd = _state_dict(13, 2, 0)
    model = mlp.from_torch_state_dict(sd, device="cpu")
    _assert_same_params(model, jmlp.from_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}))
    # numpy values load the same
    model_np = mlp.from_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, device="cpu")
    for p, q in zip(model.parameters(), model_np.parameters()):
        assert torch.equal(p, q)
    # the forward is SB3's: tanh towers, then the heads
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 13)).astype(np.float32))
    h = x
    for i in (0, 2):
        h = torch.tanh(h @ sd[f"mlp_extractor.policy_net.{i}.weight"].T
                       + sd[f"mlp_extractor.policy_net.{i}.bias"])
    logits = h @ sd["action_net.weight"].T + sd["action_net.bias"]
    np.testing.assert_allclose(model.policy_logits(x).detach().numpy(),
                               logits.numpy(), rtol=1e-5, atol=1e-6)


def test_load_sb3_zip_matches_jax(tmp_path):
    from marl_sortingenv_tpu.models import mlp as jmlp

    sd = _state_dict(29, 22, 5)
    buf = io.BytesIO()
    torch.save(sd, buf)
    zpath = tmp_path / "PPO_Monolith_100000.zip"
    with zipfile.ZipFile(zpath, "w") as zf:
        zf.writestr("policy.pth", buf.getvalue())
    model = mlp.load_sb3_zip(str(zpath), device="cpu")
    assert (model.obs_dim, model.n_actions) == (29, 22)
    _assert_same_params(model, jmlp.load_sb3_zip(str(zpath)))
