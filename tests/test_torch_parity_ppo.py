"""The port's learner on the bit-exact parity engine
(``spec_for(name)``, whose default engine is now 'parity', as the JAX
package's) against the JAX learner's, on the CPU: ``init_train_state``
and one ``make_train_iteration`` (8 envs x 8 steps, 2 epochs x 2
minibatches) from the same parameters and key.  The tolerances of
tests/test_torch_ppo.py: the key chain and the env state bitwise (every
leaf), the f64 episode returns bitwise, the parameters to atol 2e-6, the
stats to rtol 1e-4.  Then ``train_agent(engine="parity")`` runs end to
end and ``evaluate`` sums its f64 rewards in f64."""
import numpy as np
import pytest
import torch

import jax

from marl_sortingenv_tpu.config.config import load_config as jload
from marl_sortingenv_tpu.learn import ppo as jppo
from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import state as S
from marl_sortingenv_tpu_torch.learn import ppo, trainer
from marl_sortingenv_tpu_torch.models import mlp
from test_torch_ppo import _key

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

CFG_KW = dict(max_steps=6)


@pytest.mark.parametrize("name,masked", [("mono", True), ("sort", True)])
def test_parity_train_iteration_matches_jax(name, masked):
    pc = dict(n_steps=8, batch_size=32, n_epochs=2)
    cfg_j, cfg_t = jload(**CFG_KW), load_config(**CFG_KW)
    spec_j, spec_t = jppo.spec_for(name), ppo.spec_for(name)
    assert spec_j.engine == spec_t.engine == "parity"
    pj, pt = jppo.PPOConfig(**pc), ppo.PPOConfig(**pc)
    ts_j = jppo.init_train_state(cfg_j, pj, spec_j, n_envs=8, seed=7,
                                 env_seed0=3)
    ts_t = ppo.init_train_state(cfg_t, pt, spec_t, n_envs=8, seed=7,
                                env_seed0=3, device="cpu")
    assert ts_t.ep_return_acc.dtype == torch.float64
    for a, b in zip(S.to_numpy(ts_t.env_state),
                    jax.tree.leaves(ts_j.env_state)):
        assert np.array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(ts_t.obs.numpy(), np.asarray(ts_j.obs))
    ts_t = ts_t._replace(params=mlp.params_from_jax(
        jax.tree.map(np.asarray, ts_j.params), device="cpu"))
    ts_j, stats_j = jax.jit(jppo.make_train_iteration(
        cfg_j, pj, spec_j, use_action_masking=masked))(ts_j)
    ts_t, stats = ppo.make_train_iteration(
        cfg_t, pt, spec_t, use_action_masking=masked)(ts_t)
    assert torch.equal(ts_t.key, _key(ts_j.key))
    for (nm, _), a, b in zip(S.named_leaves(ts_t.env_state),
                             S.to_numpy(ts_t.env_state),
                             jax.tree.leaves(ts_j.env_state)):
        assert np.array_equal(a, np.asarray(b)), nm
    for f in ("ep_return_acc", "last_ep_return"):
        got, want = getattr(ts_t, f).numpy(), np.asarray(getattr(ts_j, f))
        assert got.dtype == want.dtype == np.float64
        assert np.array_equal(got, want), f
    for k, v in stats_j.items():
        np.testing.assert_allclose(float(stats[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for (nm, p), q in zip(ts_t.params.named_parameters(),
                          jax.tree.leaves(ts_j.params)):
        q = np.asarray(q)
        np.testing.assert_allclose(p.detach().numpy(),
                                   q.T if q.ndim == 2 else q, rtol=0,
                                   atol=2e-6, err_msg=nm)


def test_train_agent_and_evaluate_on_parity(tmp_path):
    cfg = load_config(max_steps=8)
    res = trainer.train_agent(cfg, "press", 64, n_envs=4, engine="parity",
                              eval_freq=32, eval_envs=2,
                              models_dir=str(tmp_path), verbose=False,
                              device="cpu")
    assert np.isfinite(res.final_eval_mean)
    rets = ppo.evaluate(cfg, ppo.spec_for("mono"),
                        mlp.ActorCritic(29, 22, device="cpu"), 3, 8,
                        device="cpu")
    assert rets.dtype == torch.float64 and rets.shape == (3,)
