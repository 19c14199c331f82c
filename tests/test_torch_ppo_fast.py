"""The port's learner on the batch-first ``fast`` engine
(``spec_for(name, engine="fast")``) against the JAX learner's, on the CPU:
one ``make_train_iteration`` (16 envs x 8 steps, 2 epochs x 4 minibatches)
from the same parameters and key, masked and unmasked mono and the sort
agent.  The tolerances of tests/test_torch_ppo.py: the key chain and the
env state bitwise, the minibatches the same, the parameters to atol 2e-6
after 8 Adam steps, the stats to rtol 1e-4."""
import numpy as np
import pytest
import torch

from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import fast as FE
from marl_sortingenv_tpu_torch.learn import ppo
from marl_sortingenv_tpu_torch.models import mlp
from test_torch_ppo import CFG_KW, _key

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)


@pytest.mark.parametrize("name,masked", [("mono", True), ("mono", False),
                                         ("sort", True)])
def test_fast_train_iteration_matches_jax(name, masked):
    import jax
    from marl_sortingenv_tpu.config.config import load_config as jload
    from marl_sortingenv_tpu.learn import ppo as jppo

    pc = dict(n_steps=8, batch_size=32, n_epochs=2, shuffle_block=4)
    cfg_j, cfg_t = jload(**CFG_KW), load_config(**CFG_KW)
    spec_j, spec_t = jppo.spec_for(name, "fast"), ppo.spec_for(name, "fast")
    pj, pt = jppo.PPOConfig(**pc), ppo.PPOConfig(**pc)
    ts_j = jppo.init_train_state(cfg_j, pj, spec_j, n_envs=16, seed=7)
    ts_t = ppo.init_train_state(cfg_t, pt, spec_t, n_envs=16, seed=7,
                                device="cpu")
    assert isinstance(ts_t.env_state, FE.FastEnvState)
    ts_t = ts_t._replace(params=mlp.params_from_jax(
        jax.tree.map(np.asarray, ts_j.params), device="cpu"))
    ts_j, stats_j = jax.jit(jppo.make_train_iteration(
        cfg_j, pj, spec_j, use_action_masking=masked))(ts_j)
    ts_t, stats = ppo.make_train_iteration(
        cfg_t, pt, spec_t, use_action_masking=masked)(ts_t)
    assert torch.equal(ts_t.key, _key(ts_j.key))
    for nm, a, b in zip(FE.FastEnvState._fields, ts_j.env_state,
                        ts_t.env_state):
        a = np.asarray(a)
        np.testing.assert_array_equal(
            b.numpy(), (a.view(np.int32) if nm == "key" else a).astype(
                b.numpy().dtype), err_msg=nm)
    for k, v in stats_j.items():
        np.testing.assert_allclose(float(stats[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for (nm, p), q in zip(ts_t.params.named_parameters(),
                          jax.tree.leaves(ts_j.params)):
        q = np.asarray(q)
        np.testing.assert_allclose(p.detach().numpy(),
                                   q.T if q.ndim == 2 else q, rtol=0,
                                   atol=2e-6, err_msg=nm)


def test_parity_engine_still_raises():
    """The engine names: 'parity' (the default since the parity engine
    was ported) and the fast engines; any other name raises."""
    with pytest.raises(ValueError, match="unknown engine"):
        ppo.spec_for("mono", engine="exact")
    assert ppo.spec_for("mono").engine == "parity"
    spec = ppo.spec_for("press", engine="fast")
    assert spec._mod() is FE
