"""The port's trainer and checkpoints (marl_sortingenv_tpu_torch/learn/
trainer.py, utils/checkpoint.py) on the CPU, modelled on
tests/test_trainer_and_eval.py.

* model files: save / rotate / find, and ``.npz`` files passing between the
  JAX package and the port both ways (the same logits to rtol 1e-5: torch
  and XLA round the products differently);
* the full train state round-trips bitwise through ``save_train_state`` /
  ``restore_train_state``;
* ``train_agent`` at a tiny size for each variant (press with a frozen sort
  agent), and its evals on the JAX trainer's iterations;
* a killed-and-resumed ``train_agent`` ends bitwise equal to an
  uninterrupted one.
"""
import os

import numpy as np
import pytest
import torch

from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import fastb as TB
from marl_sortingenv_tpu_torch.learn import ppo, trainer
from marl_sortingenv_tpu_torch.models import mlp
from marl_sortingenv_tpu_torch.utils import checkpoint as CK

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

CFG = load_config(max_steps=40, noise_sorting=0.0, balesize=200)
SORT_NPZ = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                        "models_tuned", "PPO_Sorting_Tuned_100000.npz")


def _model(obs_dim=13, n_actions=2, seed=0):
    return mlp.ActorCritic(obs_dim, n_actions, device="cpu",
                           generator=torch.Generator().manual_seed(seed))


def _same_params(a, b):
    return all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))


def test_checkpoint_save_rotate_find(tmp_path):
    d = str(tmp_path / "models")
    params = _model()
    p1 = CK.save_model(params, "PPO_Sorting", 100, d)
    assert os.path.exists(p1)
    p2 = CK.save_model(params, "PPO_Sorting", 200, d)
    assert os.path.exists(p2)
    assert os.path.exists(os.path.join(d, "prev", "PPO_Sorting_100.npz"))
    assert CK.find_latest_model("PPO_Sorting", d) == p2
    assert CK.find_latest_model("PPO_Pressing", d) is None
    assert _same_params(CK.load_model(p2, params), params)
    with pytest.raises(ValueError, match="shaped"):
        CK.load_model(p2, _model(29, 22))


def test_npz_files_pass_between_jax_and_the_port(tmp_path):
    import jax
    import jax.numpy as jnp
    from marl_sortingenv_tpu.models import mlp as jmlp
    from marl_sortingenv_tpu.utils import checkpoint as JCK

    obs = np.random.default_rng(0).random((64, 29)).astype(np.float32)
    # JAX writes, the port reads
    pj = jmlp.init_params(jax.random.PRNGKey(4), 29, 22)
    path = JCK.save_model(pj, "PPO_Monolith", 5, str(tmp_path / "a"))
    model = CK.load_model(path, device="cpu")
    with torch.no_grad():
        lt = model.policy_logits(torch.from_numpy(obs)).numpy()
        vt = model.value_fn(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(
        lt, np.asarray(jmlp.policy_logits(pj, jnp.asarray(obs))), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(
        vt, np.asarray(jmlp.value_fn(pj, jnp.asarray(obs))), rtol=1e-5,
        atol=1e-6)
    # the port writes, JAX reads: the very same arrays
    path2 = CK.save_model(model, "PPO_Monolith", 6, str(tmp_path / "b"))
    back = JCK.load_model(path2, pj)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(pj)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # the tuned sort agent of the repository loads with numpy alone
    sp = mlp.load_npz(SORT_NPZ, device="cpu")
    assert (sp.obs_dim, sp.n_actions) == (13, 2)


def test_train_state_round_trip_bitwise(tmp_path):
    pc = ppo.PPOConfig(n_steps=8, batch_size=16, n_epochs=1)
    spec = ppo.spec_for("mono", "fastb")
    ts = ppo.init_train_state(CFG, pc, spec, 4, seed=1, device="cpu")
    ts, _ = ppo.make_train_iteration(CFG, pc, spec)(ts)
    tree = {"ts": ts, "iter": 3, "best_eval": -1.5, "best_params": ts.params,
            "next_eval": 7}
    CK.save_train_state(str(tmp_path), 64, tree)
    CK.save_train_state(str(tmp_path), 128, tree)
    CK.save_train_state(str(tmp_path), 192, tree)
    assert CK.latest_step(str(tmp_path)) == 192
    CK.prune_train_states(str(tmp_path), keep=2)
    assert sorted(d for d in os.listdir(tmp_path)) == ["step_128", "step_192"]
    like = trainer._resume_tree(
        ppo.init_train_state(CFG, pc, spec, 4, seed=2, device="cpu"),
        -np.inf, 0)
    r = CK.restore_train_state(str(tmp_path), 192, like)
    assert (r["iter"], r["best_eval"], r["next_eval"]) == (3, -1.5, 7)
    assert _same_params(r["ts"].params, ts.params)
    assert _same_params(r["best_params"], ts.params)
    for a, b in zip(r["ts"].opt_state, ts.opt_state):
        assert torch.equal(a, b)
    for nm, a, b in zip(TB.BState._fields, r["ts"].env_state, ts.env_state):
        assert (a is None and b is None) or torch.equal(a, b), nm
    for nm in ("obs", "key", "ep_return_acc", "last_ep_return",
               "update_count"):
        assert torch.equal(getattr(r["ts"], nm), getattr(ts, nm)), nm


@pytest.mark.parametrize("variant", ["sort", "press", "mono"])
def test_train_agent_tiny(tmp_path, variant):
    """Every variant trains, evaluates, saves its best and final models."""
    sort_params = (mlp.load_npz(SORT_NPZ, device="cpu")
                   if variant == "press" else None)
    res = trainer.train_agent(
        CFG, variant, total_timesteps=2 * 32 * 8, n_envs=8,
        sort_params=sort_params, eval_freq=32 * 8, eval_envs=4,
        models_dir=str(tmp_path), save_prefix=f"PPO_{variant}",
        pcfg=ppo.PPOConfig(n_steps=32, batch_size=64, n_epochs=2),
        verbose=False, device="cpu")
    assert np.isfinite(res.final_eval_mean)
    assert len(res.history) == 2
    assert all(np.isfinite(h["loss"]) for h in res.history)
    assert CK.find_latest_model(f"PPO_{variant}", str(tmp_path)) is not None
    # the final save rotates the best model (same prefix) into prev/
    assert CK.find_latest_model(f"PPO_{variant}_best",
                                str(tmp_path / "prev")) is not None


def _jax_eval_steps(n_iters, samples_per_iter, eval_freq, seg_cap=8):
    """The steps at which the JAX trainer evaluates: it runs segments of up
    to ``seg_cap`` iterations, cut where the samples reach the next eval
    threshold, and evaluates after a segment that reached it."""
    k, next_eval, out = 0, eval_freq, []
    while k < n_iters:
        next_eval_iter = max(k + 1, -(-next_eval // samples_per_iter))
        k += min(next_eval_iter - k, n_iters - k, seg_cap)
        if k * samples_per_iter >= next_eval:
            next_eval += eval_freq
            out.append(k * samples_per_iter)
    return out


class _EvalSteps:
    def __init__(self):
        self.steps = []

    def log(self, step, metrics):
        if "eval/mean_return" in metrics:
            self.steps.append(step)


@pytest.mark.parametrize("eval_freq", [20, 100, 300])
def test_train_agent_evals_on_jax_iterations(eval_freq):
    """Evals land on the iterations the JAX trainer evaluates on, for eval
    frequencies below, between and above the samples of an iteration."""
    log = _EvalSteps()
    trainer.train_agent(
        CFG, "mono", total_timesteps=320, n_envs=4, eval_freq=eval_freq,
        eval_envs=2, pcfg=ppo.PPOConfig(n_steps=8, batch_size=16, n_epochs=1),
        logger=log, verbose=False, device="cpu")
    assert log.steps == _jax_eval_steps(10, 32, eval_freq)


def test_train_resume_bitwise(tmp_path, monkeypatch):
    """Kill a run at its 2nd eval, resume from the full-state checkpoint:
    the resumed run's parameters are bitwise those of an uninterrupted
    run."""
    pcfg = ppo.PPOConfig(n_steps=16, batch_size=32, n_epochs=2)
    kw = dict(total_timesteps=1024, n_envs=8, use_action_masking=True,
              eval_freq=256, eval_envs=4, seed=3, pcfg=pcfg, verbose=False,
              device="cpu")
    ref = trainer.train_agent(CFG, "mono", models_dir=str(tmp_path / "mA"),
                              ckpt_dir=str(tmp_path / "ckA"), **kw)

    ck = str(tmp_path / "ckB")
    real_eval = ppo.evaluate
    calls = {"n": 0}

    def killing_eval(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt("simulated kill")
        return real_eval(*a, **k)

    monkeypatch.setattr(trainer.ppo, "evaluate", killing_eval)
    with pytest.raises(KeyboardInterrupt):
        trainer.train_agent(CFG, "mono", models_dir=str(tmp_path / "mB"),
                            ckpt_dir=ck, **kw)
    monkeypatch.setattr(trainer.ppo, "evaluate", real_eval)
    # the checkpoint on disk is from the FIRST eval boundary only
    assert CK.latest_step(ck) == 256

    res = trainer.train_agent(CFG, "mono", models_dir=str(tmp_path / "mB"),
                              ckpt_dir=ck, resume=True, **kw)
    assert _same_params(ref.params, res.params)
    assert res.final_eval_mean == ref.final_eval_mean
    steps = [d for d in os.listdir(ck) if d.startswith("step_")]
    assert 1 <= len(steps) <= 2
