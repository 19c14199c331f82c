"""The port's PPO learner (marl_sortingenv_tpu_torch/learn/ppo.py) against
the JAX package's, both in one process on the CPU.

Tolerances, and why:
* the learner's random draws (``threefry.random_bits`` / ``permutation``)
  are bitwise; ``categorical`` is held on the chosen actions (equal),
  since torch's and XLA's f32 ``log`` may differ in the last bit;
* env leaves of a rollout are bitwise; rewards that pass through the
  sorting reward's tanh to 4 ulp of 1 (the tanh differs in the last bits);
* the policy's products round differently in torch and XLA: logp, values,
  losses and gradients to rtol 1e-5 (atol 1e-6 where a value can be ~0);
* GAE is a chain of f32 multiply-adds over T steps: rtol 1e-6, atol 1e-6;
* one clip + Adam step: rtol 1e-6 on the parameters (the global norm sums
  in another order);
* a whole ``ppo_update`` (2 epochs x 4 minibatches): the same minibatches
  (the key chain is bitwise), parameters to atol 2e-6 after 8 Adam steps
  of lr 3e-4.

Learning floors (tests/test_ppo.py:79-161 on the port): the same settings
and floors as the JAX package's; the setup is here, the three tests are in
tests/test_torch_floor_{sort,press,mono}.py.

On the card (marker ``cuda``): one ``make_train_iteration`` per variant at
a small width runs and launches the expected kernels.
"""
import os

import numpy as np
import pytest
import torch

from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import fastb as TB
from marl_sortingenv_tpu_torch.core import threefry as TF
from marl_sortingenv_tpu_torch.learn import ppo
from marl_sortingenv_tpu_torch.models import mlp
from marl_sortingenv_tpu_torch.ops import sort_cuda, step_cuda

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

CFG_KW = dict(max_steps=50, noise_sorting=0.0, balesize=200)
SORT_NPZ = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                        "models_tuned", "PPO_Sorting_Tuned_100000.npz")
RTOL = 1e-5


def _key(k):
    """A JAX key as the port's int32[2] CPU tensor."""
    return torch.from_numpy(np.asarray(k).view(np.int32).copy())


def _grads_jax_order(model):
    """``model``'s parameter gradients in the JAX package's leaf order and
    layout (w as [in, out])."""
    out = []
    for name, p in model.named_parameters():
        g = p.grad.numpy()
        out.append(g.T if name.endswith("weight") else g)
    return out


# ---------------------------------------------------------------------------
# the learner's draws
# ---------------------------------------------------------------------------

def test_random_bits_and_permutation_bitwise():
    import jax

    for seed in (0, 7, 2**40 + 3):
        key = jax.random.PRNGKey(seed)
        kt = _key(key)
        assert torch.equal(_key(jax.random.split(key)), TF.split_key(kt))
        for shape in ((1,), (37, 5), (3, 4, 22)):
            ref = np.asarray(jax.random.bits(key, shape, dtype=np.uint32)
                             ).astype(np.int64)
            np.testing.assert_array_equal(
                TF.random_bits(kt, shape, "cpu").numpy(), ref)
        for n in (1, 2, 129, 2048, 70000):
            np.testing.assert_array_equal(
                TF.permutation(kt, n, "cpu").numpy(),
                np.asarray(jax.random.permutation(key, n)))


def test_categorical_actions_equal_jax():
    """20,000 masked draws over 22 actions: every action equal."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    logits = (3 * rng.normal(size=(20000, 22))).astype(np.float32)
    mask = rng.random((20000, 22)) < 0.5
    mask[:, 0] = True
    lg = np.where(mask, logits, np.finfo(np.float32).min).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax.random.categorical(key, jnp.asarray(lg)))
    got = TF.categorical(_key(key), torch.from_numpy(lg)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert mask[np.arange(20000), got].all()


# ---------------------------------------------------------------------------
# GAE, loss, optimizer, mask packing
# ---------------------------------------------------------------------------

def _transition_j(trs):
    import jax.numpy as jnp
    from marl_sortingenv_tpu.learn import ppo as jppo
    return jppo.Transition(*[jnp.asarray(x.numpy()) for x in trs])


def test_compute_gae_matches_jax():
    import jax
    import jax.numpy as jnp
    from marl_sortingenv_tpu.learn import ppo as jppo

    T, N = 16, 40
    rng = np.random.default_rng(0)
    trs = ppo.Transition(
        obs=torch.zeros((T, 1, N)), mask=torch.ones((T, 2, N), dtype=bool),
        action=torch.zeros((T, N), dtype=torch.int32),
        logp=torch.zeros((T, N)),
        value=torch.from_numpy(rng.normal(size=(T, N)).astype(np.float32)),
        reward=torch.from_numpy(rng.normal(size=(T, N)).astype(np.float32)),
        done=torch.from_numpy(rng.random((T, N)) < 0.2))
    last = rng.normal(size=N).astype(np.float32)
    for pc in (ppo.PPOConfig(), ppo.PPOConfig(gamma=0.95, gae_lambda=0.9)):
        pj = jppo.PPOConfig(gamma=pc.gamma, gae_lambda=pc.gae_lambda)
        adv_j, ret_j = jax.jit(lambda t, lv: jppo.compute_gae(pj, t, lv))(
            _transition_j(trs), jnp.asarray(last))
        adv, ret = ppo.compute_gae(pc, trs, torch.from_numpy(last))
        np.testing.assert_allclose(adv.numpy(), np.asarray(adv_j),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ret.numpy(), np.asarray(ret_j),
                                   rtol=1e-6, atol=1e-6)


def _minibatch(rng, D, A, B):
    obs = rng.normal(size=(D, B)).astype(np.float32)
    mask = rng.random((A, B)) < 0.6
    mask[0] = True
    action = np.array([rng.choice(np.flatnonzero(mask[:, b]))
                       for b in range(B)], np.int32)
    old_logp = (-rng.random(B) * 3).astype(np.float32)
    adv = rng.normal(size=B).astype(np.float32)
    ret = rng.normal(size=B).astype(np.float32)
    return obs, mask, action, old_logp, adv, ret


@pytest.mark.parametrize("name", ["sort", "press", "mono"])
def test_loss_value_stats_and_grads_match_jax(name):
    import jax
    import jax.numpy as jnp
    from marl_sortingenv_tpu.learn import ppo as jppo
    from marl_sortingenv_tpu.models import mlp as jmlp

    spec = ppo.spec_for(name, "fastb")
    params_j = jmlp.init_params(jax.random.PRNGKey(3), spec.obs_dim,
                                spec.n_actions)
    model = mlp.params_from_jax(jax.tree.map(np.asarray, params_j),
                                device="cpu")
    rng = np.random.default_rng(4)
    batch = _minibatch(rng, spec.obs_dim, spec.n_actions, 256)
    pj = jppo.PPOConfig.tuned()
    (loss_j, stats_j), grads_j = jax.value_and_grad(
        jppo._loss_fn, has_aux=True)(params_j, pj,
                                     tuple(jnp.asarray(x) for x in batch))
    loss, stats = ppo._loss_fn(model, ppo.PPOConfig.tuned(),
                               tuple(torch.from_numpy(x) for x in batch))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=RTOL)
    for k, v in stats_j.items():
        np.testing.assert_allclose(float(stats[k]), float(v), rtol=RTOL,
                                   atol=1e-6, err_msg=k)
    for g, gj in zip(_grads_jax_order(model), jax.tree.leaves(grads_j)):
        np.testing.assert_allclose(g, np.asarray(gj), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("scale", [1e-3, 10.0], ids=["unclipped", "clipped"])
def test_clip_adam_steps_match_optax(scale):
    """Two clip + Adam steps from the same gradients (the count and the
    bias corrections move), each branch of the clip."""
    import jax
    import optax
    from marl_sortingenv_tpu.learn import ppo as jppo
    from marl_sortingenv_tpu.models import mlp as jmlp

    params_j = jmlp.init_params(jax.random.PRNGKey(1), 29, 22)
    model = mlp.params_from_jax(jax.tree.map(np.asarray, params_j),
                                device="cpu")
    rng = np.random.default_rng(2)
    pc = ppo.PPOConfig.tuned()
    opt_j = jppo.make_optimizer(jppo.PPOConfig.tuned())
    state_j = opt_j.init(params_j)
    opt = ppo.make_optimizer(pc)
    state = opt.init(model)
    flat = ppo.flat_parameters(model)
    for _ in range(2):
        grads_j = jax.tree.map(
            lambda x: (scale * rng.normal(size=x.shape)).astype(np.float32),
            params_j)
        upd_j, state_j = opt_j.update(grads_j, state_j, params_j)
        params_j = optax.apply_updates(params_j, upd_j)
        g = torch.cat([torch.from_numpy(
            (x.T if x.ndim == 2 else x).copy()).reshape(-1)
            for x in jax.tree.leaves(grads_j)])
        upd, state = opt.update(g, state)
        flat.add_(upd)
    assert int(state.count) == 2
    for (name, p), pj in zip(model.named_parameters(),
                             jax.tree.leaves(params_j)):
        pj = np.asarray(pj)
        np.testing.assert_allclose(p.detach().numpy(),
                                   pj.T if pj.ndim == 2 else pj, rtol=1e-6,
                                   atol=1e-9, err_msg=name)


def test_mask_bitpack_roundtrip_exact():
    A, B = 22, 64
    rng = np.random.default_rng(0)
    mask = rng.integers(0, 2, size=(A, B)).astype(bool)
    mask[:, 0] = True
    mask[:, 1] = False
    m = torch.from_numpy(mask)
    bits = ppo.pack_mask(m)
    assert bits.dtype == torch.float32
    assert torch.equal(ppo.unpack_mask(bits, A), m)
    with pytest.raises(ValueError, match="A <= 22"):
        ppo.pack_mask(torch.ones((23, 2), dtype=torch.bool))


# ---------------------------------------------------------------------------
# rollout and update against the JAX learner
# ---------------------------------------------------------------------------

def _pair_states(name, n_envs, pcfg_kw, seed=7):
    """The JAX and port train states of one config, the port's carrying the
    JAX parameters."""
    import jax
    from marl_sortingenv_tpu.config.config import load_config as jload
    from marl_sortingenv_tpu.learn import ppo as jppo

    cfg_j, cfg_t = jload(**CFG_KW), load_config(**CFG_KW)
    spec_j = jppo.spec_for(name, engine="fastb")
    spec_t = ppo.spec_for(name, "fastb")
    pj, pt = jppo.PPOConfig(**pcfg_kw), ppo.PPOConfig(**pcfg_kw)
    ts_j = jppo.init_train_state(cfg_j, pj, spec_j, n_envs=n_envs, seed=seed)
    ts_t = ppo.init_train_state(cfg_t, pt, spec_t, n_envs=n_envs, seed=seed,
                                device="cpu")
    assert torch.equal(ts_t.key, _key(ts_j.key))
    ts_t = ts_t._replace(params=mlp.params_from_jax(
        jax.tree.map(np.asarray, ts_j.params), device="cpu"))
    return (cfg_j, spec_j, pj, ts_j), (cfg_t, spec_t, pt, ts_t)


@pytest.mark.parametrize("masked", [True, False])
def test_collect_rollout_mono_matches_jax(masked):
    """16 envs x 8 steps with the JAX parameters: env leaves bitwise,
    actions equal, logp and values to rtol 1e-5."""
    import jax

    (cfg_j, spec_j, pj, ts_j), (cfg_t, spec_t, pt, ts_t) = _pair_states(
        "mono", 16, dict(n_steps=8, batch_size=32, n_epochs=1))
    from marl_sortingenv_tpu.learn import ppo as jppo
    step_j = spec_j.step_fn(None, masked)
    ts_j, trs_j, lv_j = jax.jit(lambda ts: jppo.collect_rollout(
        cfg_j, pj, spec_j, ts, step_j, masked))(ts_j)
    ts_t, trs, lv = ppo.collect_rollout(cfg_t, pt, spec_t, ts_t,
                                        spec_t.step_fn(None, masked), masked)
    np.testing.assert_array_equal(trs.action.numpy(),
                                  np.asarray(trs_j.action))
    for nm in ("obs", "mask", "done"):
        np.testing.assert_array_equal(getattr(trs, nm).numpy(),
                                      np.asarray(getattr(trs_j, nm)),
                                      err_msg=nm)
    tol = 4 * np.spacing(np.float32(1.0))
    np.testing.assert_allclose(trs.reward.numpy(), np.asarray(trs_j.reward),
                               rtol=0, atol=tol)
    for nm in ("logp", "value"):
        np.testing.assert_allclose(getattr(trs, nm).numpy(),
                                   np.asarray(getattr(trs_j, nm)),
                                   rtol=RTOL, atol=1e-6, err_msg=nm)
    np.testing.assert_allclose(lv.numpy(), np.asarray(lv_j), rtol=RTOL,
                               atol=1e-6)
    for nm, a, b in zip(TB.BState._fields, ts_j.env_state, ts_t.env_state):
        if a is None:
            continue
        a = np.asarray(a)
        np.testing.assert_array_equal(
            b.numpy(), a.view(np.int32) if nm == "key" else a, err_msg=nm)
    assert torch.equal(ts_t.key, _key(ts_j.key))
    np.testing.assert_allclose(ts_t.ep_return_acc.numpy(),
                               np.asarray(ts_j.ep_return_acc), rtol=0,
                               atol=8 * tol)


def test_ppo_update_matches_jax():
    """The same minibatches (the key chain is bitwise), parameters to
    atol 2e-6 after 2 epochs x 4 minibatches of shuffle_block 4."""
    import jax
    import jax.numpy as jnp
    from marl_sortingenv_tpu.learn import ppo as jppo

    pc = dict(n_steps=8, batch_size=32, n_epochs=2, shuffle_block=4)
    (cfg_j, spec_j, pj, ts_j), (cfg_t, spec_t, pt, ts_t) = _pair_states(
        "mono", 16, pc)
    assert ppo.minibatch_layout(pt, 128) == (4, 32, 4, 32, 8)
    T, N, D, A = 8, 16, 29, 22
    rng = np.random.default_rng(9)
    mask = rng.random((T, A, N)) < 0.5
    mask[:, 0] = True
    action = np.zeros((T, N), np.int32)
    for t in range(T):
        for n in range(N):
            action[t, n] = rng.choice(np.flatnonzero(mask[t, :, n]))
    trs = ppo.Transition(
        obs=torch.from_numpy(rng.random((T, D, N)).astype(np.float32)),
        mask=torch.from_numpy(mask), action=torch.from_numpy(action),
        logp=torch.from_numpy((-3 * rng.random((T, N))).astype(np.float32)),
        value=torch.from_numpy(rng.normal(size=(T, N)).astype(np.float32)),
        reward=torch.from_numpy(rng.normal(size=(T, N)).astype(np.float32)),
        done=torch.from_numpy(rng.random((T, N)) < 0.1))
    adv = rng.normal(size=(T, N)).astype(np.float32)
    ret = rng.normal(size=(T, N)).astype(np.float32)
    ts_j2, stats_j = jax.jit(lambda ts, tr, a, r: jppo.ppo_update(
        pj, ts, tr, a, r))(ts_j, _transition_j(trs), jnp.asarray(adv),
                           jnp.asarray(ret))
    ts_t2, stats = ppo.ppo_update(pt, ts_t, trs, torch.from_numpy(adv),
                                  torch.from_numpy(ret))
    assert torch.equal(ts_t2.key, _key(ts_j2.key))
    assert int(ts_t2.update_count) == int(ts_j2.update_count) == 1
    assert int(ts_t2.opt_state.count) == 8
    for k, v in stats_j.items():
        np.testing.assert_allclose(float(stats[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for (name, p), pj_ in zip(ts_t2.params.named_parameters(),
                              jax.tree.leaves(ts_j2.params)):
        pj_ = np.asarray(pj_)
        np.testing.assert_allclose(p.detach().numpy(),
                                   pj_.T if pj_.ndim == 2 else pj_,
                                   rtol=0, atol=2e-6, err_msg=name)
    # the update left the incoming state's parameters as they were
    for p, q in zip(ts_t.params.parameters(),
                    mlp.params_from_jax(jax.tree.map(np.asarray, ts_j.params),
                                        device="cpu").parameters()):
        assert torch.equal(p, q)


def test_evaluate_stochastic_matches_jax():
    """``evaluate(deterministic=False)``: the same key chain and draws, so
    the same returns (to the tanh's ulps summed over 50 steps)."""
    import jax
    from marl_sortingenv_tpu.config.config import load_config as jload
    from marl_sortingenv_tpu.learn import ppo as jppo
    from marl_sortingenv_tpu.models import mlp as jmlp

    params_j = jmlp.init_params(jax.random.PRNGKey(5), 29, 22)
    model = mlp.params_from_jax(jax.tree.map(np.asarray, params_j),
                                device="cpu")
    ref = jppo.evaluate(jload(**CFG_KW), jppo.spec_for("mono", "fastb"),
                        params_j, 8, 50, deterministic=False)
    got = ppo.evaluate(load_config(**CFG_KW), ppo.spec_for("mono", "fastb"),
                       model,
                       8, 50, deterministic=False, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


def test_train_iteration_and_run_agree():
    """``make_train_run`` is ``n_iters`` chained ``make_train_iteration``
    calls (the port has no scan to differ): bitwise on the CPU."""
    cfg = load_config(**CFG_KW)
    pc = ppo.PPOConfig(n_steps=8, batch_size=16, n_epochs=2)
    spec = ppo.spec_for("mono", "fastb")
    it = ppo.make_train_iteration(cfg, pc, spec)
    ts_a = ppo.init_train_state(cfg, pc, spec, 4, seed=7, device="cpu")
    losses = []
    for _ in range(3):
        ts_a, stats = it(ts_a)
        losses.append(float(stats["loss"]))
    ts_b = ppo.init_train_state(cfg, pc, spec, 4, seed=7, device="cpu")
    ts_b, seg = ppo.make_train_run(cfg, pc, spec, 3)(ts_b)
    assert seg["mean_episode_return"].shape == (3,)
    assert seg["loss"].tolist() == losses
    for p, q in zip(ts_a.params.parameters(), ts_b.params.parameters()):
        assert torch.equal(p, q)


# ---------------------------------------------------------------------------
# learning floors (tests/test_ppo.py:79-161 on the port): the setup here,
# one test per file in tests/test_torch_floor_{sort,press,mono}.py, so that
# workers that take whole files run the three floors side by side
# ---------------------------------------------------------------------------

def _floor_setup(name, sort_policy=None):
    cfg = load_config(max_steps=200, noise_sorting=0.0, balesize=200)
    pcfg = ppo.PPOConfig.tuned(n_steps=128, batch_size=256, n_epochs=4)
    spec = ppo.spec_for(name, "fastb")
    ts = ppo.init_train_state(cfg, pcfg, spec, n_envs=32, seed=42,
                              device="cpu")

    def ev(params):
        return float(ppo.evaluate(cfg, spec, params, n_envs=16, n_steps=200,
                                  sort_policy=sort_policy,
                                  device="cpu").mean())

    it = ppo.make_train_iteration(cfg, pcfg, spec, sort_policy=sort_policy)
    return ts, it, ev


def _learn(name, iters, sort_policy=None):
    ts, it, ev = _floor_setup(name, sort_policy)
    r0 = ev(ts.params)
    for _ in range(iters):
        ts, stats = it(ts)
    assert np.isfinite(float(stats["loss"]))
    return r0, ev(ts.params)


# ---------------------------------------------------------------------------
# CUDA: one training iteration on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sort", "press", "mono"])
def test_cuda_train_iteration_launches_kernels(cuda, name):
    """64 envs x 16 steps: kernel 1 once per step for sort and mono, kernel
    2 once per step (and kernel 1 never) for press with the frozen sort
    agent; finite loss, parameters that moved."""
    cfg = load_config(max_steps=50)
    pc = ppo.PPOConfig(n_steps=16, batch_size=256, n_epochs=2,
                       shuffle_block=16)
    spec = ppo.spec_for(name, "fastb")
    sp = (mlp.load_npz(SORT_NPZ, device=cuda).requires_grad_(False)
          if name == "press" else None)
    ts = ppo.init_train_state(cfg, pc, spec, 64, device=cuda)
    it = ppo.make_train_iteration(cfg, pc, spec, sort_policy=sp)
    k1, k2 = step_cuda.LAUNCHES, sort_cuda.LAUNCHES
    ts2, stats = it(ts)
    torch.cuda.synchronize()
    d1, d2 = step_cuda.LAUNCHES - k1, sort_cuda.LAUNCHES - k2
    assert (d1, d2) == ((0, 16) if name == "press" else (16, 0))
    assert np.isfinite(float(stats["loss"]))
    assert any(not torch.equal(p, q) for p, q in zip(
        ts.params.parameters(), ts2.params.parameters()))
