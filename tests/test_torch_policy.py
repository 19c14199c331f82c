"""The port's policy and its slice end to end, against the JAX package on
the CPU with the same (carried-over) weights:

* ``mlp.params_from_jax``: logits and values within rtol 1e-5 / atol 1e-6
  (two f32 matmul implementations), masked argmax equal wherever the top-2
  gap exceeds 1e-4;
* ``ppo.evaluate`` (mono, fastb, masked, deterministic; 128 envs x 200
  steps): per-env returns within 1e-4 relative;
* the fused-policy rollout of bench.py (masked argmax, then
  ``mono_autoreset_step(cfg, "external", True)``; 128 envs x 210 steps):
  equal actions every step and a bitwise-equal final state;
* the port imports neither JAX nor the JAX package, and its entry points
  refuse to run without CUDA unless asked for the CPU.
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_sortingenv_tpu.config.config import load_config as jload
from marl_sortingenv_tpu.core import fastb as FB
from marl_sortingenv_tpu.learn import ppo as jppo
from marl_sortingenv_tpu.models import mlp as jmlp
from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import fastb as TB
from marl_sortingenv_tpu_torch.learn import ppo
from marl_sortingenv_tpu_torch.models import mlp
from test_torch_fastb import assert_state_equal

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def weights():
    params = jmlp.init_params(jax.random.PRNGKey(0), 29, 22)
    params_np = jax.tree.map(np.asarray, params)
    return params, mlp.params_from_jax(params_np, device="cpu")


def test_params_from_jax_same_function(weights):
    params, model = weights
    rng = np.random.default_rng(0)
    obs = rng.uniform(-1, 1, size=(512, 29)).astype(np.float32)
    mask = rng.random((512, 22)) < 0.6
    mask[:, 0] = True
    with torch.no_grad():
        lt = model.policy_logits(torch.from_numpy(obs)).numpy()
        vt = model.value_fn(torch.from_numpy(obs)).numpy()
        at = model.predict_deterministic(torch.from_numpy(obs),
                                         torch.from_numpy(mask)).numpy()
    lj = np.asarray(jmlp.policy_logits(params, obs))
    vj = np.asarray(jmlp.value_fn(params, obs))
    aj = np.asarray(jmlp.predict_deterministic(params, obs, mask))
    np.testing.assert_allclose(lt, lj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=1e-6)
    masked = np.where(mask, lj, -np.inf)
    top2 = np.sort(masked, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 1e-4
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(at[clear], aj[clear])


def test_orthogonal_init_layout():
    g = torch.Generator().manual_seed(0)
    model = mlp.ActorCritic(29, 22, generator=g, device="cpu")
    w = model.mlp_extractor.policy_net[0].weight        # (32, 29)
    np.testing.assert_allclose((w.T @ w).detach().numpy(),
                               2.0 * np.eye(29), atol=1e-5)
    assert set(model.state_dict()) >= {
        "mlp_extractor.policy_net.0.weight", "mlp_extractor.value_net.2.bias",
        "action_net.weight", "value_net.bias"}
    same = mlp.ActorCritic(29, 22, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    for a, b in zip(model.parameters(), same.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name,n_envs,n_steps,max_steps", [
    ("mono", 128, 200, 200), ("sort", 64, 40, 36), ("press", 64, 40, 36)])
def test_evaluate_matches_jax(weights, name, n_envs, n_steps, max_steps):
    spec_t = ppo.spec_for(name, "fastb")
    if name == "mono":
        params, model = weights
    else:
        params = jmlp.init_params(jax.random.PRNGKey(2), spec_t.obs_dim,
                                  spec_t.n_actions)
        model = mlp.params_from_jax(jax.tree.map(np.asarray, params),
                                    device="cpu")
    cfg_kw = dict(bale_mode="events", max_steps=max_steps)
    spec_j = jppo.spec_for(name, engine="fastb")
    ret_j = np.asarray(jppo.evaluate(jload(**cfg_kw), spec_j, params,
                                     n_envs=n_envs, n_steps=n_steps))
    ret_t = ppo.evaluate(load_config(**cfg_kw), spec_t, model,
                         n_envs=n_envs, n_steps=n_steps, device="cpu").numpy()
    np.testing.assert_allclose(ret_t, ret_j, rtol=1e-4, atol=1e-5)


def test_fused_policy_rollout_matches_jax(weights):
    params, model = weights
    cfg_kw = dict(bale_mode="events", max_steps=200)
    cfg_j, cfg_t = jload(**cfg_kw), load_config(**cfg_kw)
    n, steps = 128, 210
    st_j = FB.reset_batch(cfg_j, jax.random.PRNGKey(1), n)
    st_t = TB.reset_batch(cfg_t, 1, n, device="cpu")
    step_j = FB.mono_autoreset_step(cfg_j, "external", True)
    step_t = TB.mono_autoreset_step(cfg_t, "external", True)

    @jax.jit
    def body_j(st, obs):
        masks = FB.monolith_action_masks(cfg_j, st)
        logits = jmlp.masked_logits(jmlp.policy_logits(params, obs), masks)
        a = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        st, out = step_j(st, a)
        return st, out.obs, a

    obs_j = FB.get_mono_obs(cfg_j, st_j)
    obs_t = TB.get_mono_obs(cfg_t, st_t)
    with torch.no_grad():
        for t in range(steps):
            st_j, obs_j, a_j = body_j(st_j, obs_j)
            logits = mlp.masked_logits(model.policy_logits(obs_t),
                                       TB.monolith_action_masks(cfg_t, st_t))
            a_t = torch.argmax(logits, dim=-1).to(torch.int32)
            np.testing.assert_array_equal(np.asarray(a_j), a_t.numpy(),
                                          err_msg=f"actions at step {t}")
            st_t, out_t = step_t(st_t, a_t)
            obs_t = out_t.obs
    assert_state_equal(st_j, st_t, "final")


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "marl_sortingenv_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 8
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "marl_sortingenv_tpu",
                               "optax", "flax"), f"{f} imports {mod}"


def test_entry_points_need_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = load_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TB.reset_batch(cfg, 0, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mlp.ActorCritic(29, 22)
    model = mlp.ActorCritic(29, 22, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ppo.evaluate(cfg, ppo.spec_for("mono", "fastb"), model, 4, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ppo.init_train_state(cfg, ppo.PPOConfig(),
                             ppo.spec_for("mono", "fastb"), 4)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ppo.make_train_iteration(cfg, ppo.PPOConfig(),
                                 ppo.spec_for("mono", "fastb"),
                                 mesh=object())
    # the parity engine's entry points too
    from marl_sortingenv_tpu_torch.core import legacy_random as LR
    from marl_sortingenv_tpu_torch.core import rng as R
    from marl_sortingenv_tpu_torch.core import state as S
    from marl_sortingenv_tpu_torch.eval import harness
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.reset(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        R.pcg64_init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LR.mt19937_init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ppo.evaluate(cfg, ppo.spec_for("mono", "parity"), model, 4, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        harness.run_model_benchmark(cfg, 1, 2)
    # the threefry's one-key draws
    from marl_sortingenv_tpu_torch.core import threefry as TF
    key = TF.prng_key(0, device="cpu")
    for call in (lambda: TF.prng_key(0), lambda: TF.random_bits(key, (4,)),
                 lambda: TF.normal(key, (4,)),
                 lambda: TF.permutation(key, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # the envs, the flow and the CLI
    from marl_sortingenv_tpu_torch import envs, main
    from marl_sortingenv_tpu_torch.learn import trainer
    for cls in (envs.Env_1_Sorting, envs.Env_2_Pressing,
                envs.Env_3_Monolith):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(max_steps=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.run_training_flow(cfg, True, 512, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main.run_sim(main.build_parser().parse_args(["--env-analysis"]))
