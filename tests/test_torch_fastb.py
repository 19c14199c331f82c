"""The port's eager fastb engine (marl_sortingenv_tpu_torch/core/fastb.py)
against the JAX engine on the CPU: long autoreset runs (128 envs, 210 steps
at max_steps=200, so every env crosses an episode boundary).

Every state leaf, obs, action, purity, press reward and the pre-tanh
sorting-reward argument are bitwise equal.  The sorting reward is a tanh,
and XLA-CPU's and torch-CPU's f32 tanh differ in the last bits, so it is
held to 4 ulp; the total reward (sort + press) to 4 ulp of the larger of
the two terms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from marl_sortingenv_tpu.config.config import load_config as jload
from marl_sortingenv_tpu.core import fastb as FB
from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import fastb as TB

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

N = 128

# dtypes of the port's state leaves (the BState comments)
LEAF_DTYPES = {
    "acc_belt": torch.float32, "acc_sorter": torch.float32,
    "input_occupancy": torch.float32, "belt_occupancy": torch.float32,
    "press_q": torch.float32, "ev_mat": torch.int16, "ev_n": torch.int16,
    "ev_q": torch.int16, "bale_size": torch.int16, "bale_qual": torch.int16,
    "last_press_started": torch.bool,
}


def assert_state_equal(st_j, st_t, tag=""):
    for nm, a, b in zip(FB.BState._fields, st_j, st_t):
        if a is None:
            assert b is None, nm
            continue
        assert b.dtype == LEAF_DTYPES.get(nm, torch.int32), (nm, b.dtype)
        a = np.asarray(a)
        if nm == "key":
            a = a.view(np.int32)
        # x64 test mode promotes some JAX sums to int64: compare values
        np.testing.assert_array_equal(a.astype(b.numpy().dtype), b.numpy(),
                                      err_msg=f"{tag} state.{nm}")


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def assert_out_equal(out_j, out_t, tag=""):
    for nm in ("obs", "terminated", "action", "purity", "press_reward"):
        a = np.asarray(getattr(out_j, nm))
        b = getattr(out_t, nm).numpy()
        np.testing.assert_array_equal(a.astype(b.dtype), b,
                                      err_msg=f"{tag} out.{nm}")
    sr_j = np.asarray(out_j.sort_reward, np.float32)
    assert _ulps(sr_j, out_t.sort_reward.numpy()).max() <= 4, tag
    pr_j = np.asarray(out_j.press_reward, np.float32)
    scale = np.spacing(np.maximum(np.abs(sr_j), np.abs(pr_j)))
    err = np.abs(np.asarray(out_j.reward, np.float64)
                 - out_t.reward.numpy().astype(np.float64))
    assert (err <= 4 * scale).all(), tag


def sort_arg_jax(cfg_j):
    """The JAX engine's pre-tanh sorting-reward argument, as its
    ``_sorting_reward`` computes it under jit."""
    def arg(st):
        p = FB._container_purities(cfg_j, st)
        score = jnp.sum(p - jnp.float32(cfg_j.purity_threshold_theta), axis=0)
        return (score / 4.0) * jnp.float32(cfg_j.purity_scaling_factor)
    return jax.jit(arg)


def masked_random_actions(rng, mask):
    """One uniformly drawn valid action per env."""
    mask = np.asarray(mask)
    return np.array([np.flatnonzero(m)[rng.integers(0, m.sum())]
                     for m in mask], np.int32)


def run_pair(cfg_kw, variant, masked, steps, seed, autoreset,
             action_range=None):
    """Step both engines side by side with the same numpy actions; assert
    every step.  Returns the port's final state.  ``action_range=(lo, hi)``
    draws unmasked actions from it, plus the int32 extremes."""
    cfg_j = jload(**cfg_kw)
    cfg_t = load_config(**cfg_kw)
    st_j = FB.reset_batch(cfg_j, jax.random.PRNGKey(seed), N)
    st_t = TB.reset_batch(cfg_t, seed, N, device="cpu")
    assert_state_equal(st_j, st_t, "reset")
    if autoreset:
        fj = jax.jit(FB.mono_autoreset_step(cfg_j, variant, masked))
        ft = TB.mono_autoreset_step(cfg_t, variant, masked)
    else:
        body = {"rule": lambda c, s, a: FB.step_mono_rule(c, s),
                "external": lambda c, s, a: FB.step_mono_external(
                    c, s, a, masked),
                "sort": FB.step_sort,
                "press": lambda c, s, a: FB.step_press(c, s, a, None,
                                                       masked)}[variant]
        fj = jax.jit(lambda s, a: body(cfg_j, s, a))
        tbody = {"rule": lambda c, s, a: TB.step_mono_rule(c, s),
                 "external": lambda c, s, a: TB.step_mono_external(
                     c, s, a, masked),
                 "sort": TB.step_sort,
                 "press": lambda c, s, a: TB.step_press(c, s, a, None,
                                                        masked)}[variant]
        ft = lambda s, a: tbody(cfg_t, s, a)  # noqa: E731
    arg_j = sort_arg_jax(cfg_j)
    rng = np.random.default_rng(seed)
    n_act = {"rule": 22, "external": 22, "sort": 2, "press": 11}[variant]
    crossed = False
    for t in range(steps):
        if action_range is not None:
            a = rng.integers(*action_range, size=N).astype(np.int32)
            a[:2] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max]
        elif masked and variant == "external":
            a = masked_random_actions(rng, FB.monolith_action_masks(cfg_j,
                                                                    st_j))
        elif masked and variant == "press":
            a = masked_random_actions(rng, FB.press_action_masks(cfg_j, st_j))
        else:
            a = rng.integers(0, n_act, size=N).astype(np.int32)
        st_j, out_j = fj(st_j, jnp.asarray(a))
        st_t, out_t = ft(st_t, torch.from_numpy(a))
        assert_state_equal(st_j, st_t, f"step {t}")
        assert_out_equal(out_j, out_t, f"step {t}")
        if not autoreset:
            np.testing.assert_array_equal(
                np.asarray(arg_j(st_j), np.float32),
                TB._sorting_reward_arg(cfg_t, st_t).numpy(),
                err_msg=f"step {t} pre-tanh sort argument")
        crossed |= bool(out_t.terminated.any())
    assert crossed, "no env crossed an episode boundary"
    return st_t


def test_reset_batch_bitwise():
    cfg_kw = dict(bale_mode="events", max_steps=200)
    for seed in (0, 7, 2**33 + 1):
        st_j = FB.reset_batch(jload(**cfg_kw), jax.random.PRNGKey(seed), 333)
        st_t = TB.reset_batch(load_config(**cfg_kw), seed, 333, device="cpu")
        assert_state_equal(st_j, st_t, f"seed {seed}")


def test_reset_batch_needs_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TB.reset_batch(load_config(), 0, 4)


@pytest.mark.parametrize("variant,masked,noise", [
    ("rule", True, 0.0), ("external", True, 0.0), ("external", True, 0.05)])
def test_autoreset_long_run_bitwise(variant, masked, noise):
    run_pair(dict(bale_mode="events", max_steps=200, noise_sorting=noise),
             variant, masked, steps=210, seed=3, autoreset=True)


def test_pre_tanh_sort_argument_and_episode_bitwise():
    """A plain (no autoreset) masked external run past max_steps, with the
    pre-tanh sorting-reward argument compared every step."""
    run_pair(dict(bale_mode="events", max_steps=36), "external", True,
             steps=40, seed=9, autoreset=False)
