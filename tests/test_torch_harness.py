"""The port's engine benchmark (marl_sortingenv_tpu_torch/eval/harness.py:
``run_engine_benchmark``, the 5-policy protocol on the fast engines)
against the JAX package's, on the CPU: both engines, all five policies with
the tuned agents of ``artifacts/models_tuned``, 16 episodes x 60 steps,
masked.  Each policy's mean within 1e-4 of JAX's and its std within 1e-3:
the trajectories are the same, the sorting reward's tanh differs in the
last bits (4 ulp a step, summed over 60 steps).  The JAX engine runs with
x64 off, as in production (see test_torch_fastb_model).  The parity parts
of the harness are held to JAX in test_torch_parity_harness.py."""
import pytest
import torch

from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.eval import harness
from test_torch_fastb_model import agent, jax_agent, no_x64

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)


@pytest.mark.parametrize("engine", ["fastb", "fast"])
def test_engine_benchmark_matches_jax(engine):
    from marl_sortingenv_tpu.config.config import load_config as jload
    from marl_sortingenv_tpu.eval import harness as jharness

    kw = dict(num_episodes=16, steps=60, use_action_masking=True, seed0=1)
    ref = no_x64(jharness.run_engine_benchmark)(
        jload(), engine=engine, sort_params=jax_agent("sort")[1],
        press_params=jax_agent("press")[1], mono_params=jax_agent("mono")[1],
        **kw)
    got = harness.run_engine_benchmark(
        load_config(), engine=engine, sort_params=agent("sort"),
        press_params=agent("press"), mono_params=agent("mono"),
        device="cpu", **kw)
    assert list(got) == harness.POLICY_KEYS == list(ref)
    for k in harness.POLICY_KEYS:
        assert abs(got[k]["mean"] - ref[k]["mean"]) <= 1e-4, (k, got[k],
                                                             ref[k])
        assert abs(got[k]["std"] - ref[k]["std"]) <= 1e-3, (k, got[k], ref[k])


def test_engine_benchmark_options_and_unported_parts():
    cfg = load_config(max_steps=20)
    res = harness.run_engine_benchmark(cfg, "fast", num_episodes=3, steps=4,
                                       include_random=False, device="cpu")
    assert list(res) == ["Rule-Based", "PPO Sort-Only", "PPO Modular"]
    with pytest.raises(ValueError, match="unknown engine"):
        harness.run_engine_benchmark(cfg, "parity", device="cpu")
    # the parity parts run on CUDA unless asked for the CPU
    for fn in (harness.run_episode, harness.benchmark_seed_all,
               harness.run_model_benchmark, harness.compare_engine_drift):
        if torch.cuda.is_available():
            continue
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(cfg, 1, 10)
