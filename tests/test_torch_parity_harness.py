"""The port's parity harness (marl_sortingenv_tpu_torch/eval/harness.py)
on the CPU: ``run_model_benchmark`` with the tuned agents of
``artifacts/models_tuned`` at 3 seeds x 50 steps, masked, every per-seed
total of every policy bitwise equal to the JAX package's.  The reference's
own means and ``run_episode`` are in test_torch_parity_bench.py."""
import pytest
import torch

from marl_sortingenv_tpu.config.config import load_config as jload
from marl_sortingenv_tpu.eval import harness as jharness
from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.eval import harness
from test_torch_fastb_model import agent, jax_agent

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

@pytest.fixture
def jax_compile_cache_for_all():
    """The JAX harness jits a new scan per episode; with the suite's
    persistent compile cache taking every compile, the seeds after the
    first reuse the first seed's programs."""
    import jax

    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


def test_benchmark_per_seed_totals_equal_jax(jax_compile_cache_for_all):
    kw = dict(num_seeds=3, steps=50, use_action_masking=True)
    j_summary, j_rows = jharness.run_model_benchmark(
        jload(), sort_params=jax_agent("sort")[1],
        press_params=jax_agent("press")[1],
        mono_params=jax_agent("mono")[1], **kw)
    t_summary, t_rows = harness.run_model_benchmark(
        load_config(), sort_params=agent("sort"),
        press_params=agent("press"), mono_params=agent("mono"),
        device="cpu", **kw)
    assert t_rows == j_rows
    assert t_summary == j_summary
    assert list(t_summary) == harness.POLICY_KEYS
