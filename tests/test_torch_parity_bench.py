"""The port's parity harness (marl_sortingenv_tpu_torch/eval/harness.py)
on the CPU: the Random and Rule-Based means of ``run_model_benchmark`` at
10 seeds x 200 steps, masked, equal (``==``) to the reference's own
numbers (``artifacts/benchmark_results.json``, the ``parity`` row of
``artifacts/engine_drift.json``); ``run_episode`` in its modes against
the JAX package's, the dashboard series included; ``compare_engine_drift``
and the refusal of ``render``."""
import numpy as np
import pytest
import torch

from marl_sortingenv_tpu.config.config import load_config as jload
from marl_sortingenv_tpu.eval import harness as jharness
from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.core import state as S
from marl_sortingenv_tpu_torch.eval import harness
from test_torch_fastb_model import agent, jax_agent

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

# the reference's parity-engine benchmark, masked, 10 seeds x 200 steps
REF_RANDOM = -86.84669390179657
REF_RULE = 44.17809308063072


def test_reference_means_10_seeds_200_steps():
    summary, rows = harness.run_model_benchmark(
        load_config(), 10, 200, device="cpu")
    assert summary["Random"]["mean"] == REF_RANDOM
    assert summary["Rule-Based"]["mean"] == REF_RULE
    assert [r["seed"] for r in rows] == list(range(1, 11))


@pytest.mark.parametrize("mode", ["rule_based", "random", "model"])
def test_run_episode_matches_jax(mode):
    import jax

    kw = dict(steps=30, mode=mode, use_action_masking=mode != "model",
              collect_series=True)
    sp = dict(sort_params=jax_agent("sort")[1]) if mode == "model" else {}
    tp = dict(sort_params=agent("sort")) if mode == "model" else {}
    want = jharness.run_episode(jload(), 7, **kw, **sp)
    got = harness.run_episode(load_config(), 7, device="cpu", **kw, **tp)
    assert got.cumulative_reward == want.cumulative_reward
    for f in ("action_sequence", "rewards", "reward_pairs", "purities"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for a, b in zip(S.to_numpy(got.final_state),
                    jax.tree.leaves(want.final_state)):
        assert np.array_equal(a[0], np.asarray(b))
    if mode == "random":
        assert got.series is None and want.series is None
    else:
        assert list(got.series) == list(want.series)
        for k in want.series:
            assert np.array_equal(got.series[k], want.series[k]), k


def test_drift_table_and_render_refusal():
    cfg = load_config(max_steps=10)
    table = harness.compare_engine_drift(cfg, num_seeds=2, steps=4,
                                         device="cpu")
    assert list(table) == ["parity", "fast", "fastb"]
    assert list(table["parity"]) == ["Random", "Rule-Based",
                                     "PPO Sort-Only", "PPO Modular"]
    row = harness.benchmark_seed_all(cfg, 2, 4, device="cpu")
    assert row["seed"] == 2 and "PPO Monolith" not in row
    with pytest.raises(NotImplementedError, match="item 6"):
        harness.run_episode(cfg, 1, 3, render=True, device="cpu")
