"""The port's orchestration on the CPU: ``learn/trainer.run_training_flow``
at 8 envs, 512 timesteps (one PPO iteration per stage), a closing
benchmark of 1 seed x 30 steps, on ``fastb``, masked: the stages run in
the reference's order with its save prefixes, the press stage trains
against the sort stage's agent, the benchmark gets the three trained
agents as they are, the returned dict has the JAX flow's keys, and the
benchmark's Random and Rule-Based rows (which need no trained agent)
equal the JAX package's for the same seed.  Also ``training.Train_Agent``
and ``RL_Trainer``, the reference's names over ``train_agent``.  The CLI
(``main.run_sim``) is in test_torch_cli.py.
"""
import os

import numpy as np
import pytest
import torch

from marl_sortingenv_tpu.config.config import load_config as jload
from marl_sortingenv_tpu.eval import harness as jharness
from marl_sortingenv_tpu_torch import envs as E
from marl_sortingenv_tpu_torch import training
from marl_sortingenv_tpu_torch.config.config import load_config
from marl_sortingenv_tpu_torch.eval import harness
from marl_sortingenv_tpu_torch.learn import trainer
from marl_sortingenv_tpu_torch.models import mlp

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)

KW = dict(max_steps=30, noise_sorting=0.0, balesize=200)


def test_run_training_flow(tmp_path, monkeypatch):
    stages, benches = [], []
    real_train, real_bench = trainer.train_agent, harness.run_model_benchmark

    def train_spy(cfg, variant, *args, **kw):
        res = real_train(cfg, variant, *args, **kw)
        stages.append((variant, kw, res))
        return res

    def bench_spy(*args, **kw):
        benches.append(kw)
        return real_bench(*args, **kw)
    monkeypatch.setattr(trainer, "train_agent", train_spy)
    monkeypatch.setattr(harness, "run_model_benchmark", bench_spy)
    models = str(tmp_path / "models")
    out = trainer.run_training_flow(
        load_config(**KW), True, total_timesteps=512, n_envs=8, seed=42,
        engine="fastb", bench_seeds=1, steps_test=30, models_dir=models,
        device="cpu")
    assert set(out) == {"sort", "press", "mono", "benchmark",
                        "benchmark_rows"}
    assert [s[0] for s in stages] == ["sort", "press", "mono"]
    for (variant, kw, res), prefix in zip(
            stages, ("Sorting", "Pressing", "Monolith")):
        assert kw["save_prefix"] == f"PPO_{prefix}_Masked"
        assert out[variant] is res and len(res.history) == 1
        assert isinstance(res.params, mlp.ActorCritic)
        assert all(p.device.type == "cpu" for p in res.params.parameters())
        assert np.isfinite(res.final_eval_mean)
    assert stages[1][1]["sort_params"] is out["sort"].params
    assert "sort_params" not in stages[0][1] and \
        "sort_params" not in stages[2][1]
    assert sorted(os.listdir(models)) == [
        f"PPO_{p}_Masked_512.npz" for p in ("Monolith", "Pressing",
                                            "Sorting")]
    (bench,) = benches
    assert bench["sort_params"] is out["sort"].params
    assert bench["press_params"] is out["press"].params
    assert bench["mono_params"] is out["mono"].params
    assert set(out["benchmark"]) == set(harness.POLICY_KEYS)
    (row,) = out["benchmark_rows"]
    cfg_j = jload(**KW)
    for key, mode in (("Random", "random"), ("Rule-Based", "rule_based")):
        want = jharness.run_episode(cfg_j, 1, 30, mode).cumulative_reward
        assert row[key] == want == out["benchmark"][key]["mean"], key
        assert out["benchmark"][key]["std"] == 0.0


def test_train_agent_shims(monkeypatch):
    calls = []

    def fake(cfg, variant, total, **kw):
        calls.append((cfg, variant, total, kw))
        return trainer.TrainResult(f"params of {variant}", 0.0, 0.0, [])
    monkeypatch.setattr(trainer, "train_agent", fake)
    sort_agent = mlp.ActorCritic(13, 2, device="cpu")
    env = E.Env_2_Pressing(max_steps=30, seed=1, device="cpu")
    env.set_agents(sort_agent=sort_agent)
    assert training.Train_Agent("PPO", env, 512, False, n_envs=8,
                                device="cpu") == "params of press"
    cfg, variant, total, kw = calls[0]
    assert cfg is env.config and (variant, total) == ("press", 512)
    assert kw["sort_params"] is env.sort_agent
    assert kw["save_prefix"] == "PPO_press" and kw["n_envs"] == 8
    assert kw["use_action_masking"] is False and kw["device"] == "cpu"
    for bad in (("DQN", env), ("PPO", None)):
        with pytest.raises(ValueError):
            training.Train_Agent(*bad, 512, True, device="cpu")

    sort_env = E.Env_1_Sorting(max_steps=30, seed=1, device="cpu")
    trained = training.RL_Trainer(sort_env, "Sorting", ["A2C", "DQN", "PPO"],
                                  30, 512, 0.0, "t", 1, True, device="cpu")
    assert trained == {"PPO": "params of sort"}
    assert len(calls) == 2 and calls[1][3]["save_prefix"] == "PPO_Sorting"
    assert callable(training.save_model) and callable(
        training.find_latest_model)
