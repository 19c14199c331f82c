"""The port's CLI (``main.py``) on the CPU, as tests/test_cli_and_plots.py
holds the JAX package's: ``run_sim`` with ``--train-without-masking`` at
the flow's tiny sizes (8 envs, 512 timesteps, 1 bench seed x 30 steps;
the unmasked flow once), which writes the models, the benchmark figure
and ``summary.json``; and ``--help``, ``create_environment`` and the
``--device`` flag.  ``run_sim --env-analysis`` is in test_torch_host.py
(it draws the dashboards).
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

from marl_sortingenv_tpu_torch import envs as E
from marl_sortingenv_tpu_torch import main as M

# one thread: these tensors are tiny, and the suite's workers share the CPU
torch.set_num_threads(1)


def args(tmp_path, *flags):
    """``run_sim``'s arguments at the tests' tiny sizes, on the CPU."""
    return M.build_parser().parse_args([
        *flags, "--steps", "30", "--seed", "42", "--device", "cpu",
        "--fig-dir", str(tmp_path), "--log-dir", str(tmp_path / "log"),
        "--models-dir", str(tmp_path / "models"), "--tag", "t"])


def test_cli_tiny_training_flow_unmasked(tmp_path):
    out = M.run_sim(args(tmp_path, "--train-without-masking",
                          "--timesteps", "512", "--n-envs", "8",
                          "--bench-seeds", "1"))
    bench = out["t_NoMask"]
    assert set(bench) == {"Random", "Rule-Based", "PPO Sort-Only",
                          "PPO Modular", "PPO Monolith"}
    assert all(np.isfinite(v["mean"]) for v in bench.values())
    assert sorted(os.listdir(tmp_path / "models")) == [
        f"PPO_{p}_NoMask_512.npz" for p in ("Monolith", "Pressing",
                                            "Sorting")]
    (bdir,) = os.listdir(tmp_path / "benchmarks")
    assert bdir == "1_benchmark_t_NoMask"
    files = os.listdir(tmp_path / "benchmarks" / bdir)
    assert {"summary.json", "Model_Benchmark_NoMask.png"} <= set(files)
    with open(tmp_path / "benchmarks" / bdir / "summary.json") as f:
        assert json.load(f) == bench
    assert os.path.exists(tmp_path / "log" / "t_NoMask" / "metrics.jsonl")


def test_cli_help_device_and_create_environment():
    done = subprocess.run(
        [sys.executable, "-m", "marl_sortingenv_tpu_torch.main", "--help"],
        capture_output=True, text=True, timeout=120,
        cwd=os.path.join(os.path.dirname(__file__), ".."))
    assert done.returncode == 0 and "--device" in done.stdout
    assert M.build_parser().parse_args([]).device == "cuda"
    for name, cls in (("Sorting", E.Env_1_Sorting),
                      ("Pressing", E.Env_2_Pressing),
                      ("Monolith", E.Env_3_Monolith)):
        env = M.create_environment(name, max_steps=30, device="cpu")
        assert type(env) is cls and env.config.noise_sorting == 0.0
        assert env.device.type == "cpu"
