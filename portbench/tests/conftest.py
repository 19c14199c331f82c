"""Shared helpers of the harness's own tests: a copy of the benchmark in a
temporary directory with its mixes cut to a size the CPU runs in
seconds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

TINY = {"train_mono": {"n_envs": 16, "n_steps": 8, "batch_size": 32,
                       "shuffle_block": 4},
        "eval_5policy": {"episodes": 8, "steps": 12, "slice_steps": 2,
                         "check_episodes": 4, "check_steps": 5},
        "gym_mono": {"slice_steps": 4}}


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_root(tmp: Path) -> Path:
    """The benchmark (``BENCHMARK.json`` and ``portbench/``) copied under
    ``tmp``, every mix at the sizes of ``TINY``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp)
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for mix, over in TINY.items():
        f = tmp / "portbench" / "traffic" / f"{mix}.json"
        f.write_text(json.dumps({**json.loads(f.read_text()), **over}))
    return tmp


@pytest.fixture
def make_tiny():
    """``make_tiny(tmp)``: the benchmark copied under ``tmp`` at the sizes
    of ``TINY``."""
    return tiny_root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory) -> Path:
    return tiny_root(tmp_path_factory.mktemp("bench"))


def _run_cpu(root: Path, workload: str, seed: int = 2**33 + 7,
             seconds: float = 0.3, trace: bool = False) -> dict:
    import time

    from portbench.lib import cell
    return cell.run(root, workload, seed, seconds, trace,
                    time.perf_counter(), device="cpu")


@pytest.fixture
def run_cpu():
    """``run_cpu(root, workload, seed=, seconds=, trace=)``: one run on the
    CPU, the look for a card skipped; returns the result line's object."""
    return _run_cpu
