"""The data-parallel training cell: its layout in the benchmark, and its
driver (``traffic/train_dp.py``) at two gloo ranks on the CPU: a sound run
is correct, a fault planted in the rank the check does not read is
caught, and a rank that dies ends the run within seconds."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
CELL = "train_mono_dp4.plant_paper"
METRICS = ("dp.all_gather_us.train_dp4", "dp.gather_share.train_dp4",
           "dp.all_gather_roofline.train_dp4")
TINY_DP = {"world": 2, "backend": "gloo", "n_envs": 32, "n_steps": 8,
           "batch_size": 64, "n_epochs": 2, "shuffle_block": 4}


@pytest.fixture
def tiny_dp(tmp_path, make_tiny):
    root = make_tiny(tmp_path)
    f = root / "portbench" / "traffic" / "train_mono_dp4.json"
    f.write_text(json.dumps({**json.loads(f.read_text()), **TINY_DP}))
    return root


def test_layout():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    assert cell["chips"] == 4 and cell["traffic"] == "train_mono_dp4"
    (cfg,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
    config = json.loads((ROOT / cfg["file"]).read_text())
    mix = json.loads((PB / "traffic" / "train_mono_dp4.json").read_text())
    base = json.loads((PB / "traffic" / "train_mono.json").read_text())
    assert mix["driver"] == "train_dp"
    assert (config["deployment"]["ranks"], config["deployment"]["backend"]) \
        == (mix["world"], mix["backend"]) == (4, "nccl")
    # weak scaling against train_mono: its width and minibatch per rank
    assert mix["n_envs"] == 4 * base["n_envs"]
    assert mix["batch_size"] == 4 * base["batch_size"]
    assert mix["limits"] == base["limits"]
    plant = json.loads((PB / "configs" / "plant_paper.json").read_text())
    for key in ("sim", "policy", "agents", "precision"):
        assert config[key] == plant[key], key
    (e2e,) = [m for m in bench["end_to_end"]
              if m["name"] == "train_samples_per_s"]
    assert e2e["workloads"][-1] == CELL
    for name in METRICS:
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["workloads"] == [CELL] and m["layer"] == "collectives"
        assert (PB / "metrics" / f"{name}.py").is_file()


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_is_correct(tiny_dp, run_cpu, trace):
    res = run_cpu(tiny_dp, CELL, trace=bool(trace))
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values()), \
        res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    if trace:
        got = res["metrics"]
        assert got["dp.all_gather_us.train_dp4"]["value"] > 0
        assert 0 < got["dp.gather_share.train_dp4"]["value"] < 100
        # no NCCL kernel on the CPU: the roofline has nothing to read
        assert "dp.all_gather_roofline.train_dp4" not in got
    else:
        assert set(res["metrics"]) == {"train_samples_per_s", "setup_s"}


def _driver(root, seed=2**33 + 7):
    from portbench.lib import bench
    from portbench.lib.cell import Context
    from portbench.traffic import train_dp
    return train_dp.Driver(Context(bench.load_cell(root, CELL), seed, "cpu",
                                   False))


def test_fault_in_one_rank_is_caught(tiny_dp):
    """Rank 1's rewards are off by one at one rollout step: rank 0's
    record, which the check reads, moves with them."""
    from portbench.control_dp import FAULTS
    drv = _driver(tiny_dp)
    drv.plant = FAULTS["one_rank_altered"]
    drv.setup()
    drv.release()
    checks = drv.check()
    assert not all(c.ok for c in checks), checks


def test_dead_rank_ends_the_run(tiny_dp):
    """Rank 1 killed after set-up: rank 0, in its window, exits non-zero
    within seconds (in a process of its own, as the harness's run)."""
    code = (
        "import os, signal, sys, time; sys.path.insert(0, %r)\n"
        "from portbench.tests.test_portbench_dp import _driver\n"
        "drv = _driver(__import__('pathlib').Path(%r))\n"
        "drv.setup()\n"
        "os.kill(drv.workers[0].pid, signal.SIGKILL)\n"
        "print('killed', time.monotonic(), flush=True)\n"
        "drv.window(120.0)\n" % (str(ROOT), str(tiny_dp)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=180)
    ended = time.monotonic()
    assert out.returncode != 0, out.stderr[-3000:]
    killed = float(out.stdout.split("killed")[1].split()[0])
    assert ended - killed < 30, out.stderr[-3000:]
