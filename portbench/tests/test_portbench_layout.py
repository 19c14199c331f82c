"""The benchmark's layout: what it may import, what it finds by name, and
how it refuses to run without a card or without the program."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
JAX_NAMES = {"jax", "jaxlib", "flax", "marl_sortingenv_tpu"}
PROGRAM = "marl_sortingenv_tpu_torch"


def _imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_imports_jax():
    for f in PB.rglob("*.py"):
        assert not (_imported_tops(f) & JAX_NAMES), f


def test_reference_imports_nothing_of_the_program():
    for f in (PB / "reference").rglob("*.py"):
        assert PROGRAM not in _imported_tops(f), f
        assert not (_imported_tops(f) & JAX_NAMES), f


def test_names_are_compared_whole():
    from portbench.lib import cell
    assert PROGRAM not in cell.FORBIDDEN
    assert "marl_sortingenv_tpu" in cell.FORBIDDEN
    assert not (set(cell.forbidden_modules()) - JAX_NAMES)


def test_run_loads_no_jax(tiny, run_cpu):
    """A run, traced, leaves nothing of JAX or of the JAX package in
    ``sys.modules`` (in a process of its own)."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from portbench.lib import cell\n"
        "cell.run(__import__('pathlib').Path(%r), 'gym_mono.plant_paper', 3,"
        " 0.2, True, time.perf_counter(), device='cpu')\n"
        "print(cell.forbidden_modules())\n" % (str(ROOT), str(tiny)))
    env = dict(os.environ)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_benchmark_names_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        mix = json.loads((PB / "traffic" / f"{w['traffic']}.json").read_text())
        assert (PB / "traffic" / f"{mix['driver']}.py").is_file()
    for m in bench["per_layer"]:
        assert (PB / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_a_new_cell_mix_and_metric_need_only_new_files(tmp_path, run_cpu,
                                                       make_tiny):
    """A dummy configuration, mix and metric, added as files beside the
    benchmark's own, run with no edit to any file there but the entries
    of ``BENCHMARK.json``."""
    root = make_tiny(tmp_path)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "plant_paper.json").read_text())
    cfg["sim"]["max_steps"] = 50
    (pb / "configs" / "plant_short.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "gym_mono.json").read_text())
    (pb / "traffic" / "gym_mono_short.json").write_text(json.dumps(mix))
    (pb / "metrics" / "gym.steps_in_window.py").write_text(
        "def read(r):\n    return float(r.window['steps'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "plant_short", "source": "x",
                             "file": "portbench/configs/plant_short.json",
                             "reduced": ["max_steps"], "why": "a test"})
    bench["workloads"].append({"name": "gym_short.plant_short",
                               "config": "plant_short",
                               "traffic": "gym_mono_short", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if "gym_mono.plant_paper" in m.get("workloads", ()):
            m["workloads"].append("gym_short.plant_short")
    for m in bench["per_layer"]:
        if "gym_mono.plant_paper" in m.get("workloads", ()):
            m["workloads"].append("gym_short.plant_short")
    bench["per_layer"].append({
        "name": "gym.steps_in_window", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "env API",
        "moves": "gym_step_ms.p95", "workloads": ["gym_short.plant_short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run_cpu(root, "gym_short.plant_short")
    assert res["correct"] and "gym_step_ms.p95" in res["metrics"]
    traced = run_cpu(root, "gym_short.plant_short", trace=True)
    assert traced["metrics"]["gym.steps_in_window"]["value"] > 0


def _run_py(cwd: Path, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "gym_mono.plant_paper", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_no_card_no_result():
    """Without a CUDA device the run exits non-zero and prints nothing on
    standard output (this sandbox has none; on the card hide it)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run_py(ROOT, env)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_does_not_run(tmp_path):
    """A directory with only ``BENCHMARK.json`` and ``portbench/`` (no
    program) exits non-zero with no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = _run_py(tmp_path, env)
    assert out.returncode != 0 and out.stdout == ""
