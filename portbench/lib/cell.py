"""One run of one cell: set-up, the timed window, the traced slice with
``--trace 1``, the check that decides ``correct``, and the result line.

A traffic driver (``portbench/traffic/<driver>.py``) defines ``Driver``,
built from a ``Context``, with:

* ``setup()``: builds the program's objects from the seed, drives them
  through their first steps and warms every shape the window uses;
* ``window(seconds) -> Window``: the timed path, for at least ``seconds``;
* ``traced_slice()``: a bounded stretch of the timed path, profiled;
  ``launches`` and ``slice_steps`` say what it ran;
* ``release()``: frees the program's state;
* ``check() -> list[Check]``: the plain reference against what the timed
  path produced.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "marl_sortingenv_tpu")


@dataclasses.dataclass
class Check:
    """One number compared, with its limit: the run is correct where
    ``value <= limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Window:
    """What the timed window did: its end-to-end metrics, the work it
    attempted and failed, and what the per-layer readers need of it."""
    metrics: dict
    attempted: int
    failed: int
    facts: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Context:
    cell: object              # bench.Cell
    seed: int
    device: str
    trace: bool

    def sub_seeds(self, k: int) -> list:
        """``k`` seeds below 2**31 drawn from the run's seed: the same seed
        gives the same inputs."""
        ss = np.random.SeedSequence(self.seed)
        return [int(x) % 2**31 for x in ss.generate_state(k, np.uint32)]

    def agent_path(self, name: str) -> str:
        return str(self.cell.root / self.cell.config["agents"][name])


class Readings:
    """What a per-layer reader reads: the cell, the window's facts, the
    spans, the slice and what it launched, and the frozen work counts."""

    def __init__(self, cell, window, spans, slc, launches, slice_steps):
        from portbench.work import counts
        self.cell, self.window, self.spans = cell, window, spans
        self.slice, self.launches = slc, launches
        self.slice_steps = slice_steps
        self.params = cell.traffic
        self.sim = cell.config["sim"]
        self.work = counts


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def require_cards(n: int) -> None:
    """Exit non-zero, with no result, unless ``n`` CUDA cards are
    present."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("portbench: no CUDA device (torch.cuda.is_available() is "
                 "False); the benchmark runs on the card only")
    if torch.cuda.device_count() < n:
        sys.exit(f"portbench: the cell needs {n} CUDA devices, found "
                 f"{torch.cuda.device_count()}")


def _power_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def host_loop_ms() -> float:
    """A fixed pure-Python loop, timed in ms: the host's own speed, which
    touches nothing of the program.  Printed beside the phases, so that a
    run's numbers can be read against the speed of the host it ran on."""
    t0 = time.perf_counter()
    s = 0
    for i in range(300000):
        s += i * i % 7
    return 1e3 * (time.perf_counter() - t0)


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda") -> dict:
    """One run; returns the result line's object (``correct`` false where
    a check failed).  ``device`` is "cuda" on the card; the harness's own
    tests pass "cpu" after skipping the look for a card."""
    import torch

    from portbench.lib import bench
    from portbench.lib import trace as T

    cell = bench.load_cell(root, workload)
    if device == "cuda":
        require_cards(cell.chips)
        print(f"portbench: {_power_line()}", file=sys.stderr, flush=True)
    # the configuration's precision: float32 products without TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)

    ctx = Context(cell=cell, seed=seed, device=device, trace=trace)
    driver = bench.driver_module(cell).Driver(ctx)
    driver.setup()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    win = driver.window(seconds)
    phases = {"setup_s": setup_s, "window_s": win.facts["seconds"],
              "host_loop_ms": host_loop_ms()}
    result = {"attempted": win.attempted, "failed": win.failed}
    metrics, breakdown, dev = {}, None, {}
    if trace:
        t0 = time.perf_counter()
        slc = T.profile_slice(driver.traced_slice)
        readings = Readings(cell, win.facts, driver.spans.seconds, slc,
                            driver.launches, driver.slice_steps)
        for m in cell.per_layer:
            value = bench.metric_reader(cell, m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": slc.top_ops(), "idle_gaps":
                     slc.idle_gaps()}
        dev.update(busy_s=slc.busy_s, window_s=slc.window_s)
        phases["trace_s"] = time.perf_counter() - t0
    else:
        values = dict(win.metrics, setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell.chips,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated()),
               **dev}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0, **dev}
    driver.release()
    t0 = time.perf_counter()
    checks = driver.check()
    phases["check_s"] = time.perf_counter() - t0
    print("portbench: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                     phases.items()), file=sys.stderr)
    result.update(correct=all(c.ok for c in checks), metrics=metrics,
                  device=dev)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    result = {"correct": result.pop("correct"), **result}
    return result


def main(argv, t_start: float, root: Path) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        sys.exit("portbench: --seed must be a whole number >= 0")
    try:
        import marl_sortingenv_tpu_torch  # noqa: F401
    except ImportError as exc:
        sys.exit(f"portbench: the program is missing: {exc}")
    res = run(root, args.workload, args.seed, args.seconds,
              bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        sys.exit(f"portbench: the run loaded {', '.join(found)}; nothing "
                 "of JAX or of the JAX package may run here")
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0
