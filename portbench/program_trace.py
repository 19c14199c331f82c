"""The program's own spans over each cell's traced slice, on the card.

    python3 portbench/program_trace.py --seed <n> [--repeats 8] \
        [--out <file.json>]

For each cell, at its own size and after its own set-up, the slice that a
``--trace 1`` run profiles runs under ``profiling.trace()`` of the
program (``marl_sortingenv_tpu_torch.utils.profiling``), and the tool
reports:

* ``spans``: the program's span summary (count, mean and self us);
* ``idle_s``: the slice's device-idle seconds by innermost open program
  span, ``window_s`` and the share of the idle time inside some span;
* ``cover``: the share of ``learner.rollout`` that ``rollout.policy`` and
  ``rollout.env`` cover, and of ``learner.update`` that ``update.loss``,
  ``update.backward`` and ``update.optim`` cover (train cells);
* ``launches``: the host launch calls of kernel 1 in the Chrome trace, and
  how many lie inside a ``step_mono.launch`` span;
* ``cost``: the slice's time under the profiler with the spans and with
  ``span`` forced to the no-op, and without the profiler (``plain_s``),
  ``--repeats`` of each in turns; the median and quartiles of the
  difference that the spans make, repeat by repeat; the device's events
  both ways;
* ``span_ns``: what a span costs per call with no profiler running (off)
  and under one (on).

It prints one JSON line per cell and writes them all to ``--out``.  The
benchmark's own runs never run this.
"""

import contextlib
import json
import statistics
import sys
import tempfile
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CELLS = ("train_mono.plant_paper", "eval_5policy.plant_noise05",
         "gym_mono.plant_paper")


def _total_us(summary: dict, *names) -> float:
    return sum(summary[n]["count"] * summary[n]["mean_us"]
               for n in names if n in summary)


def _launches_inside(path: str) -> dict:
    """Kernel 1's host launch calls (the runtime or driver call whose
    correlation is a ``step_mono`` kernel's) and how many lie inside a
    ``step_mono.launch`` span, on the Chrome trace's own clock."""
    ev = json.loads(Path(path).read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                   if e.get("cat") == "program_span"
                   and e["name"] == "step_mono.launch")
    kernels = {e["args"].get("correlation") for e in ev
               if e.get("cat") == "kernel" and "step_mono" in e["name"]}
    calls = [e for e in ev if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and e.get("args", {}).get("correlation") in kernels]
    inside = sum(any(s <= e["ts"] and e["ts"] + e["dur"] <= t
                     for s, t in spans) for e in calls)
    return {"kernels": len(kernels), "calls": len(calls), "inside": inside,
            "spans": len(spans)}


def _device_events(prof) -> int:
    import torch
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA)


def _timed_slice(drv, mode: str) -> tuple:
    """The slice, synchronised: (seconds, device events).  ``mode`` "on":
    under the profiler with the program's spans; "off": under it with
    ``span`` forced to the no-op; "plain": without the profiler."""
    import torch

    from marl_sortingenv_tpu_torch.utils import profiling as P
    saved = P.span
    if mode == "off":
        P.span = lambda name, **attrs: P._NO_SPAN
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with (torch.profiler.profile(activities=acts) if mode != "plain"
              else contextlib.nullcontext()) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drv.traced_slice()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        P.span = saved
    return secs, None if prof is None else _device_events(prof)


def span_cost_ns(n_off: int = 200000, n_on: int = 20000) -> dict:
    """ns per ``with span(...)`` and per call of a ``spanned`` function
    (the bare function's call included), with no profiler running and
    under one (CPU activity), best of 5."""
    import torch
    setup = ("from marl_sortingenv_tpu_torch.utils import profiling as P\n"
             "f = lambda: None\n"
             "g = P.spanned('g', body='x')(f)\n")
    stmts = (("span", "with P.span('a'): pass"),
             ("span_attrs", "with P.span('a', body='x'): pass"),
             ("bare_call", "f()"), ("spanned_call", "g()"))
    out = {}
    for mode in ("off", "on"):
        with (torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU])
              if mode == "on" else contextlib.nullcontext()):
            for key, stmt in stmts:
                n = n_on if mode == "on" else n_off
                out[f"{mode}.{key}"] = min(timeit.repeat(
                    stmt, setup, number=n, repeat=5)) / n * 1e9
    return out


def measure(workload: str, seed: int, repeats: int, log_dir: str) -> dict:
    import torch

    from marl_sortingenv_tpu_torch.utils import profiling as P
    from portbench.lib import bench
    from portbench.lib.cell import Context
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    cell = bench.load_cell(ROOT, workload)
    drv = bench.driver_module(cell).Driver(
        Context(cell=cell, seed=seed, device="cuda", trace=True))
    drv.setup()
    drv.traced_slice()
    torch.cuda.synchronize()
    with P.trace(log_dir) as tr:
        drv.traced_slice()
    s = P.summary()
    idle = sum(tr.idle_s.values())
    res = {"workload": workload, "seed": seed,
           "device": torch.cuda.get_device_name(0),
           "window_s": tr.window_s, "idle_s": tr.idle_s,
           "idle_share": idle / tr.window_s,
           "idle_in_spans": 1.0 - tr.idle_s.get(P.OUTSIDE, 0.0) / idle,
           "spans": s}
    if "learner.rollout" in s:
        res["cover"] = {
            "rollout": _total_us(s, "rollout.policy", "rollout.env")
            / _total_us(s, "learner.rollout"),
            "update": _total_us(s, "update.loss", "update.backward",
                                "update.optim")
            / _total_us(s, "learner.update")}
    if "step_mono.launch" in s:
        res["launches"] = _launches_inside(tr.path)
    Path(tr.path).unlink()
    modes = ("on", "off", "plain")
    runs = {m: [] for m in modes}
    for i in range(repeats):
        for mode in modes[i % 3:] + modes[:i % 3]:
            runs[mode].append(_timed_slice(drv, mode))
    cost = {}
    for mode, xs in runs.items():
        cost[f"{mode}_s"] = [x[0] for x in xs]
        cost[f"{mode}_median_s"] = statistics.median(x[0] for x in xs)
    cost["device_events_on"] = [x[1] for x in runs["on"]]
    cost["device_events_off"] = [x[1] for x in runs["off"]]
    added = [a[0] - b[0] for a, b in zip(runs["on"], runs["off"])]
    cost["added_s"] = statistics.median(added)
    cost["added_quartiles_s"] = statistics.quantiles(added, n=4)
    res["cost"] = cost
    drv.release()
    return res


def main(argv) -> int:
    import argparse
    import subprocess
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--repeats", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("program_trace: no CUDA device; this runs on the card only")
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
    lines = [{"power": power, "span_ns": span_cost_ns()}]
    print(json.dumps(lines[0]), flush=True)
    with tempfile.TemporaryDirectory() as log_dir:
        for w in CELLS:
            lines.append(measure(w, args.seed, args.repeats, log_dir))
            print(json.dumps(lines[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
