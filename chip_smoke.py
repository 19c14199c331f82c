"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as the check runs it
    python3 chip_smoke.py --sweep    # build + the design sweep alone

Builds the port's CUDA kernels from ``marl_sortingenv_tpu_torch/csrc``,
holds each kernel bitwise against its plain PyTorch version on the card
(and shows that the plain versions launch no kernel), holds the CUDA path
bitwise against the CPU path, and drives the port's main paths and times
them: policy evaluation and the fused-policy autoreset rollout at 4096 and
65536 envs; PPO training of the mono agent and of the press agent with the
frozen tuned sort agent at the JAX benchmark's width (4096 envs, 64 steps,
minibatches of 16384, 4 epochs, shuffle blocks of 128); and the flow,
``run_training_flow`` at the CLI's defaults (16 envs; sort -> press ->
mono, two PPO iterations each, then the parity 5-policy benchmark at 10
seeds x 200 steps, whose Random and Rule-Based rows must equal the
reference's); kernels 1 and 2 are held against their plain versions at the
flow's widths (16 and 10 envs) as well as at 4096.  The sort kernels are timed alone beside their
bounds, and every design of the three kernels (a group of lanes per env,
``sort_cuda.DESIGNS`` and ``mvhg_cuda.REDISTRIBUTE_DESIGNS``) is held
bitwise against its plain version and timed at 4096 and 65536 envs
(``--sweep`` runs that phase alone, also at 8192 to 32768 envs) at
supports 16, 32, 40 and 88, and kernel 3 also at 128.  Then the paths that run the eager step with its
sorting core on kernel 2, at 4096 envs x 200 autoreset steps: full-bale
mode in every variant (also against events mode through kernel 1 and
``events_to_full``) and the model and random steps of the engine
benchmark, each held bitwise to its plain version on the card and to the
CPU path (run in worker processes meanwhile; a categorical draw may split
only at a near-tie); the ``fast`` engine against ``fastb`` and a PPO
iteration on it; and ``eval/harness.run_engine_benchmark`` on both
engines against the JAX package's means, then timed per policy at 4096
episodes.  Last, phase 16 drives the bit-exact parity engine (no kernel
of its own, and it launches none of the three): every step variant at 64
envs x 210 autoreset steps on the default and noise-0.05 configs, the
card's run bitwise against the CPU's (worker processes; an agent's argmax
may split only at a near-tie), the parity 5-policy benchmark at 10 seeds x
200 steps against the JAX package's per-seed table and the reference's
means, and three timed PPO iterations of mono on the parity engine at
4096 envs; the benchmark and the PPO iterations are timed once the
workers have ended.  Phase 17 runs the Gymnasium drop-in envs
(``envs.py``, on the parity engine) in every class and action source for
210 steps at max_steps 200, the card's Gym loop against the CPU's in
worker processes (every obs, reward, terminated, info, mask, log,
accessor and checksum line equal), times one loop per class, and runs
``check_env`` and ``testing.test_env`` on the card.  The card's machine
has no matplotlib (``CARD_PACKAGES``): what draws figures is held on the
CPU only.  Phase 18 runs the integer-exact engine (no kernel; integer
arithmetic only) in every scenario of ``eval/exact_scenarios`` on the card
and on the CPU in worker processes, bit for bit against each other and
against the JAX package's golden files (``artifacts/exact_cpu_*.npz``)
and the TPU's (the f32 agents' actions on it up to counted near-ties),
and times the exact step alone.  Phase 19 runs five sharded PPO
iterations on ``fastb`` at 4096 global envs over 1 rank (NCCL) and 2
ranks on the one card (gloo) through
``python -m marl_sortingenv_tpu_torch.parallel.dryrun``, each rank's
kernel-1 steps held to their plain version on its shard at both ends of
each rollout but the timed last, the parameters and losses bitwise those
of the unsharded iterations, and a sharded frozen-sort press rollout
whose per-rank kernel-2 launches are held to their plain version
(``--exact-sharded`` runs phases 18 and 19 alone).  The second-to-last
line of standard output is a JSON
``kernels`` record; the last line is ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero without those lines.  Without CUDA,
or without the port next to this file, it exits non-zero at once.  Details
go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SORT_NPZ = ROOT / "artifacts" / "models_tuned" / "PPO_Sorting_Tuned_100000.npz"
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_PER_S = 67e12          # f32 outside the tensor cores
# 32-bit integer lanes: 64 per SM (half the f32 lanes, no fused pair),
# 132 SMs at 1.98 GHz, from the same data sheet's SM layout
H100_INT32_PER_S = 132 * 64 * 1.98e9

# The operations the bound counts, by kind:
#   threefry2x32 block: 20 rounds of add, rotate, xor plus 5 key injections
#   of 2 adds (the rotate counted as one funnel shift) = 70 int ops;
#   one hypergeometric draw at support S: per lane 4 subtractions, 3 adds,
#   2 multiplies, 1 division (counted as 10 ops, the IEEE sequence), then
#   log2(S) doubling steps of products and of sums over S lanes, and S
#   compares.
# The rest of the step (rules, press phase, rewards, obs) is left out, so
# the operation times are lower bounds.
TF_BLOCK_OPS = 70


def hg_draw_f32_ops(support: int) -> int:
    steps = max(1, (support - 1).bit_length())
    return support * 19 + 2 * support * steps + support


def step_ops(cfg, variant: str, support: int, n: int, n_reset: int):
    """(int ops, f32 ops) of one step of ``variant`` over n envs, of which
    n_reset restart in the fused autoreset (3 more threefry blocks each)."""
    blocks = 2 + 1 + 4                  # input split, randint split, 4 words
    blocks += 2 + (4 if cfg.effective_noise > 0 else 0)    # accuracy
    blocks += 4 * (2 + 3 + 3)           # per station: split2, split3, 3 words
    blocks += 3 if variant == "sort" else 0
    return ((blocks * n + 3 * n_reset) * TF_BLOCK_OPS,
            12 * hg_draw_f32_ops(support) * n)


def sort_ops(support: int, n: int):
    """(int ops, f32 ops) of the sorting core over n envs: per station
    split2, split3 and 3 words (8 threefry blocks), and 12 sampler draws."""
    return 4 * 8 * TF_BLOCK_OPS * n, 12 * hg_draw_f32_ops(support) * n


def bound(n_bytes: int, int_ops: int, f32_ops: int) -> dict:
    """The least time the card could take: bytes, integer and f32 work run
    on separate units at once, so the bound is the largest of the three."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = max(int_ops / H100_INT32_PER_S, f32_ops / H100_F32_PER_S) * 1e3
    return {"bytes": n_bytes, "int_ops": int_ops, "f32_ops": f32_ops,
            "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def launch_counts() -> dict:
    from marl_sortingenv_tpu_torch.ops import mvhg_cuda, sort_cuda, step_cuda
    return {"step_mono": step_cuda.LAUNCHES,
            "sort_material": sort_cuda.LAUNCHES,
            "sort_redistribute": mvhg_cuda.LAUNCHES}


def zero_counts() -> None:
    restore_counts({"step_mono": 0, "sort_material": 0,
                    "sort_redistribute": 0})


def restore_counts(counts: dict) -> None:
    from marl_sortingenv_tpu_torch.ops import mvhg_cuda, sort_cuda, step_cuda
    step_cuda.LAUNCHES = counts["step_mono"]
    sort_cuda.LAUNCHES = counts["sort_material"]
    mvhg_cuda.LAUNCHES = counts["sort_redistribute"]


def add_launches(totals: dict, by_path: dict, path: str,
                 counts: dict) -> None:
    """Add one main path's kernel launches to the totals and to the path's
    own row of ``by_path``."""
    row = by_path.setdefault(path, dict.fromkeys(totals, 0))
    for k in totals:
        row[k] += counts.get(k, 0)
        totals[k] += counts.get(k, 0)


def no_launch(fn, *args, **kw):
    """``fn(*args, **kw)`` (a plain version), failing if it launched any
    of the port's kernels."""
    before = launch_counts()
    out = fn(*args, **kw)
    if launch_counts() != before:
        raise AssertionError(f"{getattr(fn, '__name__', fn)} launched a "
                             f"kernel: {before} -> {launch_counts()}")
    return out


def profile_device_us(fn, reps: int, kernel: str, tries: int = 3) -> float:
    """Profiler device time per launch (us) of the kernel whose name holds
    ``kernel`` over ``reps`` calls of fn().  A trace that lost the
    kernel's events (seen once in some hundred traces on the card) is
    taken again, up to ``tries`` traces in all."""
    for _ in range(tries):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev_us = [e.device_time_total / e.count
                  for e in prof.key_averages() if kernel in e.key
                  and e.device_type == torch.autograd.DeviceType.CUDA]
        if dev_us:
            return dev_us[0]
    raise AssertionError(f"the profiler saw no {kernel} in {tries} traces")


def profiled_launches(fn, kernel: str, tries: int = 3) -> int:
    """How many times the device ran the kernel whose name holds ``kernel``
    in one call of fn(), as the profiler saw it (a trace that lost the
    kernel's events is taken again, as in ``profile_device_us``)."""
    for _ in range(tries):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        seen = sum(e.count for e in prof.key_averages() if kernel in e.key
                   and e.device_type == torch.autograd.DeviceType.CUDA)
        if seen:
            return seen
    return 0


def profile_busy(fn):
    """(fn's result, wall us, device busy share, device us by kernel, the
    number of kernels the device ran) of one call of fn() under the
    profiler."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        p0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - p0) * 1e6
    # device-side events only: a CPU op's entry repeats the device time of
    # the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    kernels = sorted(((e.key, e.self_device_time_total) for e in events),
                     key=lambda kv: -kv[1])
    busy_us = sum(t for _, t in kernels)
    return (out, wall_us, busy_us / wall_us, kernels,
            sum(e.count for e in events))


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def states_equal(a, b, outs=None, tag=""):
    from marl_sortingenv_tpu_torch.core import fastb as TB
    def same(x, y):
        if x.dtype != y.dtype:
            return False
        if x.device != y.device:
            x, y = x.cpu(), y.cpu()
        return torch.equal(x, y)
    for nm, x, y in zip(TB.BState._fields, a, b):
        if x is None:
            assert y is None, nm
            continue
        if not same(x, y):
            raise AssertionError(f"{tag}: state.{nm} differs")
    if outs is not None:
        for nm in TB.BStepOut._fields:
            if not same(getattr(outs[0], nm), getattr(outs[1], nm)):
                raise AssertionError(f"{tag}: out.{nm} differs")


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() over reps calls, CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


SWEEP_WIDTHS = (4096, 8192, 16384, 32768, 65536)   # --sweep
MAIN_SWEEP_WIDTHS = (4096, 65536)                    # the default run


def _ptxas_lookup():
    """(kernel name, design) -> (registers, stack bytes) from the ptxas
    logs of the three libraries."""
    from marl_sortingenv_tpu_torch.ops import _build
    usage = {}
    for src in ("step_mono", "sort_material", "sort_redistribute"):
        usage.update(_build.ptxas_usage(src))

    def ptxas(kname, d):
        tag = f"{len(kname) + 7}{kname}_kernelILi{d[0]}ELi{d[1]}E"
        hits = [v for k, v in usage.items() if tag in k]
        return hits[0] if hits else (None, None)
    return ptxas


def sort_bound(support: int, n: int) -> dict:
    """Kernel 2's bound: counts, acc and keys in, three (4, N) outputs and
    the keys out; the threefry blocks and the sampler's operations."""
    return bound((16 + 16 + 8) * n + (3 * 16 + 8) * n, *sort_ops(support, n))


def redistribute_bound(support: int, n: int) -> dict:
    """Kernel 3's bound: counts, acc and 12 uniforms in, three (N, 4)
    outputs; the sampler's f32 operations (no threefry)."""
    return bound((16 + 16 + 48) * n + 3 * 16 * n, 0, sort_ops(support, n)[1])


def _sweep_designs(rows, kname, designs, n, support, b, run, check, ptxas):
    """Hold each design of one kernel against its plain version (``check``
    raises on a difference), then time it: profiler device us per launch
    over 100 launches, beside the bound and ptxas's registers and stack."""
    for d in designs:
        check(d, run(d))
        fn = lambda d=d: run(d)
        fn()
        us = profile_device_us(fn, 100, f"{kname}_kernel")
        regs, stack = ptxas(kname, d)
        rows.append({"kernel": kname, "lanes": d[0], "cap": d[1],
                     "n_envs": n, "support": support, "device_us": us,
                     "bound_us": b["bound_ms"] * 1e3,
                     "bound_by": b["bound_by"], "registers": regs,
                     "stack_bytes": stack, "bitwise": True})
        print(f"design sweep: {kname} lanes {d[0]} cap {d[1]} at {n} envs, "
              f"support {support}: {us:.3f} us per launch (profiler device "
              f"time), bound {b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}), "
              f"{regs} registers, {stack} bytes stack; == plain, bitwise",
              flush=True)


def _outputs_equal(tag, names, got, want):
    for nm, x, y in zip(names, got, want):
        if not torch.equal(x, y):
            raise AssertionError(f"{tag}: {nm} differs")


def _report_choice(rows, chosen, support):
    for kname, by_n in chosen.items():
        for n, d in by_n.items():
            best = min((r for r in rows if r["kernel"] == kname
                        and r["n_envs"] == n), key=lambda r: r["device_us"])
            print(f"design sweep: {kname} at {n} envs, support {support}: "
                  f"lanes_for picks {d}, the fastest here is "
                  f"({best['lanes']}, {best['cap']}) at "
                  f"{best['device_us']:.3f} us", flush=True)
    return {k: {str(n): list(d) for n, d in v.items()}
            for k, v in chosen.items()}


def design_sweep(cfg, dev, gen, widths=SWEEP_WIDTHS) -> dict:
    """Every design of the three kernels that covers the config's support,
    at the main path's widths (4096 and 65536 envs) and between them, on
    one state per width: each held bitwise against its plain version, then
    timed by the profiler (device us per launch, 100 launches) beside the
    bound and ptxas's registers and stack.  Kernel 3 runs on the state's
    sorting operands with the uniforms the engine draws.  The launches here
    are no main path's: the counts are restored after.  Returns the rows
    and what ``lanes_for`` picks."""
    from marl_sortingenv_tpu_torch.core import fastb as TB
    from marl_sortingenv_tpu_torch.ops import mvhg_cuda, sort_cuda, step_cuda
    saved = launch_counts()
    support = TB._support_for(cfg)
    ptxas = _ptxas_lookup()
    rows = []
    for n in widths:
        st = TB.reset_batch(cfg, 23, n, device=dev)
        for _ in range(30):
            st, _ = step_cuda.step_mono_kernel(cfg, st, None, variant="rule",
                                               autoreset=True)
        a = torch.randint(0, 22, (n,), generator=gen,
                          dtype=torch.int32).to(dev)
        st_p, o_p = no_launch(step_cuda.step_mono_plain, cfg, st, a,
                              variant="external", masked=True, autoreset=True)
        n_reset = int((st.current_step + 1 >= cfg.max_steps).sum())
        b1 = bound(step_bytes(cfg, st, a, st_p, o_p, n),
                   *step_ops(cfg, "external", support, n, n_reset))

        def check1(d, out, n=n):
            states_equal(out[0], st_p, (out[1], o_p),
                         f"design sweep: step_mono {d} at {n} envs")

        designs12 = sort_cuda.DESIGN_SET.designs_for(support)
        _sweep_designs(rows, "step_mono", designs12, n,
                       support, b1, lambda d: step_cuda.step_mono_kernel(
                           cfg, st, a, variant="external", masked=True,
                           autoreset=True, design=d), check1, ptxas)
        counts, acc, keys = st.belt_counts, st.acc_belt, st.key
        p2 = no_launch(sort_cuda.sort_material_plain, counts, acc, keys,
                       support)
        _sweep_designs(
            rows, "sort_material", designs12, n, support,
            sort_bound(support, n), lambda d: sort_cuda.sort_material_kernel(
                counts, acc, keys, support, design=d),
            lambda d, out, n=n: _outputs_equal(
                f"design sweep: sort_material {d} at {n} envs",
                ("leftover", "true", "false", "keys"), out, p2), ptxas)
        us, _ = no_launch(TB._sort_uniforms, keys)
        c3, a3, u3 = (x.T.contiguous() for x in (counts, acc, us))
        sweep_redistribute(rows, c3, a3, u3, support, ptxas)
    restore_counts(saved)
    chosen = {"step_mono": {n: step_cuda.lanes_for(support, n)
                            for n in widths},
              "sort_material": {n: sort_cuda.lanes_for(support, n)
                                for n in widths},
              "sort_redistribute": {n: mvhg_cuda.lanes_for(support, n)
                                    for n in widths}}
    return {"support": support, "rows": rows,
            "lanes_for": _report_choice(rows, chosen, support)}


def sweep_redistribute(rows, c3, a3, u3, support, ptxas) -> None:
    """Every design of kernel 3 that covers ``support`` on these operands,
    bitwise against ``sort_redistribute_plain``, then timed."""
    from marl_sortingenv_tpu_torch.ops import mvhg_cuda
    n = c3.shape[0]
    p3 = no_launch(mvhg_cuda.sort_redistribute_plain, c3, a3, u3, support)
    _sweep_designs(
        rows, "sort_redistribute",
        mvhg_cuda.DESIGN_SET.designs_for(support), n, support,
        redistribute_bound(support, n),
        lambda d: mvhg_cuda.sort_redistribute_kernel(c3, a3, u3, support,
                                                     design=d),
        lambda d, out: _outputs_equal(
            f"design sweep: sort_redistribute {d} at {n} envs",
            ("leftover", "true", "false"), out, p3), ptxas)


def wide_operands(n: int, dev, seed: int = 128):
    """Kernel 3's operands at the JAX kernel's full support (128), made
    with numpy from ``seed``: counts in [0, 160) and accuracies in [0.2, 1),
    so a station's false units (the bound of its draws) reach up to 127."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 160, (n, 4)).astype(np.int32)
    acc = rng.uniform(0.2, 1.0, (n, 4)).astype(np.float32)
    uniforms = rng.random((n, 12)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (counts, acc, uniforms))


def support_128_sweep(dev, widths=SWEEP_WIDTHS) -> dict:
    """Kernel 3 alone at support 128, every design that covers it, on
    operands from ``wide_operands``: bitwise against the plain version,
    then timed; fails unless some draw's upper end reaches past 104."""
    from marl_sortingenv_tpu_torch.ops import mvhg_cuda
    saved = launch_counts()
    ptxas = _ptxas_lookup()
    rows = []
    for n in widths:
        c3, a3, u3 = wide_operands(n, dev)
        _, _, false_arr = no_launch(mvhg_cuda.sort_redistribute_plain, c3,
                                    a3, u3, 128)
        # station 0's first draw takes K = n = its false units, so hi = that
        if int(false_arr[:, 0].max()) <= 104:
            raise AssertionError("support 128 sweep: no draw reaches past "
                                 "104")
        sweep_redistribute(rows, c3, a3, u3, 128, ptxas)
    restore_counts(saved)
    chosen = {"sort_redistribute": {n: mvhg_cuda.lanes_for(128, n)
                                    for n in widths}}
    return {"support": 128, "rows": rows,
            "lanes_for": _report_choice(rows, chosen, 128)}


def step_bytes(cfg, st, a, out_st, out, n: int) -> int:
    """The bytes one step must move: every input leaf and the action read
    once, every state leaf and output written once."""
    from marl_sortingenv_tpu_torch.ops import step_cuda
    n_bytes = sum(x.numel() * x.element_size()
                  for x in (*[getattr(st, nm) for nm in step_cuda.IN_NAMES],
                            a))
    n_bytes += sum(x.numel() * x.element_size() for x in out_st
                   if x is not None)
    n_bytes += sum(out[k].numel() * out[k].element_size()
                   for k in (0, 2, 3, 6))      # obs, terminated, action, purity
    return n_bytes + 2 * 4 * n                 # raw sort arg, press reward


def sweep_configs():
    """The configs of the design sweep: the default (support 16), support
    32 (the cap of the narrow groups), support 40 (baseline accuracy 0.2)
    and support 88 (batches of 250 units at accuracy 0.2), past 64."""
    from marl_sortingenv_tpu_torch.config.config import load_config
    acc = lambda a: (a, a, a, a)
    return {"default": load_config(bale_mode="events"),
            "support_32": load_config(bale_mode="events",
                                      baseline_accuracy=acc(0.5)),
            "support_40": load_config(bale_mode="events",
                                      baseline_accuracy=acc(0.2)),
            "support_88": load_config(bale_mode="events",
                                      input_batch_size=250,
                                      baseline_accuracy=acc(0.2))}


def full_sweep(dev, gen, widths=SWEEP_WIDTHS) -> dict:
    """The design sweep of every config, then kernel 3 at support 128."""
    report = {name: design_sweep(c, dev, gen, widths)
              for name, c in sweep_configs().items()}
    report["redistribute_support_128"] = support_128_sweep(dev, widths)
    return report


def exact_sharded_only(dev) -> int:
    """``--exact-sharded``: build, then phases 18 and 19 alone."""
    from marl_sortingenv_tpu_torch.ops import _build
    print(gpu_line(), flush=True)
    _build.build_all()
    launches = dict.fromkeys(launch_counts(), 0)
    report = {"exact": phase_exact(dev),
              "sharded": phase_sharded(dev, launches, {})}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "exact_sharded.json").write_text(json.dumps(report, indent=1))
    return 0


def sweep_only(dev) -> int:
    """``--sweep``: build, then the design sweep alone (no main path)."""
    from marl_sortingenv_tpu_torch.ops import _build
    print(gpu_line(), flush=True)
    _build.build_all()
    gen = torch.Generator(device="cpu").manual_seed(31)
    report = full_sweep(dev, gen)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "design_sweep.json").write_text(json.dumps(report, indent=1))
    return 0


# ---- the slice's paths: full-bale mode, the model and random steps, the
# ---- fast engine and the engine benchmark -----------------------------------

AGENT_NPZ = {"sort": SORT_NPZ,
             "press": SORT_NPZ.parent / "PPO_Pressing_Tuned_100000.npz",
             "mono": SORT_NPZ.parent / "PPO_Monolith_Tuned_100000.npz"}

# The JAX package's engine benchmark on the CPU (JAX 0.9.0, x64 off):
#   JAX_PLATFORMS=cpu python -c "from marl_sortingenv_tpu.config.config
#   import load_config; from marl_sortingenv_tpu.eval import harness; ..."
#   harness.run_engine_benchmark(load_config(), engine="fastb",
#   num_episodes=10, steps=200, seed0=1, sort_params=..., press_params=...,
#   mono_params=...) with the three agents of artifacts/models_tuned
#   (utils.checkpoint.load_model) and masking on; the means per policy.
BENCH_JAX = {"Random": -79.2068274885416,
             "Rule-Based": 43.701381826400755,
             "PPO Sort-Only": -67.09077723324299,
             "PPO Modular": 53.87255912311375,
             "PPO Monolith": 83.32351635992526}
BENCH_TOL = 1e-3
TIE_ULPS = 4                # a categorical near-tie: top two within 4 ulp
ARGMAX_RTOL = 1e-5          # an agent's argmax near-tie (the policy's rtol)
DIGEST_P = 2**31 - 1


def _bits64(x):
    """Each element's bit pattern (at most 32 bits) as an int64 in
    [0, 2**32)."""
    if x.dtype == torch.float32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & 0xFFFFFFFF


_WEIGHTS = {}


def _digest_weights(i: int, rows: int, dev) -> torch.Tensor:
    key = (i, rows, str(dev))
    if key not in _WEIGHTS:
        g = torch.Generator().manual_seed(1009 * i + rows)
        _WEIGHTS[key] = torch.randint(1, 2**16, (rows, 1), generator=g,
                                      dtype=torch.int64).to(dev)
    return _WEIGHTS[key]


def digest(tensors) -> torch.Tensor:
    """int64[N]: one number per env from batch-last tensors, the same on
    every device for the same bits: each row's bit patterns times a weight
    (fixed random, < 2**16), summed over the rows and reduced mod 2**31 - 1
    per tensor, then combined.  Two envs whose tensors differ anywhere get
    different numbers but with a chance of about 2**-31."""
    acc = None
    for i, x in enumerate(tensors):
        v = _bits64(x.reshape(-1, x.shape[-1]))
        d = (v * _digest_weights(i, v.shape[0], v.device)).sum(dim=0) \
            % DIGEST_P
        acc = d * (i + 1) if acc is None else (acc + d * (i + 1)) % DIGEST_P
    return acc


def state_digest(st) -> torch.Tensor:
    return digest([x.T if nm == "key" else x
                   for nm, x in zip(type(st)._fields, st) if x is not None])


def out_digest(out) -> torch.Tensor:
    """The outputs held bitwise between the card and the CPU: obs,
    terminated, press reward and purity (the action and the two outputs of
    the sorting reward's tanh are recorded apart)."""
    return digest([out.obs.T, out.terminated, out.press_reward, out.purity])


def argmax_near_tie(logits: torch.Tensor) -> torch.Tensor:
    """Whether the two largest logits of each row lie within ARGMAX_RTOL of
    the larger: an argmax that may split between the card and the CPU."""
    top = torch.topk(logits, 2, dim=-1).values
    return (top[..., 0] - top[..., 1]) <= ARGMAX_RTOL * top[
        ..., 0].abs().clamp(min=1.0)


class TieLog:
    """Marks, step by step, the envs that drew at a near-tie: a categorical
    draw (``fastb._vcategorical``) whose two largest perturbed logits lie
    within TIE_ULPS ulp, or an agent's argmax (``fastb.agent_argmax``) whose
    two largest logits lie within ARGMAX_RTOL of the larger.  ``install``
    wraps the two functions of the port's fastb; ``remove`` restores
    them."""

    def __init__(self):
        self.cur = None

    def install(self):
        from marl_sortingenv_tpu_torch.core import fastb as TB
        from marl_sortingenv_tpu_torch.core import threefry as TF
        self._real = (TB._vcategorical, TB.agent_argmax)
        real_cat, real_arg = self._real

        def cat(keys, logits):
            if self.cur is not None:
                top = torch.topk(TF.vperturbed(keys, logits), 2, dim=-1).values
                gap = (top[:, 0].view(torch.int32).to(torch.int64)
                       - top[:, 1].view(torch.int32).to(torch.int64)).abs()
                self.cur |= torch.isfinite(top).all(dim=-1) & (gap <= TIE_ULPS)
            return real_cat(keys, logits)

        def arg(logits):
            if self.cur is not None and logits.shape[-1] > 1:
                self.cur |= argmax_near_tie(logits)
            return real_arg(logits)
        TB._vcategorical, TB.agent_argmax = cat, arg
        return self

    def remove(self):
        from marl_sortingenv_tpu_torch.core import fastb as TB
        TB._vcategorical, TB.agent_argmax = self._real

    def begin(self, n, dev):
        self.cur = torch.zeros(n, dtype=torch.bool, device=dev)

    def end(self):
        cur, self.cur = self.cur, None
        return cur


class Recorder:
    """Per-step records of a run: action, reward, sort reward, the output
    digest, the state digest and the near-tie flags, kept on the device
    until ``stacked``."""

    def __init__(self):
        self.rows = []

    def add(self, st, out, near):
        self.rows.append((out.action, out.reward, out.sort_reward,
                          out_digest(out), state_digest(st), near))

    def stacked(self):
        return [torch.stack([r[i] for r in self.rows]).cpu()
                for i in range(6)]


def load_agents(names, dev):
    from marl_sortingenv_tpu_torch.models import mlp
    return [None if a is None else mlp.load_npz(
        str(AGENT_NPZ[a]), device=dev).requires_grad_(False) for a in names]


def make_step(kind, cfg, masked, agents, dev, plain=False):
    """The autoreset step ``(st, action) -> (st, out)`` of ``kind`` ('rule',
    'external', 'sort', 'press', 'model', 'random'); ``plain`` takes the
    eager bodies that launch no kernel."""
    from marl_sortingenv_tpu_torch.core import fastb as TB
    pols = load_agents(agents, dev)
    if plain:
        return TB.with_autoreset(cfg, TB.eager_step(kind, masked, *pols))
    if kind == "model":
        return TB.with_autoreset(cfg, lambda c, s, a: TB.step_mono_model(
            c, s, *pols, masked))
    if kind == "random":
        return TB.with_autoreset(cfg, lambda c, s, a: TB.step_mono_random(
            c, s, masked))
    return TB.mono_autoreset_step(cfg, kind, masked)


def cpu_trajectory(job):
    """A worker process: the job's run on the CPU path, with per-step
    records.  Returns (tag, records, final state)."""
    from marl_sortingenv_tpu_torch.config.config import load_config
    from marl_sortingenv_tpu_torch.core import fastb as TB
    torch.set_num_threads(1)
    tag, kind, cfg_kw, masked, agents, seed, n, steps, acts = job
    cfg = load_config(**cfg_kw)
    step = make_step(kind, cfg, masked, agents, "cpu")
    st = TB.reset_batch(cfg, seed, n, device="cpu")
    log, rec = TieLog().install(), Recorder()
    for t in range(steps):
        log.begin(n, "cpu")
        st, out = step(st, None if acts is None else torch.from_numpy(acts[t]))
        rec.add(st, out, log.end())
    return tag, rec.stacked(), st


def match_cpu(tag, rec_g, rec_c, st_g, st_c):
    """Hold the card's run to the CPU's: per step the actions, the output
    and state digests bitwise and the sorting reward's two outputs to 4 ulp
    (torch's tanh on the card and on the CPU); an env whose action differs
    must have drawn at a near-tie on either side, and leaves the comparison
    from then on.  The final states of the other envs equal, every leaf.
    Returns (the near-ties as (step, env, action on the card, on the CPU),
    the envs compared to the end)."""
    ag, rg, sg, og, dg, ng = rec_g
    ac, rc, sc, oc, dc, nc = rec_c
    steps, n = ag.shape
    alive = torch.ones(n, dtype=torch.bool)
    ties = []
    for t in range(steps):
        split = (ag[t] != ac[t]) & alive
        for env in split.nonzero().flatten().tolist():
            if not (ng[t, env] or nc[t, env]):
                raise AssertionError(
                    f"{tag}: step {t}, env {env}: action {int(ag[t, env])} "
                    f"on the card, {int(ac[t, env])} on the CPU, and no "
                    "near-tie")
            ties.append((t, env, int(ag[t, env]), int(ac[t, env])))
        alive &= ~split
        if not (torch.equal(og[t][alive], oc[t][alive])
                and torch.equal(dg[t][alive], dc[t][alive])):
            raise AssertionError(f"{tag}: step {t}: the card's state or "
                                 "outputs differ from the CPU's")
        for x, y in ((rg[t], rc[t]), (sg[t], sc[t])):
            tol = TIE_ULPS * 2.0**-23 * y.abs().clamp(min=1.0)
            if ((x - y).abs() > tol)[alive].any():
                raise AssertionError(f"{tag}: step {t}: a reward differs "
                                     f"from the CPU's by more than 4 ulp")
    for nm, x, y in zip(type(st_g)._fields, st_g, st_c):
        if x is None:
            continue
        x = x.cpu()
        same = (torch.equal(x[alive], y[alive]) if nm == "key"
                else torch.equal(x[..., alive], y[..., alive]))
        if not same:
            raise AssertionError(f"{tag}: final state.{nm} differs from the "
                                 "CPU's")
    return ties, int(alive.sum())


def gpu_run(job, dev, events_check=False):
    """The job's run on the card: the kernel-2 path and the plain path in
    lockstep, every leaf and output bitwise, kernel 2 once per step on the
    kernel path and no launch on the plain one.  With ``events_check`` the
    same steps also run in events mode (kernel 1 with its fused autoreset):
    every non-bale leaf and output bitwise, and ``events_to_full`` of its
    state equal to the full-mode state at steps 100 and ``steps - 2``.
    Returns (records, final state, launches by kernel)."""
    from marl_sortingenv_tpu_torch.config.config import load_config
    from marl_sortingenv_tpu_torch.core import bale_events as TBE
    from marl_sortingenv_tpu_torch.core import fastb as TB
    tag, kind, cfg_kw, masked, agents, seed, n, steps, acts = job
    cfg = load_config(**cfg_kw)
    step_k = make_step(kind, cfg, masked, agents, dev)
    step_p = make_step(kind, cfg, masked, agents, dev, plain=True)
    st_k = st_p = TB.reset_batch(cfg, seed, n, device=dev)
    if events_check:
        cfg_e = load_config(**{**cfg_kw, "bale_mode": "events"})
        step_e = make_step(kind, cfg_e, masked, agents, dev)
        st_e = TB.reset_batch(cfg_e, seed, n, device=dev)
    log, rec = TieLog().install(), Recorder()
    used = {"step_mono": 0, "sort_material": 0, "sort_redistribute": 0}
    try:
        for t in range(steps):
            a = None if acts is None else torch.from_numpy(acts[t]).to(dev)
            before = launch_counts()
            log.begin(n, dev)
            st_k, o_k = step_k(st_k, a)
            near = log.end()
            d = {k: v - before[k] for k, v in launch_counts().items()}
            if d != {"step_mono": 0, "sort_material": 1,
                     "sort_redistribute": 0}:
                raise AssertionError(f"{tag} step {t}: launches {d}")
            used["sort_material"] += 1
            st_p, o_p = no_launch(step_p, st_p, a)
            states_equal(st_k, st_p, (o_k, o_p), f"{tag}: kernel-2 path vs "
                         f"plain, step {t}")
            rec.add(st_k, o_k, near)
            if events_check:
                before = launch_counts()["step_mono"]
                st_e, o_e = step_e(st_e, a)
                used["step_mono"] += launch_counts()["step_mono"] - before
                states_equal(st_e._replace(ev_mat=None, ev_n=None, ev_q=None,
                                           ev_cnt=None),
                             st_k._replace(bale_size=None, bale_qual=None,
                                           bale_cnt=None), (o_e, o_k),
                             f"{tag}: events mode vs full mode, step {t}")
                if t in (100, steps - 2):
                    states_equal(TBE.events_to_full(cfg_e, st_e), st_k,
                                 tag=f"{tag}: events_to_full at step {t}")
    finally:
        log.remove()
    return rec.stacked(), st_k, used


def card_trajectory(job):
    """A worker process on the card: ``gpu_run`` of the job (events mode
    alongside for the full-mode kinds).  Returns (tag, records, final state
    on the CPU, launches by kernel, seconds)."""
    from marl_sortingenv_tpu_torch.core import fastb as TB
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    rec, st, used = gpu_run(job, torch.device("cuda"),
                            events_check=job[1] in TB.VARIANTS)
    st = type(st)(*(None if x is None else x.cpu() for x in st))
    return job[0], rec, st, used, time.perf_counter() - t0


def slice_jobs(n: int, steps: int):
    """The runs of phases 12 (full-bale mode, default config) and 13
    (model and random steps, default config): (tag, kind, config
    overrides, masked, agents, seed, envs, steps, actions or None)."""
    rng = np.random.default_rng(41)
    n_act = {"external": 22, "sort": 2, "press": 11}
    jobs = []
    for kind in ("rule", "external", "sort", "press"):
        acts = (None if kind == "rule" else rng.integers(
            0, n_act[kind], (steps, n)).astype(np.int32))
        jobs.append((f"full {kind}", kind, {"bale_mode": "full"}, True, (),
                     43, n, steps, acts))
    # each agent with and without, each with masking on and off
    for kind, masked, agents in (
            ("random", True, ()), ("random", False, ()),
            ("model", True, (None, None)), ("model", False, ("sort", None)),
            ("model", False, (None, "press")),
            ("model", True, ("sort", "press"))):
        tag = (f"random masked={masked}" if kind == "random" else
               f"model sort={agents[0] or '-'} press={agents[1] or '-'} "
               f"masked={masked}")
        jobs.append((tag, kind, {}, masked, agents, 44, n, steps, None))
    return jobs


def diagnose_bench_miss(cfg, policy, engine, agents, dev):
    """Where the card's benchmark mean misses the JAX value: run the policy
    on the card and on the CPU side by side and show that each env whose
    action splits drew at a near-tie.  Returns the near-ties."""
    from marl_sortingenv_tpu_torch.core import fastb as TB
    from marl_sortingenv_tpu_torch.eval import harness
    gens = {}
    for d in (dev, "cpu"):
        sp, pp, mp = load_agents(agents, d)
        gens[d] = harness.policy_steps(cfg, policy, engine, 10, 200, sp, pp,
                                       mp, True, 1, device=d)
    log = TieLog().install()
    # the log wraps Python functions, which a replayed graph never calls:
    # the card's steps run eagerly here
    graphed, TB.graphed_step = TB.graphed_step, lambda *a, **kw: None
    alive = torch.ones(10, dtype=torch.bool)
    ties = []
    try:
        for t in range(200):
            log.begin(10, dev)
            o_g = next(gens[dev])
            n_g = log.end().cpu()
            log.begin(10, "cpu")
            o_c = next(gens["cpu"])
            n_c = log.end()
            split = (o_g.action.cpu() != o_c.action) & alive
            for env in split.nonzero().flatten().tolist():
                if not (n_g[env] or n_c[env]):
                    raise AssertionError(
                        f"engine benchmark {policy} ({engine}): step {t}, "
                        f"env {env} splits from the CPU with no near-tie")
                ties.append((t, env))
            alive &= ~split
    finally:
        TB.graphed_step = graphed
        log.remove()
    if not ties:
        raise AssertionError(f"engine benchmark {policy} ({engine}) misses "
                             "the JAX mean with no split action")
    return ties


# ---- the parity engine: phase 16 ------------------------------------------

# The parity 5-policy benchmark on the CPU with the JAX package (JAX 0.9.0,
# x64 on, as its parity engine needs), per seed 1..10, masked, 200 steps:
#   JAX_PLATFORMS=cpu python -c "import jax; from marl_sortingenv_tpu.config
#   .config import load_config; from marl_sortingenv_tpu.eval import harness;
#   from marl_sortingenv_tpu.models import mlp; from marl_sortingenv_tpu.
#   utils.checkpoint import load_model; ag = lambda f, o, a: load_model(
#   'artifacts/models_tuned/' + f, mlp.init_params(jax.random.PRNGKey(0),
#   o, a)); print(harness.run_model_benchmark(load_config(), 10, 200,
#   sort_params=ag('PPO_Sorting_Tuned_100000.npz', 13, 2), press_params=ag(
#   'PPO_Pressing_Tuned_100000.npz', 16, 11), mono_params=ag(
#   'PPO_Monolith_Tuned_100000.npz', 29, 22))[1])"
# The Random and Rule-Based means are the reference's own numbers
# (artifacts/benchmark_results.json): -86.84669390179657, 44.17809308063072.
BENCH_PARITY_JAX = {
    "Random": [-93.52043834461455, -96.50822581334674, -79.5004336307652,
        -105.87454692320152, -78.07479554645109, -86.50008552567576,
        -81.3839438980173, -93.8754451202734, -65.82093021934804,
        -87.40809399627209],
    "Rule-Based": [43.323907118661396, 42.788865609188484, 44.51832563188417,
        45.33716297323927, 44.71890338477742, 46.66614439338525,
        42.90220229027747, 45.28068250759824, 41.84182321991992,
        44.40291367737545],
    "PPO Sort-Only": [-77.8835761886536, -64.93122173192872,
        -59.400262738453634, -79.03436138827482, -64.85558668031767,
        -66.22111180793435, -58.687651327041976, -74.63664493327343,
        -75.63248906098579, -44.8221181876384],
    "PPO Modular": [46.35540048042628, 48.12344371648052, 58.97529150439743,
        58.295458968438396, 59.49376281525825, 58.630098512055184,
        47.86197884618586, 60.20842544897309, 46.50291482047502,
        58.550100886201164],
    "PPO Monolith": [83.08977456434741, 83.27984698161076, 80.5264048436311,
        87.00421358790777, 87.57378087032446, 88.34912833176526,
        83.096615985324, 87.50857573469969, 84.89078961439549,
        80.28050520645904]}
REF_PARITY_MEANS = {"Random": -86.84669390179657,
                    "Rule-Based": 44.17809308063072}
PARITY_N, PARITY_STEPS = 64, 210
PARITY_TRAIN_STEPS = 64     # 16c's rollout; cut it (never 16b) to keep
                            # phase 16 near 90 s


def parity_jobs(n: int, steps: int):
    """The runs of phase 16a: every step variant of the parity engine
    (``core/step.py``) with and without each tuned agent, masking on and
    off, on the default and the noise-0.05 config at max_steps 200:
    (tag, kind, config overrides, masked, agents, first seed, envs, steps,
    actions or None)."""
    rng = np.random.default_rng(61)
    n_act = {"external": 22, "sort": 2, "press": 11}
    kinds = [("external", True, ()), ("external", False, ()),
             ("rule", True, ()),
             ("model", True, (None, None)), ("model", False, ("sort", None)),
             ("model", False, (None, "press")),
             ("model", True, ("sort", "press")),
             ("legacy", True, ()), ("legacy", False, ()),
             ("sort", True, ()), ("press", True, (None,)),
             ("press", False, ("sort",)),
             ("policy", True, ("mono",)), ("agent", True, ("mono",))]
    jobs = []
    for cname, kw in (("default", {}), ("noise_0.05",
                                        {"noise_sorting": 0.05})):
        for kind, masked, agents in kinds:
            acts = (rng.integers(0, n_act[kind], (steps, n)).astype(np.int32)
                    if kind in n_act else None)
            tag = (f"{cname} {kind} masked={masked}"
                   + (f" agents={agents}" if any(agents) else ""))
            jobs.append((tag, kind, {"max_steps": 200, **kw}, masked, agents,
                         500, n, steps, acts))
    return jobs


def _parity_rows(x: torch.Tensor) -> torch.Tensor:
    """A batch-first tensor's elements as 32-bit halves of their bit
    patterns: int64 [N, 2K], each in [0, 2**32)."""
    x = x.contiguous()
    if x.dtype == torch.float64:
        v = x.view(torch.int64)
    elif x.dtype == torch.float32:
        v = x.view(torch.int32).to(torch.int64)
    else:
        v = x.to(torch.int64)
    v = v.reshape(v.shape[0], -1)
    return torch.cat([v & 0xFFFFFFFF, (v >> 32) & 0xFFFFFFFF], dim=1)


def parity_digest(tensors) -> torch.Tensor:
    """int64[N]: ``digest`` for batch-first tensors of any dtype, 64-bit
    ones (the f64 and u64 leaves) included."""
    acc = None
    for i, x in enumerate(tensors):
        v = _parity_rows(x)
        w = _digest_weights(i, v.shape[1], v.device).T
        d = (v * w).sum(dim=1) % DIGEST_P
        acc = d * (i + 1) if acc is None else (acc + d * (i + 1)) % DIGEST_P
    return acc


def _flat_leaves(st):
    from marl_sortingenv_tpu_torch.core import state as PSt
    parts = st if isinstance(st, list) else [st]
    return [x for part in parts for _, x in PSt.named_leaves(part)]


class ParityTieLog:
    """Marks, step by step, the envs where a tuned agent's argmax
    (``step.agent_argmax``) had its two largest logits within ARGMAX_RTOL
    of the larger: the one place the parity path may split between the
    card and the CPU (their f32 products round apart)."""

    def __init__(self):
        self.cur = None

    def install(self):
        from marl_sortingenv_tpu_torch.core import step as PS
        self._real = real = PS.agent_argmax

        def arg(logits):
            if self.cur is not None:
                self.cur |= argmax_near_tie(logits)
            return real(logits)
        PS.agent_argmax = arg
        return self

    def remove(self):
        from marl_sortingenv_tpu_torch.core import step as PS
        PS.agent_argmax = self._real

    def begin(self, n, dev):
        self.cur = torch.zeros(n, dtype=torch.bool, device=dev)

    def end(self):
        cur, self.cur = self.cur, None
        return cur


def parity_stepper(kind, cfg, masked, agents, seeds, dev):
    """The autoreset step ``(states, action) -> (states, out)`` of a phase
    16a run; ``states`` is [EnvState] or [EnvState, MTState] ('legacy')."""
    from marl_sortingenv_tpu_torch.core import legacy_random as PLR
    from marl_sortingenv_tpu_torch.core import step as PS
    from marl_sortingenv_tpu_torch.core import wrappers as PW
    pols = load_agents([a for a in agents], dev)
    if kind == "legacy":
        def step(states, a):
            st, lr = states
            st, lr, out = PS.step_mono_legacy_random(cfg, st, lr, masked)
            st = PW._reset_where(cfg, st, out.terminated)
            return [st, lr], out
        return step, [PLR.mt19937_init(seeds, device=dev)]
    fn = {"external": lambda c, s, a: PS.step_mono_external(c, s, a, masked),
          "rule": lambda c, s, a: PS.step_mono_rule(c, s),
          "model": lambda c, s, a: PS.step_mono_model(c, s, *pols, masked),
          "sort": PS.step_sort,
          "press": lambda c, s, a: PS.step_press(c, s, a, pols[0], masked),
          "policy": lambda c, s, a: PS.step_mono_policy(c, s, pols[0],
                                                        masked),
          "agent": lambda c, s, a: PS.step_mono_agent(c, s, pols[0],
                                                      masked)}[kind]
    wrapped = PW.with_autoreset(cfg, fn)

    def step(states, a):
        st, out = wrapped(states[0], a)
        return [st], out
    return step, []


def parity_trajectory(job, device: str):
    """A worker process: the job's run of the parity engine on ``device``
    with per-step records (action, output digest, state digest, near-tie
    flags).  Returns (tag, records, the final state's leaves on the CPU,
    the kernel launches of the run, host syncs, seconds)."""
    from marl_sortingenv_tpu_torch.config.config import load_config
    from marl_sortingenv_tpu_torch.core import rng as PR
    from marl_sortingenv_tpu_torch.core import state as PSt
    from marl_sortingenv_tpu_torch.core import step as PS
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag, kind, cfg_kw, masked, agents, seed0, n, steps, acts = job
    dev = torch.device(device)
    cfg = load_config(**cfg_kw)
    seeds = np.arange(seed0, seed0 + n)
    step, extra = parity_stepper(kind, cfg, masked, agents, seeds, dev)
    states = [PSt.reset(cfg, seeds, device=dev)] + extra
    log, recs = ParityTieLog().install(), []
    before, syncs = launch_counts(), PR.HOST_SYNCS
    t0 = time.perf_counter()
    try:
        for t in range(steps):
            a = None if acts is None else torch.from_numpy(acts[t]).to(dev)
            log.begin(n, dev)
            states, out = step(states, a)
            recs.append((out.action,
                         parity_digest([getattr(out, f)
                                        for f in PS.StepOut._fields]),
                         parity_digest(_flat_leaves(states)), log.end()))
    finally:
        log.remove()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    rec = [torch.stack([r[i] for r in recs]).cpu() for i in range(4)]
    return (tag, rec, [x.cpu() for x in _flat_leaves(states)], launched,
            PR.HOST_SYNCS - syncs, secs)


def parity_cpu(job):
    return parity_trajectory(job, "cpu")


def parity_card(job):
    return parity_trajectory(job, "cuda")


def match_parity(tag, rec_g, rec_c, fin_g, fin_c):
    """Hold the card's parity run to the CPU's: per step the actions and
    the digests of every output and every state leaf bitwise; an env whose
    action differs must have met an argmax near-tie on either side, and
    leaves the comparison from then on.  The final leaves of the other
    envs equal.  Returns (the near-ties as (step, env), envs kept)."""
    ag, og, dg, ng = rec_g
    ac, oc, dc, nc = rec_c
    steps, n = ag.shape
    alive = torch.ones(n, dtype=torch.bool)
    ties = []
    for t in range(steps):
        split = (ag[t] != ac[t]) & alive
        for env in split.nonzero().flatten().tolist():
            if not (ng[t, env] or nc[t, env]):
                raise AssertionError(
                    f"parity {tag}: step {t}, env {env}: action "
                    f"{int(ag[t, env])} on the card, {int(ac[t, env])} on "
                    "the CPU, and no near-tie")
            ties.append((t, env))
        alive &= ~split
        if not (torch.equal(og[t][alive], oc[t][alive])
                and torch.equal(dg[t][alive], dc[t][alive])):
            raise AssertionError(f"parity {tag}: step {t}: the card's "
                                 "state or outputs differ from the CPU's")
    for i, (x, y) in enumerate(zip(fin_g, fin_c)):
        if not torch.equal(x[alive], y[alive]):
            raise AssertionError(f"parity {tag}: final leaf {i} differs")
    return ties, int(alive.sum())


def phase_parity(dev, agents, pcfg, n_train, pjobs) -> dict:
    """Phase 16, the parity engine.  16a's runs (``pjobs``) go to spawned
    workers (the CPU side in three, the card's in four) and are compared
    as they end; then, with no worker left on the host, this process runs
    and times 16b (the parity benchmark with ``agents``, the tuned sort,
    press and mono agents) and 16c (PPO iterations of mono on the parity
    engine at ``n_train`` envs with ``pcfg``).  The parity path runs none
    of kernels 1-3, which the launch counters show.  Returns the
    report."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing as mp
    from marl_sortingenv_tpu_torch.config.config import load_config
    from marl_sortingenv_tpu_torch.core import rng as PR
    from marl_sortingenv_tpu_torch.eval import harness
    from marl_sortingenv_tpu_torch.learn import ppo
    spawn = mp.get_context("spawn")
    t0 = time.perf_counter()
    parity_report = {"16a": {}, "16b": {}, "16c": {}}
    with ProcessPoolExecutor(3, mp_context=spawn) as cpu_pool, \
            ProcessPoolExecutor(4, mp_context=spawn) as card_pool:
        cpu_futures = [cpu_pool.submit(parity_cpu, job) for job in pjobs]
        card_futures = [card_pool.submit(parity_card, job) for job in pjobs]

        # ---- 16a. the card's parity runs against the CPU's ----------------
        total_ties = 0
        for job, card_fut, cpu_fut in zip(pjobs, card_futures, cpu_futures):
            tag, rec_g, fin_g, used_g, syncs_g, secs_g = card_fut.result()
            _, rec_c, fin_c, used_c, _, secs_c = cpu_fut.result()
            if any(used_g.values()) or any(used_c.values()):
                raise AssertionError(f"parity {tag} launched {used_g}")
            ties, kept = match_parity(tag, rec_g, rec_c, fin_g, fin_c)
            total_ties += len(ties)
            n, steps = job[6], job[7]
            parity_report["16a"][tag] = {
                "near_ties": ties, "envs_kept": kept,
                "card_s": secs_g, "cpu_s": secs_c,
                "card_ms_per_step": secs_g / steps * 1e3,
                "host_syncs_per_step": syncs_g / steps}
            print(f"phase 16a: {tag}: card == CPU, every state leaf and "
                  f"output bitwise, {n} envs x {steps} autoreset steps: "
                  f"{len(ties)} near-ties {ties}, {kept} envs held to the "
                  f"end; card {secs_g / steps * 1e3:.2f} ms per step, "
                  f"{syncs_g / steps:.2f} host syncs per step, no kernel "
                  f"launched", flush=True)
    # the workers have ended: 16b and 16c are timed alone on the host
    t16a = time.perf_counter() - t0

    # ---- 16b. the parity 5-policy benchmark, 10 seeds x 200 steps ----
    # one run of the entry point; each policy's batch of seeds timed
    # through the harness's per-policy runner
    t1 = time.perf_counter()
    cfg_p = load_config()
    timed = {}
    real = harness._policy_totals_parity

    def timed_totals(cfg, key, *args):
        syncs, w0 = PR.HOST_SYNCS, time.perf_counter()
        out = real(cfg, key, *args)
        timed[key] = (time.perf_counter() - w0, PR.HOST_SYNCS - syncs)
        return out
    zero_counts()
    harness._policy_totals_parity = timed_totals
    try:
        summary, rows = harness.run_model_benchmark(
            cfg_p, 10, 200, *agents, use_action_masking=True, device=dev)
    finally:
        harness._policy_totals_parity = real
    if launch_counts() != {"step_mono": 0, "sort_material": 0,
                           "sort_redistribute": 0}:
        raise AssertionError(f"the parity benchmark launched "
                             f"{launch_counts()}")
    for key in harness.POLICY_KEYS:
        got = [r[key] for r in rows]
        if got != BENCH_PARITY_JAX[key]:
            raise AssertionError(f"parity benchmark {key}: per-seed "
                                 f"totals {got} != JAX "
                                 f"{BENCH_PARITY_JAX[key]}")
    for key, ref in REF_PARITY_MEANS.items():
        if summary[key]["mean"] != ref:
            raise AssertionError(f"parity benchmark {key}: mean "
                                 f"{summary[key]['mean']!r} != the "
                                 f"reference's {ref!r}")
    print(f"phase 16b: run_model_benchmark on the card, 10 seeds x 200 "
          f"steps, masked, tuned agents: every per-seed total of all 5 "
          f"policies == the JAX table; Random mean "
          f"{summary['Random']['mean']!r}, Rule-Based mean "
          f"{summary['Rule-Based']['mean']!r} == the reference's; no "
          f"kernel launched ({time.perf_counter() - t1:.1f} s)",
          flush=True)
    parity_report["16b"]["summary"] = summary
    for key in harness.POLICY_KEYS:
        wall, syncs = timed[key]
        # the busy share of 5 profiled steps (the profiler's own
        # bookkeeping of a thousand kernels per step is slow)
        _, prof_us, busy, by_kernel, n_kern = profile_busy(
            lambda key=key: real(cfg_p, key, list(range(1, 11)), 5,
                                 *agents, True, dev))
        parity_report["16b"][key] = {
            "wall_s": wall, "env_steps_per_s": 10 * 200 / wall,
            "host_syncs_per_step": syncs / 200,
            "device_kernels_per_step": n_kern / 5,
            "profiled_steps": 5, "profiled_wall_s": prof_us / 1e6,
            "device_busy_share": busy,
            "device_ms_by_kernel": {k: t / 1e3 for k, t in by_kernel[:6]}}
        print(f"phase 16b: parity {key}, 10 seeds x 200 steps: "
              f"{wall:.3f} s wall, {10 * 200 / wall:.1f} env-steps/s, "
              f"{syncs / 200:.2f} host syncs per step; device busy "
              f"{busy:.3f} over 5 profiled steps ({prof_us / 1e6:.3f} "
              f"s), {n_kern / 5:.1f} device kernels per step; top: "
              + ", ".join(f"{k[:32]} {t / 1e3:.2f} ms"
                          for k, t in by_kernel[:3]), flush=True)

    # ---- 16c. PPO iterations of mono on the parity engine --------------
    # at the JAX benchmark's width: PARITY_TRAIN_STEPS env steps,
    # minibatches of 16384, 4 epochs; 3 timed iterations after 1 warm-up
    t1 = time.perf_counter()
    spec = ppo.spec_for("mono")
    if spec.engine != "parity":
        raise AssertionError(f"spec_for's default engine {spec.engine}")
    pcfg_p = dataclasses.replace(pcfg, n_steps=PARITY_TRAIN_STEPS)
    ts = ppo.init_train_state(cfg_p, pcfg_p, spec, n_train, seed=0,
                              device=dev)
    it = ppo.make_train_iteration(cfg_p, pcfg_p, spec)
    step_fn = spec.step_fn(None, True)
    zero_counts()
    ts, stats = it(ts)                                  # warm-up
    syncs, rows = PR.HOST_SYNCS, []
    for _ in range(3):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(3))
        e0.record()
        ts, trs, last_value = ppo.collect_rollout(cfg_p, pcfg_p, spec, ts,
                                                  step_fn, True)
        e1.record()
        adv, ret = ppo.compute_gae(pcfg_p, trs, last_value)
        ts, stats = ppo.ppo_update(pcfg_p, ts, trs, adv, ret)
        e2.record()
        torch.cuda.synchronize()
        rows.append((e0.elapsed_time(e1), e1.elapsed_time(e2)))
    syncs = PR.HOST_SYNCS - syncs
    roll_ms = float(np.mean([r[0] for r in rows]))
    upd_ms = float(np.mean([r[1] for r in rows]))
    loss = float(stats["loss"])
    if not np.isfinite(loss) or ts.ep_return_acc.dtype != torch.float64:
        raise AssertionError(f"parity training: loss {loss}, return "
                             f"dtype {ts.ep_return_acc.dtype}")
    # the busy share of an iteration of 4 env steps (same envs, one
    # minibatch per epoch)
    pcfg_4 = dataclasses.replace(pcfg, n_steps=4)
    it4 = ppo.make_train_iteration(cfg_p, pcfg_4, spec)
    (ts, stats), wall_us, busy, by_kernel, n_kern = profile_busy(
        lambda: it4(ts))
    if launch_counts() != {"step_mono": 0, "sort_material": 0,
                           "sort_redistribute": 0}:
        raise AssertionError(f"parity training launched {launch_counts()}")
    n_steps = pcfg_p.n_steps
    rate = n_train * n_steps / ((roll_ms + upd_ms) / 1e3)
    parity_report["16c"] = {
        "n_envs": n_train, "n_steps": n_steps,
        "batch_size": pcfg_p.batch_size, "n_epochs": pcfg_p.n_epochs,
        "rollout_ms": roll_ms, "update_ms": upd_ms,
        "iterations_ms": rows, "loss": loss, "samples_per_s": rate,
        "host_syncs_per_env_step": syncs / (3 * n_steps),
        "profiled_iteration_steps": 4,
        "profiled_iteration_wall_ms": wall_us / 1e3,
        "device_busy_share": busy,
        "device_kernels_per_profiled_iteration": n_kern,
        "device_ms_by_kernel": {k: t / 1e3 for k, t in by_kernel[:8]}}
    print(f"phase 16c: train mono on the parity engine at {n_train} envs "
          f"(n_steps {n_steps}, minibatch {pcfg_p.batch_size}, "
          f"{pcfg_p.n_epochs} epochs, shuffle block "
          f"{pcfg_p.shuffle_block}): {rate:.1f} samples/s; rollout "
          f"{roll_ms:.3f} ms, update {upd_ms:.3f} ms (CUDA events, mean of "
          f"3 iterations after 1 warm-up: {rows}); "
          f"{syncs / (3 * n_steps):.2f} host syncs per env step; loss {loss:.6f}; a 4-step iteration under the "
          f"profiler: {wall_us / 1e3:.1f} ms wall, device busy "
          f"{busy:.3f}, {n_kern} device kernels; no kernel 1-3 "
          f"launched; top: "
          + ", ".join(f"{k[:32]} {t / 1e3:.2f} ms"
                      for k, t in by_kernel[:3])
          + f" ({time.perf_counter() - t1:.1f} s)", flush=True)

    print(f"phase 16: {len(pjobs)} parity runs, {total_ties} near-ties; "
          f"{time.perf_counter() - t0:.1f} s (16a {t16a:.1f} s)", flush=True)
    return parity_report


# ---- the flow and the envs: phases 9 and 17 ----------------------------------

# What the card's machine has of the host modules' optional packages: its
# answer to importlib.util.find_spec (phase 17 prints it again).  No
# gymnasium, so the envs run there on the shim of envs.py; no matplotlib,
# so every path that draws a figure (an env's render, viz/, eval/plots,
# main.run_sim, a test_env episode that ends) is held on the CPU only
# (tests/test_torch_{host,cli}.py), and phase 9 drives the flow through
# run_training_flow, as main.run_sim drives it, not through the CLI.
CARD_PACKAGES = {"gymnasium": False, "matplotlib": False, "pandas": True,
                 "cv2": True}
FLOW_TIMESTEPS = 4096   # the CLI's 100,000 cut to two iterations per stage
REF_BENCH_JSON = ROOT / "artifacts" / "benchmark_results.json"
ENV_STEPS, ENV_MAX_STEPS, ENV_SEED = 210, 200, 42
ENV_TIMED_STEPS = 100   # the timed Gym loop per class, alone on the host
ENV_ACCESSORS = ("container_materials", "press_state", "bale_count",
                 "current_step")


def flow_steps_ab(cfg, dev) -> dict:
    """Phase 9's kernels against their plain versions at the flow's own
    widths and config: each stage's step as ``train_agent`` builds it (the
    press stage with the tuned sort agent frozen in place of the sort
    stage's), the rollout's autoreset step at 16 envs from reset across
    the episode's end, and ``ppo.evaluate``'s step (no autoreset) at its 10
    envs over one episode, on the same random actions.  Kernel 1 (sort,
    mono) or kernel 2 (press) launches once per step, the other never.  In
    two windows of 12 steps, the first from reset and the second up to and
    (the rollout) across the episode's end, the kernel path is held
    bitwise in every leaf and output against the plain body
    (``fastb.eager_step``), which starts each window from the kernel
    path's state; between them the kernel path steps alone (the plain
    body's host time would double the phase).  Returns the steps held per
    stage."""
    from marl_sortingenv_tpu_torch.core import fastb as TB
    from marl_sortingenv_tpu_torch.learn import ppo
    (sort_agent,) = load_agents(["sort"], dev)
    gen = torch.Generator(device="cpu").manual_seed(42)
    held = {}
    for name, variant, kernel in (("sort", "sort", "step_mono"),
                                  ("press", "press", "sort_material"),
                                  ("mono", "external", "step_mono")):
        spec = ppo.spec_for(name, engine="fastb")
        sp = sort_agent if name == "press" else None
        step_fn = spec.step_fn(sp, True)
        plain = TB.eager_step(variant, True, sp)
        runs = (("rollout", 16, cfg.max_steps + 6,
                 spec.batched_autoreset_step(cfg, step_fn, True),
                 TB.with_autoreset(cfg, plain)),
                ("evaluate", 10, cfg.max_steps,
                 spec.batched_step(cfg, step_fn),
                 spec.batched_step(cfg, plain)))
        want = {k: int(k == kernel) for k in launch_counts()}
        for what, n, steps, step_k, step_p in runs:
            hold = [*range(12), *range(steps - 12, steps)]
            st_k = spec.reset_batch(cfg, n, 42, device=dev)
            ends = 0
            for t in range(steps):
                a = torch.randint(0, spec.n_actions, (n,), generator=gen,
                                  dtype=torch.int32).to(dev)
                if t in hold and t - 1 not in hold:
                    st_p = st_k
                before = launch_counts()
                st_k, o_k = step_k(st_k, a)
                d = {k: v - before[k] for k, v in launch_counts().items()}
                if d != want:
                    raise AssertionError(f"phase 9: {name} {what} step {t} "
                                         f"at {n} envs: launches {d}")
                ends += int(o_k.terminated.sum())
                if t in hold:
                    st_p, o_p = no_launch(step_p, st_p, a)
                    states_equal(st_k, st_p, (o_k, o_p),
                                 f"phase 9: {name} {what} at {n} envs, "
                                 f"step {t}")
            if ends < n:
                raise AssertionError(f"phase 9: {name} {what} at {n} envs: "
                                     f"{ends} episode ends, fewer than envs")
            held[f"{name} {what}"] = {"envs": n, "steps": steps,
                                      "held": [hold[0], hold[11], hold[12],
                                               hold[-1]]}
    return held


def phase_flow(dev) -> tuple:
    """Phase 9: ``run_training_flow`` at the CLI's defaults (16 envs, 10
    bench seeds x 200 steps; the timesteps cut to FLOW_TIMESTEPS), each
    stage and the closing benchmark timed and their kernel launches
    counted apart.  Returns (report, training launches, benchmark
    launches)."""
    from marl_sortingenv_tpu_torch.config.config import load_config
    from marl_sortingenv_tpu_torch.eval import harness
    from marl_sortingenv_tpu_torch.learn import trainer
    # as main.run_sim builds it from the CLI's defaults
    cfg = load_config(None, max_steps=200, noise_sorting=0.0, balesize=200)
    stages, bench = {}, {}
    real_train, real_bench = trainer.train_agent, harness.run_model_benchmark

    def timed_train(cfg, variant, *args, **kw):
        w0 = time.perf_counter()
        res = real_train(cfg, variant, *args, **kw)
        torch.cuda.synchronize()
        stages[variant] = (time.perf_counter() - w0, res,
                           kw.get("sort_params"))
        return res

    def counted_bench(*args, **kw):
        bench["training_launches"] = launch_counts()
        bench["kw"] = kw
        zero_counts()
        w0 = time.perf_counter()
        out = real_bench(*args, **kw)
        bench["wall_s"] = time.perf_counter() - w0
        bench["launches"] = launch_counts()
        return out

    # the flow's kernels against their plain versions first, at its widths
    t0 = time.perf_counter()
    held = flow_steps_ab(cfg, dev)
    print(f"phase 9: each stage's step as train_agent builds it, kernel "
          f"path == plain path, bitwise in every leaf and output, in the "
          f"first 12 and the last 12 of the rollout's autoreset steps at 16 "
          f"envs x {cfg.max_steps + 6} (across the episode's end) and of "
          f"evaluate's steps at 10 envs x {cfg.max_steps}; kernel 1 (sort, "
          f"mono) or kernel 2 (press, the tuned sort agent frozen) once per "
          f"step ({time.perf_counter() - t0:.1f} s)", flush=True)

    models_dir = ROOT / "build" / "chip_smoke_models"
    zero_counts()
    trainer.train_agent, harness.run_model_benchmark = (timed_train,
                                                        counted_bench)
    t0 = time.perf_counter()
    try:
        flow = trainer.run_training_flow(
            cfg, use_action_masking=True, total_timesteps=FLOW_TIMESTEPS,
            n_envs=16, seed=42, engine="fastb", bench_seeds=10,
            steps_test=200, models_dir=str(models_dir), device=dev)
    finally:
        trainer.train_agent, harness.run_model_benchmark = (real_train,
                                                            real_bench)
    wall = time.perf_counter() - t0
    if set(flow) != {"sort", "press", "mono", "benchmark",
                     "benchmark_rows"} or list(stages) != ["sort", "press",
                                                           "mono"]:
        raise AssertionError(f"the flow: keys {set(flow)}, stages "
                             f"{list(stages)}")
    report = {"cfg": "load_config(None, max_steps=200, noise_sorting=0.0, "
                     "balesize=200)", "n_envs": 16,
              "total_timesteps": FLOW_TIMESTEPS, "wall_s": wall,
              "kernel_vs_plain_held": held}
    for name, (secs, res, _) in stages.items():
        if flow[name] is not res or len(res.history) != 2 or not all(
                np.isfinite(h["loss"]) for h in res.history) or not \
                np.isfinite(res.final_eval_mean) or any(
                p.device.type != dev.type for p in res.params.parameters()):
            raise AssertionError(f"flow stage {name}: {res.history}, "
                                 f"{res.final_eval_mean}")
        report[name] = {"wall_s": secs, "final_eval_mean": res.final_eval_mean,
                        "final_eval_std": res.final_eval_std,
                        "losses": [h["loss"] for h in res.history]}
        print(f"phase 9: run_training_flow stage {name}: 2 iterations at 16 "
              f"envs, final eval {res.final_eval_mean:.6f} +- "
              f"{res.final_eval_std:.6f}, {secs:.1f} s", flush=True)
    if stages["press"][2] is not flow["sort"].params or any(
            bench["kw"][f"{k}_params"] is not flow[k].params
            for k in ("sort", "press", "mono")):
        raise AssertionError("the flow's stages are not wired as JAX's")
    for prefix in ("Sorting", "Pressing", "Monolith"):
        if not (models_dir / f"PPO_{prefix}_Masked_{FLOW_TIMESTEPS}.npz"
                ).is_file():
            raise AssertionError(f"the flow saved no PPO_{prefix}_Masked")
    train_l, bench_l = bench["training_launches"], bench["launches"]
    if train_l["step_mono"] <= 0 or train_l["sort_material"] <= 0 or any(
            bench_l.values()):
        raise AssertionError(f"the flow launched {train_l} in training and "
                             f"{bench_l} in its benchmark")
    # the means == the reference's; the stds == np.std of the JAX
    # package's per-seed table (the reference's file holds stds that differ
    # from that by a few ulp: it was written under another numpy)
    ref = json.loads(REF_BENCH_JSON.read_text())["masked"]
    for key in ("Random", "Rule-Based"):
        got = flow["benchmark"][key]
        want = {"mean": ref[key]["mean"],
                "std": float(np.std(BENCH_PARITY_JAX[key]))}
        if got != want:
            raise AssertionError(f"the flow's benchmark {key}: {got} != "
                                 f"{want}")
        report.setdefault("std_ulps_from_reference_file", {})[key] = int(
            abs(np.float64(got["std"]).view(np.int64)
                - np.float64(ref[key]["std"]).view(np.int64)))
    report["benchmark"] = {"wall_s": bench["wall_s"],
                           "summary": flow["benchmark"],
                           "launches": bench_l}
    report["training_launches"] = train_l
    print(f"phase 9: run_training_flow's closing benchmark, 10 seeds x 200 "
          f"steps on the parity engine: Random {flow['benchmark']['Random']}"
          f", Rule-Based {flow['benchmark']['Rule-Based']}: the means == "
          f"artifacts/benchmark_results.json, the stds == np.std of the JAX "
          f"table ({report['std_ulps_from_reference_file']} ulp from the "
          f"file's); no kernel launched; "
          f"{bench['wall_s']:.1f} s.  Training launched {train_l}; the "
          f"flow took {wall:.1f} s", flush=True)
    return report, train_l, bench_l


def env_jobs():
    """The runs of phase 17: (tag, env class, action source, masked,
    agents as (set_agents keyword, tuned agent), check_overflow)."""
    both = (("sort_agent", "sort"), ("press_agent", "press"))
    mono = (("mono_agent", "mono"),)
    return [
        ("Env_1_Sorting actions", "Env_1_Sorting", "action", True, (),
         False),
        ("Env_2_Pressing rule", "Env_2_Pressing", "action", True, (), False),
        ("Env_2_Pressing tuned sort agent", "Env_2_Pressing", "action", True,
         (("sort_agent", "sort"),), False),
        ("Env_2_Pressing idle check_overflow", "Env_2_Pressing", "idle",
         True, (), True)] + [
        (f"Env_3_Monolith {src} {'masked' if m else 'unmasked'}",
         "Env_3_Monolith", src, m, agents, False)
        for src, agents in (("action", ()), ("random", ()),
                            ("model", both), ("agent", mono))
        for m in (True, False)] + [
        ("Env_3_Monolith rule_based", "Env_3_Monolith", "rule_based", True,
         (), False)]


def env_step(env, src, masked, over, mask, rng):
    """One Gym step from the action source: an action drawn from ``rng``
    among the valid ones when masked, 0 for 'idle', or a mode."""
    kw = {"use_action_masking": masked, "check_overflow": over}
    if src in ("action", "idle"):
        valid = (np.flatnonzero(mask) if masked
                 else np.arange(env.action_space.n))
        a = 0 if src == "idle" else int(valid[rng.integers(len(valid))])
        return env.step(a, **kw)
    return env.step(mode=None if src == "agent" else src, **kw)


def env_end(env) -> dict:
    """What an episode's end leaves: the logs, the accessors and the
    print_checksum lines."""
    import contextlib
    import copy
    import io
    from marl_sortingenv_tpu_torch.core import state as PSt
    from marl_sortingenv_tpu_torch.eval import episode_log as PEL
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        PEL.print_checksum(PSt.env_at(env.state), seed=env.seed_value,
                           cfg=env.config)
    return {"reward_data": copy.deepcopy(env.reward_data),
            "press_log": list(env.press_actions_per_timestep),
            "belt_counts": [x.tolist() for x in env._belt_counts_log],
            "press_timer": [x.tolist() for x in env._press_timer_log],
            **{k: getattr(env, k) for k in ENV_ACCESSORS},
            "overflow": env.detect_overflow(), "checksum": buf.getvalue()}


def env_trajectory(job, device: str):
    """A worker process: the job's Gym loop on ``device`` for ENV_STEPS
    steps at max_steps ENV_MAX_STEPS, an unseeded reset() at each
    episode's end.  Returns (tag, per step (mask, the 5-tuple), per step
    the argmax near-tie flags, the episode ends, launches, host syncs,
    seconds)."""
    from marl_sortingenv_tpu_torch import envs as PE
    from marl_sortingenv_tpu_torch.core import rng as PR
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag, cls_name, src, masked, agents, over = job
    dev = torch.device(device)
    env = getattr(PE, cls_name)(max_steps=ENV_MAX_STEPS, seed=ENV_SEED,
                                device=dev)
    pols = load_agents([a for _, a in agents], dev)
    env.set_agents(**{k: p for (k, _), p in zip(agents, pols)})
    rng = np.random.default_rng(ENV_SEED)
    log, recs, flags, ends = ParityTieLog().install(), [], [], []
    before, syncs = launch_counts(), PR.HOST_SYNCS
    t0 = time.perf_counter()
    try:
        env.reset(seed=ENV_SEED)
        for _ in range(ENV_STEPS):
            mask = env.action_masks()
            log.begin(1, dev)
            out = env_step(env, src, masked, over, mask, rng)
            flags.append(log.end())
            recs.append((mask, out))
            if out[2]:
                ends.append(env_end(env))
                env.reset()
    finally:
        log.remove()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    syncs = PR.HOST_SYNCS - syncs
    ends.append(env_end(env))
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    return (tag, recs, torch.cat(flags).cpu().tolist(), ends, launched,
            syncs, secs)


def env_cpu(job):
    return env_trajectory(job, "cpu")


def env_card(job):
    return env_trajectory(job, "cuda")


def match_env(tag, res_g, res_c):
    """Hold the card's Gym loop to the CPU's: per step the mask, obs,
    reward, terminated, truncated and info equal; a differing action must
    be an argmax near-tie on either side, and ends the comparison.  The
    episode ends before it (logs, accessors, checksum lines) equal.
    Returns the step of a near-tie split, or None."""
    _, recs_g, ties_g, ends_g = res_g[:4]
    _, recs_c, ties_c, ends_c = res_c[:4]
    n_ends = 0
    for t, ((mg, og), (mc, oc)) in enumerate(zip(recs_g, recs_c)):
        if not np.array_equal(mg, mc):
            raise AssertionError(f"{tag}: step {t}: masks differ")
        if og[4]["action"] != oc[4]["action"]:
            if not (ties_g[t] or ties_c[t]):
                raise AssertionError(
                    f"{tag}: step {t}: action {og[4]['action']} on the "
                    f"card, {oc[4]['action']} on the CPU, and no near-tie")
            break
        if not (og[0].dtype == oc[0].dtype == np.float32
                and np.array_equal(og[0], oc[0]) and og[1:] == oc[1:]
                and type(og[1]) is type(oc[1]) is float):
            raise AssertionError(f"{tag}: step {t}: the card's step "
                                 f"{og[1:]} != the CPU's {oc[1:]}")
        n_ends += bool(og[2])
    else:
        t, n_ends = None, len(ends_g)
    if ends_g[:n_ends] != ends_c[:n_ends]:
        raise AssertionError(f"{tag}: the episode logs, accessors or "
                             "checksum lines differ")
    return t, n_ends


def watch_ties(model) -> list:
    """Per call of ``model.predict_deterministic`` from then on, whether
    the two largest of its (masked) logits lay within ARGMAX_RTOL."""
    from marl_sortingenv_tpu_torch.models import mlp
    real, flags = model.predict_deterministic, []

    def predict(obs, mask=None):
        logits = model.policy_logits(obs)
        if mask is not None:
            logits = mlp.masked_logits(logits, mask)
        flags.append(bool(argmax_near_tie(logits)))
        return real(obs, mask)
    model.predict_deterministic = predict
    return flags


def phase_envs(dev) -> dict:
    """Phase 17: the Gymnasium drop-in envs on the card against the CPU.
    Every job of ``env_jobs`` runs its Gym loop in worker processes (the
    CPU side in three, the card's in three) and the two are compared;
    then, alone on the host, one loop per class is timed on the card and
    profiled, ``check_env`` runs on each class and ``testing.test_env`` on
    the monolith (50 steps of 200, so that the episode does not end and
    draw its figure: the card's machine has no matplotlib)."""
    from concurrent.futures import ProcessPoolExecutor
    import importlib.util
    import multiprocessing as mp
    from marl_sortingenv_tpu_torch import envs as PE
    from marl_sortingenv_tpu_torch import testing as PT
    from marl_sortingenv_tpu_torch.core import rng as PR
    from marl_sortingenv_tpu_torch.utils.env_checker import check_env
    t0 = time.perf_counter()
    found = {m: importlib.util.find_spec(m) is not None
             for m in CARD_PACKAGES}
    rep = {"packages_found": found, "packages_assumed": CARD_PACKAGES,
           "gymnasium_in_envs": PE._GYM, "runs": {}}
    print(f"phase 17: find_spec on this machine {found}; the script "
          f"assumes {CARD_PACKAGES}; envs.py uses "
          f"{'gymnasium' if PE._GYM else 'its shim'}", flush=True)
    jobs = env_jobs()
    spawn = mp.get_context("spawn")
    with ProcessPoolExecutor(3, mp_context=spawn) as cpu_pool, \
            ProcessPoolExecutor(3, mp_context=spawn) as card_pool:
        cpu_futures = [cpu_pool.submit(env_cpu, job) for job in jobs]
        card_futures = [card_pool.submit(env_card, job) for job in jobs]
        for job, card_fut, cpu_fut in zip(jobs, card_futures, cpu_futures):
            res_g, res_c = card_fut.result(), cpu_fut.result()
            tag = job[0]
            if any(res_g[4].values()) or any(res_c[4].values()):
                raise AssertionError(f"{tag} launched {res_g[4]}")
            split, n_ends = match_env(tag, res_g, res_c)
            syncs, secs = res_g[5], res_g[6]
            rep["runs"][tag] = {
                "near_tie_split_step": split, "episode_ends_compared": n_ends,
                "card_ms_per_gym_step": secs / ENV_STEPS * 1e3,
                "host_syncs_per_gym_step": syncs / ENV_STEPS,
                "cpu_ms_per_gym_step": res_c[6] / ENV_STEPS * 1e3}
            print(f"phase 17: {tag}: card == CPU, every step's obs, reward, "
                  f"terminated, info and mask over {ENV_STEPS} steps (max "
                  f"{ENV_MAX_STEPS}), {n_ends} episode ends' reward_data, "
                  f"accessors and checksum lines"
                  + (f"; an argmax near-tie split at step {split}"
                     if split is not None else "")
                  + f"; card {secs / ENV_STEPS * 1e3:.2f} ms per Gym step "
                  f"(beside 5 worker processes), {syncs / ENV_STEPS:.2f} "
                  f"host syncs per Gym step; no kernel launched", flush=True)
    t_workers = time.perf_counter() - t0

    # alone on the host: one Gym loop per class, timed and profiled
    zero_counts()
    rep["alone"] = {}
    for cls_name, src in (("Env_1_Sorting", "action"),
                          ("Env_2_Pressing", "action"),
                          ("Env_3_Monolith", "rule_based")):
        env = getattr(PE, cls_name)(max_steps=ENV_MAX_STEPS, seed=ENV_SEED,
                                    device=dev)
        env.reset(seed=ENV_SEED)
        rng = np.random.default_rng(ENV_SEED)

        def loop(steps, env=env, src=src, rng=rng):
            for _ in range(steps):
                if env_step(env, src, True, False, env.action_masks(),
                            rng)[2]:
                    env.reset()
        loop(10)                                            # warm-up
        torch.cuda.synchronize()
        syncs, w0 = PR.HOST_SYNCS, time.perf_counter()
        loop(ENV_TIMED_STEPS)
        torch.cuda.synchronize()
        wall, syncs = time.perf_counter() - w0, PR.HOST_SYNCS - syncs
        _, prof_us, busy, by_kernel, n_kern = profile_busy(lambda: loop(5))
        rep["alone"][cls_name] = {
            "source": src, "ms_per_gym_step": wall / ENV_TIMED_STEPS * 1e3,
            "host_syncs_per_gym_step": syncs / ENV_TIMED_STEPS,
            "timed_steps": ENV_TIMED_STEPS,
            "device_kernels_per_gym_step": n_kern / 5,
            "device_busy_share": busy, "profiled_steps": 5,
            "profiled_wall_ms": prof_us / 1e3}
        print(f"phase 17: {cls_name} ({src}) alone on the card: "
              f"{wall / ENV_TIMED_STEPS * 1e3:.2f} ms per Gym step over "
              f"{ENV_TIMED_STEPS} steps, {syncs / ENV_TIMED_STEPS:.2f} host "
              f"syncs per Gym step; {n_kern / 5:.1f} device kernels per "
              f"step, device busy {busy:.3f} over 5 profiled steps",
              flush=True)

    # the env checker on each class, and test_env, on the card
    for cls in (PE.Env_1_Sorting, PE.Env_2_Pressing, PE.Env_3_Monolith):
        check_env(cls(max_steps=ENV_MAX_STEPS, seed=1, device=dev),
                  n_steps=20)
    runs, ties = [], []
    for d in (dev, torch.device("cpu")):
        (mono,) = load_agents(["mono"], d)
        ties.append(watch_ties(mono))
        env = PE.Env_3_Monolith(max_steps=ENV_MAX_STEPS, seed=ENV_SEED,
                                device=d)
        runs.append(PT.test_env(env, steps=50, seed=ENV_SEED, mode="model",
                                model=mono, stats=False))
    split = next((t for t, (a, b) in enumerate(zip(runs[0][1], runs[1][1]))
                  if a != b), None)
    if len(runs[0][1]) != 50 or (split is None and runs[0] != runs[1]) or (
            split is not None and not (ties[0][split] or ties[1][split])):
        raise AssertionError(f"test_env on the card {runs[0]} != on the "
                             f"CPU {runs[1]}")
    if any(launch_counts().values()):
        raise AssertionError(f"phase 17 launched {launch_counts()}")
    rep["test_env"] = {"total": runs[0][0], "steps": 50}
    rep["seconds"] = time.perf_counter() - t0
    print(f"phase 17: check_env passes on the three classes on the card; "
          f"testing.test_env (mono agent, 50 steps) on the card == on the "
          f"CPU, total {runs[0][0]!r}; no kernel launched; "
          f"{rep['seconds']:.1f} s ({t_workers:.1f} s with the workers)",
          flush=True)
    return rep


# ---- phases 3 and 7: kernels 1 and 2 against their plain versions -------
# Phase 9's flow steps 16 envs (the CLI's default), the other main paths
# 4096: phases 3 and 7 hold the kernels at both widths.
AB_WIDTHS = (4096, 16)
KERNEL1_CASES = (("rule", True), ("external", True), ("external", False),
                 ("sort", True), ("press", True), ("press", False))


def kernel1_ab(cfgs, gen, dev, n: int) -> float:
    """Phase 3 at ``n`` envs: the step kernel against ``step_mono_plain``,
    bitwise in every leaf and output, for each variant of KERNEL1_CASES,
    12 autoreset steps across an episode's end on each config (rule steps
    by the kernel up to 6 steps before the end first, so that the A/B
    starts with a filled event log).  Returns the largest reward
    difference."""
    from marl_sortingenv_tpu_torch.core import fastb as TB
    from marl_sortingenv_tpu_torch.ops import step_cuda
    n_act = {"rule": 22, "external": 22, "sort": 2, "press": 11}
    max_err = 0.0
    for cname, cfg in cfgs.items():
        st0 = TB.reset_batch(cfg, 9, n, device=dev)
        for _ in range(cfg.max_steps - 6):
            st0, _ = step_cuda.step_mono_kernel(cfg, st0, None,
                                                variant="rule",
                                                autoreset=True)
        if int(st0.ev_cnt.max()) <= 0:
            raise AssertionError(f"{cname} at {n} envs: no press completed "
                                 "before the A/B")
        for variant, masked in KERNEL1_CASES:
            st_k = st_p = st0
            for t in range(12):
                a = torch.randint(0, n_act[variant], (n,), generator=gen,
                                  dtype=torch.int32).to(dev)
                a = None if variant == "rule" else a
                st_k, o_k = step_cuda.step_mono_kernel(
                    cfg, st_k, a, variant=variant, masked=masked,
                    autoreset=True)
                st_p, o_p = no_launch(
                    step_cuda.step_mono_plain, cfg, st_p, a,
                    variant=variant, masked=masked, autoreset=True)
                states_equal(st_k, st_p, (o_k, o_p),
                             f"{cname} {variant} masked={masked} at {n} "
                             f"envs, step {t}")
                max_err = max(max_err, float(
                    (o_k.reward - o_p.reward).abs().max()))
    return max_err


def frozen_press_ab(cfg, sort_agent, gen, dev, n: int) -> None:
    """Phase 7 at ``n`` envs: the press step with the frozen sort agent,
    its sorting core on kernel 2, against the plain path, bitwise in every
    leaf and output, 24 masked and 24 unmasked autoreset steps from
    max_steps - 12 rule steps on, across the reset; kernel 2 once per step,
    kernel 1 never."""
    from marl_sortingenv_tpu_torch.core import fastb as TB
    from marl_sortingenv_tpu_torch.ops import step_cuda
    st0 = TB.reset_batch(cfg, 17, n, device=dev)
    for _ in range(cfg.max_steps - 12):
        st0, _ = step_cuda.step_mono_kernel(cfg, st0, None, variant="rule",
                                            autoreset=True)
    for masked in (True, False):
        step_k = TB.with_autoreset(cfg, lambda c, s, a, m=masked: TB.step_press(
            c, s, a, sort_agent, m))
        step_p = TB.with_autoreset(cfg, TB.eager_step("press", masked,
                                                      sort_agent))
        st_k = st_p = st0
        crossed = False
        for t in range(24):
            a = torch.randint(0, 11, (n,), generator=gen,
                              dtype=torch.int32).to(dev)
            before = launch_counts()
            st_k, o_k = step_k(st_k, a)
            d = {k: v - before[k] for k, v in launch_counts().items()}
            if d != {"step_mono": 0, "sort_material": 1,
                     "sort_redistribute": 0}:
                raise AssertionError(f"frozen-sort press step {t} at {n} "
                                     f"envs: launches {d}")
            st_p, o_p = no_launch(step_p, st_p, a)
            states_equal(st_k, st_p, (o_k, o_p),
                         f"frozen-sort press masked={masked} at {n} envs, "
                         f"step {t}")
            crossed |= bool(o_k.terminated.any())
        if not crossed:
            raise AssertionError(f"the frozen-sort A/B at {n} envs crossed "
                                 "no reset")


# ---- the integer-exact engine: phase 18 -------------------------------------

EXACT_CARD_WORKERS, EXACT_CPU_WORKERS = 5, 2
EXACT_TIMED_STEPS = 3       # alone on the host, by the host clock


def exact_scenario(job):
    """A worker process: one scenario of ``eval/exact_scenarios`` on the
    device; returns (name, its arrays, its stats, the kernels it
    launched)."""
    from marl_sortingenv_tpu_torch.eval import exact_scenarios as XS
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    name, device = job
    before = launch_counts()
    out = XS.run(name, device)
    stats = out.pop("_stats")
    stats["near"] = out.pop("_near", None)
    return (name, out, stats,
            {k: v - before[k] for k, v in launch_counts().items()})


def exact_tie_check(dev) -> None:
    """Integer logits tie exactly where f32 ones almost never do: on the
    card the first maximal index wins, masked or not, as on the CPU."""
    from marl_sortingenv_tpu_torch.models import mlp_exact as MX
    b = torch.zeros(11, dtype=torch.int64)
    b[[2, 5, 7]] = 1 << 28
    qp = MX.QPolicy(pi=(MX.QDense(torch.zeros(16, 32, dtype=torch.int32),
                                  torch.zeros(32, dtype=torch.int64)),),
                    action=MX.QDense(torch.zeros(32, 11, dtype=torch.int32),
                                     b))
    qg = MX.QPolicy(pi=tuple(MX.QDense(l.w.to(dev), l.b.to(dev))
                             for l in qp.pi),
                    action=MX.QDense(qp.action.w.to(dev),
                                     qp.action.b.to(dev)))
    obs = torch.rand(4096, 16, generator=torch.Generator().manual_seed(3))
    mask = torch.ones(4096, 11, dtype=torch.bool)
    mask[1::4, 2] = False
    mask[2::4, 2] = mask[2::4, 5] = False
    first = torch.tensor([2, 5, 7, 2], dtype=torch.int32).repeat(1024)
    for m, want in ((None, torch.full((4096,), 2, dtype=torch.int32)),
                    (mask, first)):
        c = MX.predict_deterministic_q(qp, obs, m)
        g = MX.predict_deterministic_q(qg, obs.to(dev),
                                       None if m is None else m.to(dev))
        if not (torch.equal(g.cpu(), want) and torch.equal(c, want)):
            raise AssertionError("an exact tie of integer logits did not "
                                 "take the first maximal index")


def exact_actions(g, sg, c, sc) -> dict:
    """Phase 18's ``model_actions`` (the f32 agents of
    ``artifacts/models_tuned`` on the exact engine: the monolith in closed
    loop, the sort and press agents on the rule-based obs streams): the
    card's actions held to the CPU's and to the JAX CPU and TPU files,
    an action split allowed only where either device's two largest logits
    lie within ``XS.ARGMAX_RTOL`` (a closed-loop episode compared up to its
    first split).  The splits are counted and printed."""
    from marl_sortingenv_tpu_torch.eval import exact_scenarios as XS
    near = {k: sg["near"][k] | sc["near"][k] for k in g}
    out = {"steps": sg["steps"], "envs": sg["envs"],
           "card_ms_per_step": sg["seconds"] / sg["steps"] * 1e3,
           "cpu_ms_per_step": sc["seconds"] / sc["steps"] * 1e3,
           "actions": sum(v.size for v in g.values()),
           "near_tie_steps": int(sum(v.sum() for v in near.values())),
           "splits": {}}
    for tag, want in (("CPU", c), ("JAX CPU file", XS.golden("model_actions")),
                      ("TPU file", XS.golden("model_actions", tpu=True))):
        if sorted(want) != sorted(g):
            raise AssertionError(f"exact model_actions: keys differ from "
                                 f"the {tag}")
        bad, ties = XS.compare_actions(g, want, near)
        if bad:
            raise AssertionError(f"exact model_actions: card != {tag} in "
                                 f"{bad}, with no near-tie")
        out["splits"][tag] = ties
    print(f"phase 18: exact model_actions (the f32 agents of models_tuned), "
          f"10 seeds x {sg['steps']} steps, {out['actions']} actions: card "
          f"== CPU == JAX CPU file == TPU file but at near-ties of the f32 "
          f"logits ({out['near_tie_steps']} near-tie steps; splits: "
          + ", ".join(f"{len(v)} vs the {k}" for k, v in
                      out["splits"].items())
          + f"); card {out['card_ms_per_step']:.2f} ms per step (closed "
          f"loop and rule stream), CPU {out['cpu_ms_per_step']:.2f}; no "
          f"kernel launched", flush=True)
    return out


def phase_exact(dev) -> dict:
    """Phase 18, the integer-exact engine (plain PyTorch, no kernel of its
    own, none of kernels 1-3): every scenario of ``eval/exact_scenarios``
    (the JAX package's artifact scripts' scenarios: the Rule-Based
    benchmark at 10 seeds x 200 steps with its soft-float return, every
    step variant at noise 0 and 0.05, the golden trajectory, the four
    integer-policy paths with the agents of ``artifacts/models_masked``,
    and 4096 envs x 20 rule steps) on the card and on the CPU in worker
    processes, held bit for bit to each other and, where a golden file
    exists, to the JAX package's CPU file and to the TPU's file; and the
    f32 agents' actions on the exact engine (``model_actions``), held so
    but for counted near-ties of their f32 logits (``exact_actions``).  Then,
    alone on the host, ms, host syncs and device kernels per exact step."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing as mp
    from marl_sortingenv_tpu_torch.core import exact_dynamics as XD
    from marl_sortingenv_tpu_torch.core import rng as PR
    from marl_sortingenv_tpu_torch.core import state as PSt
    from marl_sortingenv_tpu_torch.eval import exact_scenarios as XS
    t0 = time.perf_counter()
    exact_tie_check(dev)
    # the longest runs first: the f32 agents' actions, the integer-policy
    # paths, the benchmark
    names = sorted(XS.NAMES, key=lambda n: (n != "model_actions",
                                            not n.startswith("model:"),
                                            n != "bench", n))
    spawn = mp.get_context("spawn")
    rep = {"scenarios": {}}
    with ProcessPoolExecutor(EXACT_CARD_WORKERS, mp_context=spawn) as gp, \
            ProcessPoolExecutor(EXACT_CPU_WORKERS, mp_context=spawn) as cp:
        card = [gp.submit(exact_scenario, (n, "cuda")) for n in names]
        cpu = [cp.submit(exact_scenario, (n, "cpu")) for n in names]
        for name, fg, fc in zip(names, card, cpu):
            _, g, sg, lg = fg.result()
            _, c, sc, _ = fc.result()
            if any(lg.values()):
                raise AssertionError(f"exact {name} launched {lg}")
            if name == "model_actions":
                rep["scenarios"][name] = exact_actions(g, sg, c, sc)
                continue
            if sorted(g) != sorted(c) or XS.compare(g, c):
                raise AssertionError(f"exact {name}: card != CPU in "
                                     f"{XS.compare(g, c) or sorted(g)}")
            held = []
            for tpu in (False, True):
                want = XS.golden(name, tpu)
                if want:
                    bad = XS.compare(g, want)
                    if bad or not set(want) <= set(g):
                        raise AssertionError(
                            f"exact {name}: card != the "
                            f"{'TPU' if tpu else 'JAX CPU'} file in {bad}")
                    held.append("TPU file" if tpu else "JAX CPU file")
            ms = sg["seconds"] / sg["steps"] * 1e3
            rep["scenarios"][name] = {
                "steps": sg["steps"], "envs": sg["envs"],
                "card_ms_per_step": ms,
                "cpu_ms_per_step": sc["seconds"] / sc["steps"] * 1e3,
                "host_syncs_per_step": sg["host_syncs"] / sg["steps"],
                "held_to": ["CPU"] + held, "keys": sorted(g)}
            print(f"phase 18: exact {name}, {sg['envs']} envs x "
                  f"{sg['steps']} steps: card == CPU"
                  + "".join(f" == {h}" for h in held)
                  + f", bit for bit in {len(g)} arrays ({', '.join(sorted(g)[:4])}"
                  f"{', ...' if len(g) > 4 else ''}); card {ms:.2f} ms per "
                  f"step, {sg['host_syncs'] / sg['steps']:.2f} host syncs per "
                  f"step, CPU {sc['seconds'] / sc['steps'] * 1e3:.2f} ms per "
                  f"step; no kernel launched", flush=True)
    rep["scenarios_s"] = time.perf_counter() - t0

    # alone on the host: ms, host syncs and device kernels per exact step
    rep["alone"] = {}
    for noise in (0.0, 0.05):
        cfg = XS.config(noise)
        for n in (10, 4096):
            st = PSt.reset(cfg, np.arange(n), device=dev)
            for _ in range(2):
                st, _ = XD.step_mono_rule_exact(cfg, st)
            torch.cuda.synchronize()
            s0, w0 = PR.HOST_SYNCS, time.perf_counter()
            for _ in range(EXACT_TIMED_STEPS):
                st, _ = XD.step_mono_rule_exact(cfg, st)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - w0) / EXACT_TIMED_STEPS * 1e3
            syncs = (PR.HOST_SYNCS - s0) / EXACT_TIMED_STEPS
            # one more step under the profiler: its kernels and busy share
            _, wall_us, busy, by_kernel, n_kern = profile_busy(
                lambda st=st, cfg=cfg: XD.step_mono_rule_exact(cfg, st))
            key = f"noise {noise} rule, {n} envs"
            rep["alone"][key] = {
                "ms_per_step": ms, "host_syncs_per_step": syncs,
                "device_kernels_per_step": n_kern,
                "profiled_ms_per_step": wall_us / 1e3,
                "device_busy_share": busy,
                "device_ms_by_kernel": {k: t / 1e3 for k, t in by_kernel[:6]}}
            print(f"phase 18: exact rule step at noise {noise}, {n} envs, "
                  f"alone: {ms:.2f} ms per step (mean of "
                  f"{EXACT_TIMED_STEPS}), {syncs:.2f} host syncs per step, "
                  f"{n_kern} device kernels per step, device busy "
                  f"{busy:.3f} (one profiled step)", flush=True)
    rep["seconds"] = time.perf_counter() - t0
    print(f"phase 18: {len(names) - 1} integer scenarios card == CPU == "
          f"the golden files where they exist, 0 mismatches; the f32 "
          f"agents' actions as above; an exact tie of "
          f"integer logits takes the first index on the card "
          f"({rep['seconds']:.1f} s)", flush=True)
    return rep


# ---- data parallelism: phase 19 ---------------------------------------------

SHARD_ARGV = ["--n-envs", "4096", "--n-steps", "64", "--batch-size", "16384",
              "--epochs", "4", "--shuffle-block", "128", "--max-steps", "200",
              "--iterations", "5", "--rollout-steps", "24",
              "--legs", "train,press"]


def run_dryrun(world: int, backend: str, out: Path) -> dict:
    """``python -m marl_sortingenv_tpu_torch.parallel.dryrun`` on the card
    (its ranks are processes of their own); its results and per-rank,
    per-leg kernel launches."""
    cmd = [sys.executable, "-m", "marl_sortingenv_tpu_torch.parallel.dryrun",
           "--world", str(world), "--backend", backend, "--device", "cuda",
           *SHARD_ARGV, "--out", str(out), "--timeout", "400"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=450)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"dryrun world {world} {backend} exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    with np.load(out) as d:
        res = {k: d[k] for k in d.files}
    res["_launches"] = json.loads(str(res.pop("launches")))
    res["_seconds"] = secs
    return res


def phase_sharded(dev, main_launches, by_path) -> dict:
    """Phase 19, data parallelism on ``fastb`` at the JAX benchmark's
    width (4096 global envs, 64 steps, minibatches of 16384, 4 epochs):
    five sharded PPO iterations (320 steps, across the episode's end at
    200) over 1 rank (NCCL) and over 2 ranks on the one card (gloo, staged
    through host memory: NCCL refuses two ranks on one card), each rank
    stepping its shard with kernel 1, held bitwise to its plain version on
    the shard in the first and the last ``dryrun.HOLD`` steps of each of
    the first four rollouts (the fifth is timed); the parameters and loss
    stats bitwise those of five unsharded iterations on the card.  And the
    sharded frozen-sort press rollout (24 steps), each rank's
    kernel-2 launches held bitwise to their plain version on its shard,
    and the gathered rollout to the unsharded one."""
    from marl_sortingenv_tpu_torch.parallel import dryrun as DR
    t0 = time.perf_counter()
    args = DR.parse(SHARD_ARGV)
    want = {}
    for leg in ("train", "press"):
        before = launch_counts()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        want[leg] = DR.unsharded(leg, args, dev)
        e1.record()
        torch.cuda.synchronize()
        want[leg]["_ms"] = e0.elapsed_time(e1)
        restore_counts(before)     # the reference: not a sharded launch
    unsharded_s = want["train"]["_ms"] / 1e3 / args.iterations
    rep = {"unsharded_iteration_s": unsharded_s, "runs": {}}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for world, backend in ((1, "nccl"), (2, "gloo")):
        res = run_dryrun(world, backend, out_dir / f"dryrun_{world}.npz")
        for leg in ("train", "press"):
            for k, v in want[leg].items():
                if k.startswith("_"):
                    continue
                g = res[f"{leg}/{k}"]
                v = v.detach().cpu().numpy()
                if g.dtype != v.dtype or g.shape != v.shape or \
                        not np.array_equal(g, v):
                    raise AssertionError(f"phase 19: world {world} "
                                         f"({backend}) {leg}: {k} differs "
                                         "from the unsharded run")
        per_leg = {leg: {k: sum(r[leg][k] for r in res["_launches"])
                         for k in main_launches} for leg in ("train", "press")}
        n_local = 4096 // world
        if per_leg["train"] != {"step_mono": 64 * world * args.iterations,
                                "sort_material": 0,
                                "sort_redistribute": 0} or \
                per_leg["press"] != {"step_mono": 0,
                                     "sort_material": 24 * world,
                                     "sort_redistribute": 0}:
            raise AssertionError(f"phase 19: world {world} launches "
                                 f"{per_leg}")
        held = {leg: sum(r[leg]["held_to_plain"] for r in res["_launches"])
                for leg in ("train", "press")}
        if held != {"train": 2 * DR.HOLD * world * (args.iterations - 1),
                    "press": 24 * world}:
            raise AssertionError(f"phase 19: world {world} held {held}")
        add_launches(main_launches, by_path,
                     f"sharded train, {world} rank(s) ({backend}) (19)",
                     per_leg["train"])
        add_launches(main_launches, by_path,
                     f"sharded frozen-sort press, {world} rank(s) "
                     f"({backend}) (19)", per_leg["press"])
        secs = float(res["train/seconds"])
        rep["runs"][f"{world}_{backend}"] = {
            "world": world, "backend": backend,
            "staged_through_host": backend == "gloo",
            "envs_per_rank": n_local, "iteration_s": secs,
            "samples_per_s": 4096 * 64 / secs, "launches": per_leg,
            "held_to_plain": held,
            "process_s": res["_seconds"],
            "loss": float(res["train/stat_loss"])}
        print(f"phase 19: sharded PPO iteration on fastb, {world} rank(s) "
              f"over {backend}{' (staged through host memory)' if backend == 'gloo' else ''}, "
              f"{n_local} envs per rank: parameters and loss stats bitwise "
              f"== the unsharded iteration on the card (loss "
              f"{float(res['train/stat_loss']):.6f}, after "
              f"{args.iterations} iterations, across the episode's end at "
              f"step {args.max_steps}); the last iteration {secs:.3f} "
              f"s in rank 0 (unsharded {unsharded_s:.3f} s per iteration, "
              f"mean of {args.iterations}); kernel 1 "
              f"{per_leg['train']['step_mono']} launches, "
              f"{held['train']} of them (the first and the last "
              f"{DR.HOLD} of each rank's first {args.iterations - 1} "
              f"rollouts, PPO-sampled actions, "
              f"{n_local} envs) == the plain step on the rank's shard, "
              f"bitwise in every leaf and output; the "
              f"frozen-sort press rollout (24 steps): every rank's kernel-2 "
              f"launch ({per_leg['press']['sort_material']} in all) == its "
              f"plain version on its shard, the gathered rollout == the "
              f"unsharded one ({res['_seconds']:.1f} s with the processes' "
              f"start)", flush=True)
    rep["seconds"] = time.perf_counter() - t0
    print(f"phase 19: {rep['seconds']:.1f} s", flush=True)
    return rep


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "marl_sortingenv_tpu_torch").is_dir():
        print("chip_smoke: the port is not next to this script",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--sweep"]:
        return sweep_only(dev)
    if sys.argv[1:] == ["--exact-sharded"]:
        return exact_sharded_only(dev)

    # ---- 1. the card ------------------------------------------------------
    gpu = gpu_line()
    print(gpu, flush=True)

    # ---- 2. build ---------------------------------------------------------
    from marl_sortingenv_tpu_torch.config.config import load_config
    from marl_sortingenv_tpu_torch.core import fastb as TB
    from marl_sortingenv_tpu_torch.learn import ppo
    from marl_sortingenv_tpu_torch.models import mlp
    from marl_sortingenv_tpu_torch.ops import (_build, mvhg_cuda, sort_cuda,
                                               step_cuda)

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s wall, per source {_build.BUILD_SECONDS}",
          flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "stack frame" in line:
                print(f"  {name}: {line.strip()}")
    report = {"gpu": gpu, "build_s": build_s,
              "build_per_source_s": _build.BUILD_SECONDS}

    # ---- 3. kernel vs plain on the card ----------------------------------
    t0 = time.perf_counter()
    cfgs = {
        "default": load_config(bale_mode="events"),
        "noise_0.05": load_config(bale_mode="events", noise_sorting=0.05),
        "press_completion": load_config(bale_mode="events", max_steps=24,
                                        press_time_1=1, press_time_2=2,
                                        balesize=16),
    }
    gen = torch.Generator(device="cpu").manual_seed(31)
    max_err = max(kernel1_ab(cfgs, gen, dev, n) for n in AB_WIDTHS)
    torch.cuda.synchronize()
    print(f"phase 3: kernel == plain on the card, bitwise, 3 configs x "
          f"{len(KERNEL1_CASES)} variants x 12 steps at {AB_WIDTHS} envs, "
          f"across an episode's end; the plain version launched no kernel "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- 4. kernel vs the CPU path ---------------------------------------
    t0 = time.perf_counter()
    cfg = load_config(bale_mode="events")
    step = TB.mono_autoreset_step(cfg, "rule")
    st_g = TB.reset_batch(cfg, 11, 4096, device=dev)
    st_c = TB.reset_batch(cfg, 11, 4096, device="cpu")
    for _ in range(210):
        st_g, _ = step(st_g, None)
        st_c, _ = step(st_c, None)
    states_equal(st_g, st_c, tag="CUDA vs CPU, rule autoreset, 210 steps")
    if int(st_c.current_step.max()) >= 210:
        raise AssertionError("the CPU A/B crossed no episode boundary")
    print(f"phase 4: CUDA == CPU path, bitwise, rule autoreset, 4096 envs x "
          f"210 steps ({time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- 5. the slice at full width --------------------------------------
    model = mlp.ActorCritic(29, 22, generator=torch.Generator().manual_seed(0),
                            device=dev)
    spec = ppo.spec_for("mono", engine="fastb")
    # a small input against the CPU path (same weights, moved)
    model_cpu = mlp.ActorCritic(29, 22, generator=torch.Generator(
        ).manual_seed(0), device="cpu")
    r_gpu = ppo.evaluate(cfg, spec, model, 128, 50, device=dev).cpu()
    r_cpu = ppo.evaluate(cfg, spec, model_cpu, 128, 50, device="cpu")
    if not torch.allclose(r_gpu, r_cpu, rtol=1e-4, atol=1e-5):
        raise AssertionError("evaluate on CUDA differs from the CPU path")

    zero_counts()
    t0 = time.perf_counter()
    returns = ppo.evaluate(cfg, spec, model, 4096, 200, device=dev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = step_cuda.LAUNCHES
    if eval_launches != 200:
        raise AssertionError(f"evaluate launched the kernel {eval_launches} "
                             "times for 200 steps")
    if tuple(returns.shape) != (4096,) or not torch.isfinite(returns).all():
        raise AssertionError("evaluate returned a bad result")
    print(f"phase 5: evaluate mono 4096 envs x 200 steps: return mean "
          f"{returns.mean().item():.6f} std {returns.std().item():.6f}, "
          f"{eval_s:.3f} s, {eval_launches} kernel launches", flush=True)
    report["evaluate"] = {"n_envs": 4096, "n_steps": 200,
                          "mean": returns.mean().item(),
                          "std": returns.std().item(), "seconds": eval_s,
                          "launches": eval_launches}

    stepped = TB.mono_autoreset_step(cfg, "external", True)

    @torch.no_grad()
    def rollout(st, obs, steps):
        for _ in range(steps):
            masks = TB.monolith_action_masks(cfg, st)
            logits = mlp.masked_logits(model.policy_logits(obs), masks)
            a = torch.argmax(logits, dim=-1).to(torch.int32)
            st, out = stepped(st, a)
            obs = out.obs
        return st, obs

    rollout_launches = 0
    report["rollout"] = {}
    for n in (4096, 65536):
        st = TB.reset_batch(cfg, 1, n, device=dev)
        obs = TB.get_mono_obs(cfg, st)
        st, obs = rollout(st, obs, 20)                   # warm-up
        torch.cuda.synchronize()
        zero_counts()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        st, obs = rollout(st, obs, 1000)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1)
        launches = step_cuda.LAUNCHES
        rollout_launches += launches
        if launches != 1000 or not torch.isfinite(obs).all():
            raise AssertionError(f"rollout at {n} envs: {launches} launches")
        rate = n * 1000 / (ms / 1e3)
        print(f"phase 5: fused-policy rollout {n} envs x 1000 steps: "
              f"{rate:.1f} env-steps/s ({ms:.3f} ms), {launches} launches",
              flush=True)
        # where the time goes: device time by kernel over 50 steps
        (st, obs), prof_wall_us, busy, kernels, _ = profile_busy(
            lambda: rollout(st, obs, 50))
        print(f"  profile of 50 steps at {n} envs: device busy "
              f"{busy:.3f} of {prof_wall_us / 50:.1f} us "
              f"per step (wall, profiler on); top device time per step: "
              + ", ".join(f"{k[:40]} {t / 50:.1f} us"
                          for k, t in kernels[:5]), flush=True)
        # the main path's kernel against its plain version on this
        # rollout's own state and actions: policy steps up to 3 before the
        # episode's end, then 6 steps through both, across the reset
        st, obs = rollout(st, obs, (cfg.max_steps - 3 - int(
            st.current_step[0])) % cfg.max_steps)
        st_k = st_p = st
        ev_rows, crossed = int(st.ev_cnt.max()), False
        with torch.no_grad():
            for t in range(6):
                masks = TB.monolith_action_masks(cfg, st_k)
                a = torch.argmax(mlp.masked_logits(
                    model.policy_logits(obs), masks), dim=-1).to(torch.int32)
                st_k, o_k = step_cuda.step_mono_kernel(
                    cfg, st_k, a, variant="external", masked=True,
                    autoreset=True)
                st_p, o_p = no_launch(
                    step_cuda.step_mono_plain, cfg, st_p, a,
                    variant="external", masked=True, autoreset=True)
                states_equal(st_k, st_p, (o_k, o_p),
                             f"main path, {n} envs, step {t}")
                max_err = max(max_err, float(
                    (o_k.reward - o_p.reward).abs().max()))
                crossed |= bool(o_k.terminated.any())
                obs = o_k.obs
        if not crossed:
            raise AssertionError(f"the main-path A/B at {n} envs crossed no "
                                 "episode's end")
        print(f"  kernel == plain, bitwise, on the rollout's state at {n} "
              f"envs: 6 policy steps across the reset, E = "
              f"{cfg.max_press_events}, up to {ev_rows} event rows in use",
              flush=True)
        report["rollout"][n] = {
            "env_steps_per_s": rate, "ms": ms, "launches": launches,
            "profiled_wall_us_per_step": prof_wall_us / 50,
            "device_busy_share": busy,
            "device_us_per_step_by_kernel": {k: t / 50 for k, t in kernels},
            "ab_event_rows_in_use": ev_rows}

    # the kernel alone and its plain version, at the rollout's shape
    kern = {}
    for n in (4096, 65536):
        st = TB.reset_batch(cfg, 2, n, device=dev)
        for _ in range(30):
            st, _ = step_cuda.step_mono_kernel(cfg, st, None, variant="rule",
                                               autoreset=True)
        a = torch.zeros(n, dtype=torch.int32, device=dev)

        def launch():
            return step_cuda.step_mono_kernel(
                cfg, st, a, variant="external", masked=True, autoreset=True)

        def plain():
            return no_launch(step_cuda.step_mono_plain, cfg, st, a,
                             variant="external", masked=True, autoreset=True)

        wall_ms = cuda_ms(launch, 200)
        dev_us = profile_device_us(launch, 100, "step_mono_kernel")
        plain_ms = cuda_ms(plain, 20)
        out_st, out = launch()
        n_bytes = step_bytes(cfg, st, a, out_st, out, n)
        n_reset = int((st.current_step + 1 >= cfg.max_steps).sum())
        int_ops, f32_ops = step_ops(cfg, "external", TB._support_for(cfg),
                                    n, n_reset)
        b = bound(n_bytes, int_ops, f32_ops)
        kern[n] = {"ms": dev_us / 1e3, "wall_ms_per_launch": wall_ms,
                   "plain_ms": plain_ms, "envs_reset": n_reset, **b}
        print(f"step_mono kernel at {n} envs: {dev_us:.3f} us per launch "
              f"(profiler device time; {wall_ms * 1e3:.3f} us per launch "
              f"with the wrapper), plain path {plain_ms:.3f} ms per step, "
              f"bound {b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}; bytes "
              f"{b['bytes_ms'] * 1e3:.3f} us, operations "
              f"{b['ops_ms'] * 1e3:.3f} us)", flush=True)
    report["step_mono"] = kern
    main_launches = {"step_mono": 0, "sort_material": 0,
                     "sort_redistribute": 0}
    by_path = {}
    add_launches(main_launches, by_path, "evaluate mono",
                 {"step_mono": eval_launches})
    add_launches(main_launches, by_path, "fused-policy rollout",
                 {"step_mono": rollout_launches})
    max_err_k2 = max_err_k3 = 0

    # ---- 6. the sort kernels on the card ---------------------------------
    t0 = time.perf_counter()
    cfgs6 = {"default": cfgs["default"], "noise_0.05": cfgs["noise_0.05"],
             "support_40": sweep_configs()["support_40"]}
    designs3 = {}
    for cname, c in cfgs6.items():
        support = TB._support_for(c)
        designs3[support] = mvhg_cuda.lanes_for(support, 4096)
        for steps in (5, c.max_steps - 2):
            st = TB.reset_batch(c, 13, 4096, device=dev)
            # phase 3 holds kernel 1 at support 16; here at support 40 too
            st_p = st if support != 16 else None
            for _ in range(steps):
                st, out = step_cuda.step_mono_kernel(
                    c, st, None, variant="rule", autoreset=True)
                if st_p is not None:
                    st_p, out_p = no_launch(step_cuda.step_mono_plain, c,
                                            st_p, None, variant="rule",
                                            autoreset=True)
            if st_p is not None:
                states_equal(st, st_p, (out, out_p),
                             f"phase 6: step_mono "
                             f"{step_cuda.lanes_for(support, 4096)} != plain, "
                             f"{cname}, after {steps} rule steps")
            counts, acc, keys = st.belt_counts, st.acc_belt, st.key
            k2 = sort_cuda.sort_material_kernel(counts, acc, keys, support)
            p2 = no_launch(sort_cuda.sort_material_plain, counts, acc, keys,
                           support)
            us, _ = no_launch(TB._sort_uniforms, keys)
            k3 = mvhg_cuda.sort_redistribute_kernel(
                counts.T.contiguous(), acc.T.contiguous(), us.T.contiguous(),
                support)
            p3 = no_launch(TB.redistribute_u, counts, acc, us, support)
            tag = f"{cname}, after {steps} rule steps"
            for nm, x, y in zip(("leftover", "true", "false", "keys"), k2, p2):
                if not torch.equal(x, y):
                    raise AssertionError(f"kernel 2 != plain: {nm}, {tag}")
                max_err_k2 = max(max_err_k2, int((x - y).abs().max()))
            for nm, x, y, z in zip(("leftover", "true", "false"), k3, p3, k2):
                if not torch.equal(x, y.T):
                    raise AssertionError(f"kernel 3 != plain: {nm}, {tag}")
                if not torch.equal(x, z.T):
                    raise AssertionError(f"kernel 3 != kernel 2: {nm}, {tag}")
                max_err_k3 = max(max_err_k3, int((x - y.T).abs().max()))
    torch.cuda.synchronize()
    print(f"phase 6: kernel 2 (sort_material) == sort_material_plain and "
          f"kernel 3 (sort_redistribute) == redistribute_u, bitwise, and "
          f"kernel 2 == kernel 3 on the same uniforms: default, noise-0.05 "
          f"and support-40 configs, states after 5 and max_steps - 2 rule "
          f"steps, 4096 envs, kernel 3 in the designs {designs3} by support; "
          f"kernel 1 == step_mono_plain on the support-40 steps; "
          f"the plain versions launched no kernel "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- 7. the frozen-sort press step on the card -----------------------
    t0 = time.perf_counter()
    sort_agent = mlp.load_npz(str(SORT_NPZ), device=dev).requires_grad_(False)
    for n in AB_WIDTHS:
        frozen_press_ab(cfg, sort_agent, gen, dev, n)
    torch.cuda.synchronize()
    print(f"phase 7: frozen-sort press step (tuned sort agent), kernel-2 path "
          f"== plain path, bitwise in every leaf and output, 24 masked and 24 "
          f"unmasked autoreset steps at {AB_WIDTHS} envs from step "
          f"{cfg.max_steps - 12}, across the reset; kernel 2 once per step, "
          f"kernel 1 never ({time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- 8. PPO training at full width -----------------------------------
    pcfg = ppo.PPOConfig(n_steps=64, batch_size=16384, n_epochs=4,
                         shuffle_block=128)
    n_train = 4096
    report["train"] = {}
    for name, sp in (("mono", None), ("press", sort_agent)):
        t0 = time.perf_counter()
        spec = ppo.spec_for(name, engine="fastb")
        ts = ppo.init_train_state(cfg, pcfg, spec, n_train, seed=0,
                                  device=dev)
        p0 = [p.detach().clone() for p in ts.params.parameters()]
        it = ppo.make_train_iteration(cfg, pcfg, spec, sort_policy=sp)
        step_fn = spec.step_fn(sp, True)
        zero_counts()
        ts, stats = it(ts)                                  # warm-up
        rows = []
        for _ in range(3):
            e0, e1, e2 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(3))
            e0.record()
            ts, trs, last_value = ppo.collect_rollout(cfg, pcfg, spec, ts,
                                                      step_fn, True)
            e1.record()
            adv, ret = ppo.compute_gae(pcfg, trs, last_value)
            ts, stats = ppo.ppo_update(pcfg, ts, trs, adv, ret)
            e2.record()
            torch.cuda.synchronize()
            loss = float(stats["loss"])
            if not np.isfinite(loss):
                raise AssertionError(f"{name}: loss {loss}")
            rows.append((e0.elapsed_time(e1), e1.elapsed_time(e2), loss))
        counts = launch_counts()
        per_it = {k: v / 4 for k, v in counts.items()}
        want = ({"step_mono": 64, "sort_material": 0} if name == "mono"
                else {"step_mono": 0, "sort_material": 64})
        if any(per_it[k] != v for k, v in want.items()):
            raise AssertionError(f"{name} training launches per iteration "
                                 f"{per_it}, expected {want}")
        add_launches(main_launches, by_path, f"train {name}", counts)
        moved = sum(float((p.detach() - q).abs().sum())
                    for p, q in zip(ts.params.parameters(), p0))
        if not moved > 0:
            raise AssertionError(f"{name}: the parameters did not change")
        roll_ms = float(np.mean([r[0] for r in rows]))
        upd_ms = float(np.mean([r[1] for r in rows]))
        rate = n_train * pcfg.n_steps / ((roll_ms + upd_ms) / 1e3)
        # where the time goes: one more iteration under the profiler
        (ts, stats), wall_us, busy, by_kernel, _ = profile_busy(
            lambda: it(ts))
        report["train"][name] = {
            "n_envs": n_train, "n_steps": pcfg.n_steps,
            "batch_size": pcfg.batch_size, "n_epochs": pcfg.n_epochs,
            "shuffle_block": pcfg.shuffle_block,
            "rollout_ms": [r[0] for r in rows],
            "update_ms": [r[1] for r in rows],
            "loss": [r[2] for r in rows], "samples_per_s": rate,
            "launches_per_iteration": per_it, "param_abs_change": moved,
            "profiled_iteration_wall_ms": wall_us / 1e3,
            "device_busy_share": busy,
            "device_ms_by_kernel": {k: t / 1e3 for k, t in by_kernel[:12]}}
        print(f"phase 8: train {name} at {n_train} envs (n_steps 64, "
              f"minibatch 16384, 4 epochs, shuffle block 128"
              f"{', frozen tuned sort agent' if sp is not None else ''}): "
              f"{rate:.1f} samples/s; rollout {roll_ms:.3f} ms, update "
              f"{upd_ms:.3f} ms per iteration (CUDA events, mean of 3 after "
              f"1 warm-up); launches per iteration: kernel 1 "
              f"{per_it['step_mono']:g}, kernel 2 {per_it['sort_material']:g}; "
              f"losses {[round(r[2], 6) for r in rows]}; parameters moved "
              f"{moved:.6f} (sum |d|); profiled iteration {wall_us / 1e3:.1f} "
              f"ms wall, device busy {busy:.3f}; top device time: "
              + ", ".join(f"{k[:36]} {t / 1e3:.2f} ms"
                          for k, t in by_kernel[:4])
              + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    # ---- 9. the flow: run_training_flow at the CLI's defaults ------------
    report["flow"], train_l, bench_l = phase_flow(dev)
    add_launches(main_launches, by_path, "run_training_flow, training",
                 train_l)
    add_launches(main_launches, by_path,
                 "run_training_flow, closing benchmark", bench_l)

    # ---- 10. the sort kernels alone, beside their bounds -----------------
    support = TB._support_for(cfg)
    sk = {"sort_material": {}, "sort_redistribute": {}}
    for n in (4096, 65536):
        st = TB.reset_batch(cfg, 19, n, device=dev)
        for _ in range(30):
            st, _ = step_cuda.step_mono_kernel(cfg, st, None, variant="rule",
                                               autoreset=True)
        counts_, acc, keys = st.belt_counts, st.acc_belt, st.key
        us, _ = TB._sort_uniforms(keys)
        c3, a3, u3 = (x.T.contiguous() for x in (counts_, acc, us))
        # kernel 3 is on no main path: this run is the one that launches it
        if n == 4096:
            zero_counts()
        k3_out = mvhg_cuda.sort_redistribute(c3, a3, u3, support)
        if n == 4096:
            add_launches(main_launches, by_path, "kernel 3's own phase",
                         launch_counts())
        out_names = {"sort_material": ("leftover", "true", "false", "keys"),
                     "sort_redistribute": ("leftover", "true", "false")}
        cases_k = {
            "sort_material": (
                lambda: sort_cuda.sort_material_kernel(counts_, acc, keys,
                                                       support),
                lambda: no_launch(sort_cuda.sort_material_plain, counts_,
                                  acc, keys, support),
                sort_bound(support, n), sort_cuda.lanes_for(support, n)),
            "sort_redistribute": (
                lambda: mvhg_cuda.sort_redistribute_kernel(c3, a3, u3,
                                                           support),
                lambda: no_launch(mvhg_cuda.sort_redistribute_plain, c3, a3,
                                  u3, support),
                redistribute_bound(support, n),
                mvhg_cuda.lanes_for(support, n))}
        for kname, (launch, plain, b, design) in cases_k.items():
            _outputs_equal(f"phase 10: {kname} at {n} envs",
                           out_names[kname], launch(), plain())
            wall_ms = cuda_ms(launch, 200)
            dev_us = profile_device_us(launch, 100, f"{kname}_kernel")
            plain_ms = cuda_ms(plain, 20)
            sk[kname][n] = {"ms": dev_us / 1e3, "wall_ms_per_launch": wall_ms,
                            "plain_ms": plain_ms, "design": list(design), **b}
            print(f"{kname} kernel at {n} envs, design {design}: "
                  f"{dev_us:.3f} us per launch "
                  f"(profiler device time; {wall_ms * 1e3:.3f} us with the "
                  f"wrapper), plain {plain_ms:.3f} ms, bound "
                  f"{b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}; bytes "
                  f"{b['bytes_ms'] * 1e3:.3f} us, operations "
                  f"{b['ops_ms'] * 1e3:.3f} us)", flush=True)
        del k3_out
    report.update(sk)

    # ---- 11. every design of the three kernels, in one call ---------------
    t0 = time.perf_counter()
    report["design_sweep"] = full_sweep(dev, gen, MAIN_SWEEP_WIDTHS)
    print(f"phase 11: design sweep of kernels 1, 2 and 3 at "
          f"{MAIN_SWEEP_WIDTHS} "
          f"envs, supports 16, 32, 40 and 88, and kernel 3 at 128, each "
          f"design == plain bitwise ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    # ---- 12-15. the slice's paths: full-bale mode, the model and random ----
    # ---- steps, the fast engine, the engine benchmark -----------------------
    # the runs of phases 12 and 13 go to spawned worker processes, one
    # thread each: their CPU path in four, their card side in three, while
    # this process checks phases 14a and 15a; the timings of 14b and 15b
    # wait until the workers have ended
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing as mp
    from marl_sortingenv_tpu_torch.core import fast as FE
    from marl_sortingenv_tpu_torch.eval import harness
    n_slice, steps_slice = 4096, 200
    jobs = slice_jobs(n_slice, steps_slice)
    slice_report = {"full_mode": {}, "model_random": {}}
    t0 = time.perf_counter()
    # the card's side runs in three worker processes too: each run is
    # host-bound (one Python thread issuing small kernels, the device idle
    # most of the time), so runs side by side share the card well
    spawn = mp.get_context("spawn")
    with ProcessPoolExecutor(4, mp_context=spawn) as cpu_pool, \
            ProcessPoolExecutor(3, mp_context=spawn) as card_pool:
        cpu_futures = [cpu_pool.submit(cpu_trajectory, job) for job in jobs]
        card_futures = [card_pool.submit(card_trajectory, job)
                        for job in jobs]

        # ---- 14a. the fast engine == fastb in full mode on the card ------
        t1 = time.perf_counter()
        cfg_d = load_config()
        cfg_f = load_config(bale_mode="full")
        agents = load_agents(("sort", "press", "mono"), dev)
        st_v = FE.reset_batch(cfg_d, 47, n_slice, device=dev)
        st_b = TB.reset_batch(cfg_f, 47, n_slice, device=dev)
        f_v = FE.with_autoreset(cfg_d, lambda c, s, a: (
            FE.step_mono_external(c, s, a, True)))
        f_b = TB.mono_autoreset_step(cfg_f, "external", True)
        before = launch_counts()
        for t in range(steps_slice):
            a = torch.randint(0, 22, (n_slice,), generator=gen,
                              dtype=torch.int32).to(dev)
            st_v, o_v = f_v(st_v, a)
            st_b, o_b = f_b(st_b, a)
            states_equal(TB.from_batch_first(st_v), st_b, (o_v, o_b),
                         f"fast == fastb full, step {t}")
        used = {k: v - before[k] for k, v in launch_counts().items()}
        if used != {"step_mono": 0, "sort_material": 2 * steps_slice,
                    "sort_redistribute": 0}:
            raise AssertionError(f"fast vs fastb: launches {used}")
        add_launches(main_launches, by_path, "fast vs fastb", used)
        print(f"phase 14: fast engine == fastb in full mode on the card, "
              f"bitwise in every leaf and output, masked external, "
              f"{n_slice} envs x {steps_slice} autoreset steps; kernel 2 "
              f"once per step each, kernel 1 never "
              f"({time.perf_counter() - t1:.1f} s)", flush=True)

        # ---- 15a. the engine benchmark against the JAX values ------------
        t1 = time.perf_counter()
        bench = {}
        # fastb's Random, Sort-Only and Modular steps replay CUDA graphs,
        # captured at their first call: two steps capture them here, so
        # that the counted run only replays (a capture's warm-up step
        # launches kernel 2 once more)
        harness.run_engine_benchmark(cfg_d, "fastb", 10, 2, *agents,
                                     device=dev)
        for engine in ("fastb", "fast"):
            before = launch_counts()
            graphs = TB.GRAPH_CAPTURES, TB.GRAPH_REPLAYS
            res = harness.run_engine_benchmark(
                cfg_d, engine, 10, 200, *agents, device=dev)
            used = {k: v - before[k] for k, v in launch_counts().items()}
            # kernel 1 carries Rule-Based and Monolith on fastb (events
            # mode); every other step is eager with kernel 2, replayed
            # from a graph on fastb
            want = ({"step_mono": 400, "sort_material": 600}
                    if engine == "fastb" else
                    {"step_mono": 0, "sort_material": 1000})
            if any(used[k] != v for k, v in want.items()):
                raise AssertionError(f"engine benchmark ({engine}) launched "
                                     f"{used}, expected {want}")
            replayed = (TB.GRAPH_CAPTURES - graphs[0],
                        TB.GRAPH_REPLAYS - graphs[1])
            if replayed != ((0, 600) if engine == "fastb" else (0, 0)):
                raise AssertionError(f"engine benchmark ({engine}): "
                                     f"(captures, replays) {replayed}")
            print(f"phase 15: engine benchmark {engine}, 10 episodes: "
                  f"launches {used}, graphs (captured, replayed) "
                  f"{replayed}", flush=True)
            add_launches(main_launches, by_path,
                         "engine benchmark, 10 episodes", used)
            rows = {}
            for key, ref in BENCH_JAX.items():
                diff = res[key]["mean"] - ref
                ties = (diagnose_bench_miss(cfg_d, key, engine,
                                            ("sort", "press", "mono"), dev)
                        if abs(diff) > BENCH_TOL else [])
                rows[key] = {**res[key], "jax_mean": ref, "diff": diff,
                             "near_ties": ties}
                print(f"phase 15: engine benchmark {engine} {key}: mean "
                      f"{res[key]['mean']!r} std {res[key]['std']!r}, JAX "
                      f"{ref!r}, diff {diff:.3e}"
                      + (f" > {BENCH_TOL}: near-ties {ties}" if ties else
                         f" within {BENCH_TOL}"), flush=True)
            bench[engine] = {"policies": rows, "launches": used,
                             "graphs_captured_replayed": replayed}
        slice_report["bench_10x200"] = bench
        print(f"phase 15: 10 episodes x 200 steps on both engines "
              f"({time.perf_counter() - t1:.1f} s)", flush=True)

        # ---- 12/13. the card's runs, then the card against the CPU -------
        t1 = time.perf_counter()
        for job, card_fut, cpu_fut in zip(jobs, card_futures, cpu_futures):
            tag, rec_g, st_g, used, secs = card_fut.result()
            full = job[1] in TB.VARIANTS
            add_launches(main_launches, by_path,
                         "full-bale mode" if full else "model/random steps",
                         used)
            print(f"phase {12 if full else 13}: {tag}: kernel-2 path == "
                  f"plain path, bitwise, {n_slice} envs x {steps_slice} "
                  f"autoreset steps; kernel 2 once per step, the plain path "
                  f"no launch"
                  + ("; events mode (kernel 1) == full mode in every "
                     "non-bale leaf and output, events_to_full == the "
                     "full-mode state at steps 100 and 198" if full else "")
                  + f"; launches {used} ({secs:.1f} s in its worker)",
                  flush=True)
            _, rec_c, st_c = cpu_fut.result()
            ties, kept = match_cpu(tag, rec_g, rec_c, st_g, st_c)
            part = "full_mode" if tag.startswith("full") else "model_random"
            slice_report[part][tag] = {"near_ties": ties, "envs_kept": kept}
            print(f"phase {12 if part == 'full_mode' else 13}: {tag}: card "
                  f"== CPU path over {steps_slice} steps (state and outputs "
                  f"bitwise, the tanh'd rewards to 4 ulp): {len(ties)} "
                  f"near-ties {ties}, {kept} of {n_slice} envs held to the "
                  f"end", flush=True)
    print(f"phases 12-15a: {time.perf_counter() - t0:.1f} s (phases 14a "
          f"and 15a ran beside the workers, then waited "
          f"{time.perf_counter() - t1:.1f} s for them)", flush=True)

    # ---- 14b. a PPO iteration on the fast engine ---------------------------
    t1 = time.perf_counter()
    spec = ppo.spec_for("mono", engine="fast")
    ts = ppo.init_train_state(cfg_d, pcfg, spec, n_train, seed=0, device=dev)
    it = ppo.make_train_iteration(cfg_d, pcfg, spec)
    step_fn = spec.step_fn(None, True)
    zero_counts()
    ts, stats = it(ts)                                      # warm-up
    rows = []
    for _ in range(3):
        e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        ts, trs, last_value = ppo.collect_rollout(cfg_d, pcfg, spec, ts,
                                                  step_fn, True)
        e1.record()
        adv, ret = ppo.compute_gae(pcfg, trs, last_value)
        ts, stats = ppo.ppo_update(pcfg, ts, trs, adv, ret)
        e2.record()
        torch.cuda.synchronize()
        if not np.isfinite(float(stats["loss"])):
            raise AssertionError(f"fast-engine training: loss {stats['loss']}")
        rows.append((e0.elapsed_time(e1), e1.elapsed_time(e2),
                     float(stats["loss"])))
    counts = launch_counts()
    per_it = {k: v / 4 for k, v in counts.items()}
    if per_it != {"step_mono": 0, "sort_material": 64,
                  "sort_redistribute": 0}:
        raise AssertionError(f"fast-engine training launches per iteration "
                             f"{per_it}")
    add_launches(main_launches, by_path, "train mono on fast", counts)
    roll_ms = float(np.mean([r[0] for r in rows]))
    upd_ms = float(np.mean([r[1] for r in rows]))
    rate = n_train * pcfg.n_steps / ((roll_ms + upd_ms) / 1e3)
    slice_report["train_fast_mono"] = {
        "n_envs": n_train, "rollout_ms": [r[0] for r in rows],
        "update_ms": [r[1] for r in rows], "loss": [r[2] for r in rows],
        "samples_per_s": rate, "launches_per_iteration": per_it}
    print(f"phase 14: train mono on the fast engine at {n_train} envs "
          f"(n_steps 64, minibatch 16384, 4 epochs, shuffle block 128): "
          f"{rate:.1f} samples/s; rollout {roll_ms:.3f} ms, update "
          f"{upd_ms:.3f} ms per iteration (CUDA events, mean of 3 after 1 "
          f"warm-up); launches per iteration: kernel 2 "
          f"{per_it['sort_material']:g}, kernel 1 {per_it['step_mono']:g}; "
          f"losses {[round(r[2], 6) for r in rows]} "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)

    # ---- 15b. the engine benchmark at 4096 episodes ------------------------
    t1 = time.perf_counter()
    n_bench = 4096
    big = {}
    for key in harness.POLICY_KEYS:
        def run(steps, key=key):
            return harness.policy_totals(cfg_d, key, "fastb", n_bench,
                                         steps, *agents, device=dev)
        run(20)                                             # warm-up
        torch.cuda.synchronize()
        zero_counts()
        w0 = time.perf_counter()
        totals = run(200)
        wall = time.perf_counter() - w0
        used = launch_counts()
        kernel = ("step_mono" if key in ("Rule-Based", "PPO Monolith")
                  else "sort_material")
        if used[kernel] != 200 or sum(used.values()) != 200:
            raise AssertionError(f"engine benchmark {key} launched {used}")
        add_launches(main_launches, by_path,
                     "engine benchmark, 4096 episodes", used)
        if totals.shape != (n_bench,) or not np.isfinite(totals).all():
            raise AssertionError(f"engine benchmark {key}: bad totals")
        # the busy share of the first 20 steps (the profiler's own
        # bookkeeping of 200 eager steps takes minutes)
        _, prof_us, busy, by_kernel, n_kern = profile_busy(lambda: run(20))
        # a replayed step counts its kernel-2 launch from the capture:
        # the device has to run kernel 2 once in each replay
        seen = (profiled_launches(lambda: run(20), "sort_material_kernel")
                if key in harness.GRAPHED else None)
        if seen not in (None, 20):
            raise AssertionError(f"engine benchmark {key}: the profiler saw "
                                 f"kernel 2 {seen} times in 20 replays")
        big[key] = {"wall_s": wall, "env_steps_per_s": n_bench * 200 / wall,
                    "kernel2_in_20_replays": seen,
                    "mean": float(totals.mean()), "std": float(totals.std()),
                    "launches": used, "profiled_steps": 20,
                    "device_kernels_per_step": n_kern / 20,
                    "profiled_wall_s": prof_us / 1e6,
                    "device_busy_share": busy,
                    "device_ms_by_kernel": {k: t / 1e3
                                            for k, t in by_kernel[:8]}}
        print(f"phase 15: engine benchmark fastb {key}, {n_bench} episodes x "
              f"200 steps: {wall:.3f} s wall, "
              f"{n_bench * 200 / wall:.1f} env-steps/s, mean "
              f"{totals.mean():.6f} std {totals.std():.6f}; launches "
              f"{used}; device busy {busy:.3f} over 20 profiled steps "
              f"({prof_us / 1e6:.3f} s), {n_kern / 20:.1f} device kernels "
              f"per step; top device time: "
              + ", ".join(f"{k[:36]} {t / 1e3:.2f} ms"
                          for k, t in by_kernel[:3])
              + ("" if seen is None else
                 f"; graphed: kernel 2 seen {seen} times in 20 replays"),
              flush=True)
    slice_report["bench_4096x200_fastb"] = big
    report["slice"] = slice_report
    print(f"phase 15: {time.perf_counter() - t1:.1f} s", flush=True)

    # ---- 16. the bit-exact parity engine ------------------------------------
    report["parity"] = phase_parity(dev, agents, pcfg, n_train,
                                    parity_jobs(PARITY_N, PARITY_STEPS))
    add_launches(main_launches, by_path, "parity engine (16a-c)", {})

    # ---- 17. the Gymnasium drop-in envs, card against CPU -----------------
    report["envs"] = phase_envs(dev)
    add_launches(main_launches, by_path, "envs (17)", {})

    # ---- 18. the integer-exact engine, card against CPU and golden files ---
    report["exact"] = phase_exact(dev)
    add_launches(main_launches, by_path, "exact engine (18)", {})

    # ---- 19. data parallelism: the sharded iteration and press rollout ----
    report["sharded"] = phase_sharded(dev, main_launches, by_path)

    report["main_path_launches"] = main_launches
    report["launches_by_path"] = by_path
    for kname, v in main_launches.items():
        if v <= 0:
            raise AssertionError(f"{kname} was never launched on its path")
    report["seconds"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    k = kern[4096]
    k2, k3 = sk["sort_material"][4096], sk["sort_redistribute"][4096]
    print(f"main-path launches: {main_launches}, by path: {by_path}; total "
          f"{report['seconds']:.1f} s", flush=True)

    def paths_of(kname):
        return {p: c[kname] for p, c in by_path.items() if c[kname]}
    print(gpu)
    print(json.dumps({"kernels": [
        {"name": "step_mono", "route": "cuda",
         "source": "marl_sortingenv_tpu_torch/csrc/step_mono.cu",
         "replaces": "marl_sortingenv_tpu/ops/step_pallas.py:636",
         "launches": main_launches["step_mono"],
         "launches_by_path": paths_of("step_mono"),
         "max_abs_err": max_err, "bitwise": True, "n_envs": 4096,
         "design": list(step_cuda.lanes_for(support, 4096)),
         "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": None},
        {"name": "sort_material", "route": "cuda",
         "source": "marl_sortingenv_tpu_torch/csrc/sort_material.cu",
         "replaces": "marl_sortingenv_tpu/ops/sort_pallas.py:257",
         "launches": main_launches["sort_material"],
         "launches_by_path": paths_of("sort_material"),
         "max_abs_err": max_err_k2, "bitwise": True, "n_envs": 4096,
         "design": list(sort_cuda.lanes_for(support, 4096)),
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None},
        {"name": "sort_redistribute", "route": "cuda",
         "source": "marl_sortingenv_tpu_torch/csrc/sort_redistribute.cu",
         "replaces": "marl_sortingenv_tpu/ops/mvhg_pallas.py:128",
         "launches": main_launches["sort_redistribute"],
         "launches_by_path": paths_of("sort_redistribute"),
         "launched_by": "its own phase (on no main path)",
         "max_abs_err": max_err_k3, "bitwise": True, "n_envs": 4096,
         "design": k3["design"], "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
