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
minibatches of 16384, 4 epochs, shuffle blocks of 128); and the trainer's
sort -> press -> mono flow.  The sort kernels are timed alone beside their
bounds, and every design of the three kernels (a group of lanes per env,
``sort_cuda.DESIGNS`` and ``mvhg_cuda.REDISTRIBUTE_DESIGNS``) is held
bitwise against its plain version and timed from 4096 to 65536 envs at
supports 16, 32, 40 and 88, and kernel 3 also at 128 (``--sweep`` runs
that phase alone).  Then the paths that run the eager step with its
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
workers have ended.
The second-to-last line of standard output is a JSON
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
            raise AssertionError(f"design sweep: {tag}: {nm} differs")


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
                f"sort_material {d} at {n} envs",
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
            f"sort_redistribute {d} at {n} envs",
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
                top = torch.topk(logits, 2, dim=-1).values
                self.cur |= (top[:, 0] - top[:, 1]) <= ARGMAX_RTOL * top[
                    :, 0].abs().clamp(min=1.0)
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
    from marl_sortingenv_tpu_torch.eval import harness
    gens = {}
    for d in (dev, "cpu"):
        sp, pp, mp = load_agents(agents, d)
        gens[d] = harness.policy_steps(cfg, policy, engine, 10, 200, sp, pp,
                                       mp, True, 1, device=d)
    log = TieLog().install()
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
                top = torch.topk(logits, 2, dim=-1).values
                self.cur |= (top[:, 0] - top[:, 1]) <= ARGMAX_RTOL * top[
                    :, 0].abs().clamp(min=1.0)
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

    # ---- 1. the card ------------------------------------------------------
    gpu = gpu_line()
    print(gpu, flush=True)

    # ---- 2. build ---------------------------------------------------------
    from marl_sortingenv_tpu_torch.config.config import load_config
    from marl_sortingenv_tpu_torch.core import fastb as TB
    from marl_sortingenv_tpu_torch.learn import ppo, trainer
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
    cases = [("rule", True), ("external", True), ("external", False),
             ("sort", True), ("press", True), ("press", False)]
    n_act = {"rule": 22, "external": 22, "sort": 2, "press": 11}
    cfgs = {
        "default": load_config(bale_mode="events"),
        "noise_0.05": load_config(bale_mode="events", noise_sorting=0.05),
        "press_completion": load_config(bale_mode="events", max_steps=24,
                                        press_time_1=1, press_time_2=2,
                                        balesize=16),
    }
    max_err = 0.0
    gen = torch.Generator(device="cpu").manual_seed(31)
    for cname, cfg in cfgs.items():
        # rule steps by the kernel up to 6 steps before the episode's end,
        # so the A/B starts with a filled event log and crosses a reset
        st0 = TB.reset_batch(cfg, 9, 4096, device=dev)
        for _ in range(cfg.max_steps - 6):
            st0, _ = step_cuda.step_mono_kernel(cfg, st0, None,
                                                variant="rule",
                                                autoreset=True)
        if int(st0.ev_cnt.max()) <= 0:
            raise AssertionError(f"{cname}: no press completed before the A/B")
        for variant, masked in cases:
            st_k = st_p = st0
            for t in range(12):
                a = torch.randint(0, n_act[variant], (4096,), generator=gen,
                                  dtype=torch.int32).to(dev)
                a = None if variant == "rule" else a
                st_k, o_k = step_cuda.step_mono_kernel(
                    cfg, st_k, a, variant=variant, masked=masked,
                    autoreset=True)
                st_p, o_p = no_launch(
                    step_cuda.step_mono_plain, cfg, st_p, a,
                    variant=variant, masked=masked, autoreset=True)
                states_equal(st_k, st_p, (o_k, o_p),
                             f"{cname} {variant} masked={masked} step {t}")
                max_err = max(max_err, float(
                    (o_k.reward - o_p.reward).abs().max()))
    torch.cuda.synchronize()
    print(f"phase 3: kernel == plain on the card, bitwise, 3 configs x "
          f"{len(cases)} variants x 12 steps at 4096 envs, across an "
          f"episode's end; the plain version launched no kernel "
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
    st0 = TB.reset_batch(cfg, 17, 4096, device=dev)
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
            a = torch.randint(0, 11, (4096,), generator=gen,
                              dtype=torch.int32).to(dev)
            before = launch_counts()
            st_k, o_k = step_k(st_k, a)
            d = {k: v - before[k] for k, v in launch_counts().items()}
            if d != {"step_mono": 0, "sort_material": 1,
                     "sort_redistribute": 0}:
                raise AssertionError(f"frozen-sort press step {t}: launches {d}")
            st_p, o_p = no_launch(step_p, st_p, a)
            states_equal(st_k, st_p, (o_k, o_p),
                         f"frozen-sort press masked={masked} step {t}")
            crossed |= bool(o_k.terminated.any())
        if not crossed:
            raise AssertionError("the frozen-sort A/B crossed no reset")
    torch.cuda.synchronize()
    print(f"phase 7: frozen-sort press step (tuned sort agent), kernel-2 path "
          f"== plain path, bitwise in every leaf and output, 24 masked and 24 "
          f"unmasked autoreset steps at 4096 envs from step "
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

    # ---- 9. the trainer's flow: sort -> press (frozen sort) -> mono -------
    flow_total = 2 * pcfg.n_steps * n_train
    report["flow"] = {}
    sort_params = None
    models_dir = str(ROOT / "build" / "chip_smoke_models")
    zero_counts()
    for name in ("sort", "press", "mono"):
        t0 = time.perf_counter()
        res = trainer.train_agent(
            cfg, name, flow_total, n_envs=n_train,
            sort_params=sort_params if name == "press" else None,
            eval_freq=10 * flow_total, eval_envs=n_train,
            models_dir=models_dir, save_prefix=f"PPO_{name}_chip",
            pcfg=pcfg, verbose=False, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if name == "sort":
            sort_params = res.params
        if len(res.history) != 2 or not all(
                np.isfinite(h["loss"]) for h in res.history) or not \
                np.isfinite(res.final_eval_mean):
            raise AssertionError(f"flow stage {name}: {res.history}, "
                                 f"{res.final_eval_mean}")
        report["flow"][name] = {
            "seconds": wall, "final_eval_mean": res.final_eval_mean,
            "final_eval_std": res.final_eval_std,
            "losses": [h["loss"] for h in res.history]}
        print(f"phase 9: train_agent {name} at {n_train} envs, 2 iterations, "
              f"final eval over {n_train} envs x {cfg.max_steps} steps: "
              f"{res.final_eval_mean:.6f} +- {res.final_eval_std:.6f}, "
              f"{wall:.1f} s", flush=True)
    counts = launch_counts()
    if counts["step_mono"] <= 0 or counts["sort_material"] <= 0:
        raise AssertionError(f"the flow launched {counts}")
    report["flow"]["launches"] = counts
    add_launches(main_launches, by_path, "train_agent flow", counts)

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
        for engine in ("fastb", "fast"):
            before = launch_counts()
            res = harness.run_engine_benchmark(
                cfg_d, engine, 10, 200, *agents, device=dev)
            used = {k: v - before[k] for k, v in launch_counts().items()}
            # kernel 1 carries Rule-Based and Monolith on fastb (events
            # mode); every other step is eager with kernel 2
            want = ({"step_mono": 400, "sort_material": 600}
                    if engine == "fastb" else
                    {"step_mono": 0, "sort_material": 1000})
            if any(used[k] != v for k, v in want.items()):
                raise AssertionError(f"engine benchmark ({engine}) launched "
                                     f"{used}, expected {want}")
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
            bench[engine] = {"policies": rows, "launches": used}
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
        big[key] = {"wall_s": wall, "env_steps_per_s": n_bench * 200 / wall,
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
                          for k, t in by_kernel[:3]), flush=True)
    slice_report["bench_4096x200_fastb"] = big
    report["slice"] = slice_report
    print(f"phase 15: {time.perf_counter() - t1:.1f} s", flush=True)

    # ---- 16. the bit-exact parity engine ------------------------------------
    report["parity"] = phase_parity(dev, agents, pcfg, n_train,
                                    parity_jobs(PARITY_N, PARITY_STEPS))
    add_launches(main_launches, by_path, "parity engine (16a-c)", {})

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
