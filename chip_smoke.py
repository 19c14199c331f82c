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
that phase alone).  The
second-to-last line of standard output is a JSON ``kernels`` record; the
last line is ``{"ok": true, "device": ...}``.
Any failure raises and exits non-zero without those lines.  Without CUDA,
or without the port next to this file, it exits non-zero at once.  Details
go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

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
    """(fn's result, wall us, device busy share, device us by kernel) of
    one call of fn() under the profiler."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        p0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - p0) * 1e6
    # device-side events only: a CPU op's entry repeats the device time of
    # the kernels it launched
    kernels = sorted(
        ((e.key, e.self_device_time_total) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and e.self_device_time_total > 0), key=lambda kv: -kv[1])
    busy_us = sum(t for _, t in kernels)
    return out, wall_us, busy_us / wall_us, kernels


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def states_equal(a, b, outs=None, tag=""):
    from marl_sortingenv_tpu_torch.core import fastb as TB
    for nm, x, y in zip(TB.BState._fields, a, b):
        if x is None:
            assert y is None, nm
            continue
        if x.dtype != y.dtype or not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{tag}: state.{nm} differs")
    if outs is not None:
        for nm in TB.BStepOut._fields:
            x, y = getattr(outs[0], nm), getattr(outs[1], nm)
            if x.dtype != y.dtype or not torch.equal(x.cpu(), y.cpu()):
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


SWEEP_WIDTHS = (4096, 8192, 16384, 32768, 65536)


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


def full_sweep(dev, gen) -> dict:
    """The design sweep of every config, then kernel 3 at support 128."""
    report = {name: design_sweep(c, dev, gen)
              for name, c in sweep_configs().items()}
    report["redistribute_support_128"] = support_128_sweep(dev)
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
        # rule steps by the kernel up to 12 steps before the episode's end,
        # so the A/B starts with a filled event log and crosses a reset
        st0 = TB.reset_batch(cfg, 9, 4096, device=dev)
        for _ in range(cfg.max_steps - 12):
            st0, _ = step_cuda.step_mono_kernel(cfg, st0, None,
                                                variant="rule",
                                                autoreset=True)
        if int(st0.ev_cnt.max()) <= 0:
            raise AssertionError(f"{cname}: no press completed before the A/B")
        for variant, masked in cases:
            st_k = st_p = st0
            for t in range(24):
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
          f"{len(cases)} variants x 24 steps at 4096 envs, across an "
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
    spec = ppo.spec_for("mono")
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
        (st, obs), prof_wall_us, busy, kernels = profile_busy(
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
    main_launches = {"step_mono": eval_launches + rollout_launches,
                     "sort_material": 0, "sort_redistribute": 0}
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
        spec = ppo.spec_for(name)
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
        for k in main_launches:
            main_launches[k] += counts[k]
        moved = sum(float((p.detach() - q).abs().sum())
                    for p, q in zip(ts.params.parameters(), p0))
        if not moved > 0:
            raise AssertionError(f"{name}: the parameters did not change")
        roll_ms = float(np.mean([r[0] for r in rows]))
        upd_ms = float(np.mean([r[1] for r in rows]))
        rate = n_train * pcfg.n_steps / ((roll_ms + upd_ms) / 1e3)
        # where the time goes: one more iteration under the profiler
        (ts, stats), wall_us, busy, by_kernel = profile_busy(lambda: it(ts))
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
    for k in main_launches:
        main_launches[k] += counts[k]

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
            main_launches["sort_redistribute"] = launch_counts()[
                "sort_redistribute"]
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
    report["design_sweep"] = full_sweep(dev, gen)
    print(f"phase 11: design sweep of kernels 1, 2 and 3 at {SWEEP_WIDTHS} "
          f"envs, supports 16, 32, 40 and 88, and kernel 3 at 128, each "
          f"design == plain bitwise ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    report["main_path_launches"] = main_launches
    for kname, v in main_launches.items():
        if v <= 0:
            raise AssertionError(f"{kname} was never launched on its path")
    report["seconds"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    k = kern[4096]
    k2, k3 = sk["sort_material"][4096], sk["sort_redistribute"][4096]
    print(f"main-path launches: {main_launches}; total "
          f"{report['seconds']:.1f} s", flush=True)
    print(gpu)
    print(json.dumps({"kernels": [
        {"name": "step_mono", "route": "cuda",
         "source": "marl_sortingenv_tpu_torch/csrc/step_mono.cu",
         "replaces": "marl_sortingenv_tpu/ops/step_pallas.py:636",
         "launches": main_launches["step_mono"],
         "max_abs_err": max_err, "bitwise": True, "n_envs": 4096,
         "design": list(step_cuda.lanes_for(support, 4096)),
         "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": None},
        {"name": "sort_material", "route": "cuda",
         "source": "marl_sortingenv_tpu_torch/csrc/sort_material.cu",
         "replaces": "marl_sortingenv_tpu/ops/sort_pallas.py:257",
         "launches": main_launches["sort_material"],
         "max_abs_err": max_err_k2, "bitwise": True, "n_envs": 4096,
         "design": list(sort_cuda.lanes_for(support, 4096)),
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None},
        {"name": "sort_redistribute", "route": "cuda",
         "source": "marl_sortingenv_tpu_torch/csrc/sort_redistribute.cu",
         "replaces": "marl_sortingenv_tpu/ops/mvhg_pallas.py:128",
         "launches": main_launches["sort_redistribute"],
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
