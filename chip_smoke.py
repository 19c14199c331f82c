"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``marl_sortingenv_tpu_torch/csrc``,
holds each kernel bitwise against its plain PyTorch version on the card,
holds the CUDA path bitwise against the CPU path, drives the port's main
path (policy evaluation and the fused-policy autoreset rollout at 4096 and
65536 envs) and times it.  The second-to-last line of standard output is a
JSON ``kernels`` record; the last line is ``{"ok": true, "device": ...}``.
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

import torch

ROOT = Path(__file__).resolve().parent
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

    # ---- 1. the card ------------------------------------------------------
    gpu = gpu_line()
    print(gpu, flush=True)

    # ---- 2. build ---------------------------------------------------------
    from marl_sortingenv_tpu_torch.config.config import load_config
    from marl_sortingenv_tpu_torch.core import fastb as TB
    from marl_sortingenv_tpu_torch.learn import ppo
    from marl_sortingenv_tpu_torch.models import mlp
    from marl_sortingenv_tpu_torch.ops import _build, step_cuda

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
                st_p, o_p = step_cuda.step_mono_plain(
                    cfg, st_p, a, variant=variant, masked=masked,
                    autoreset=True)
                states_equal(st_k, st_p, (o_k, o_p),
                             f"{cname} {variant} masked={masked} step {t}")
                max_err = max(max_err, float(
                    (o_k.reward - o_p.reward).abs().max()))
    torch.cuda.synchronize()
    print(f"phase 3: kernel == plain on the card, bitwise, 3 configs x "
          f"{len(cases)} variants x 24 steps at 4096 envs, across an "
          f"episode's end ({time.perf_counter() - t0:.1f} s)", flush=True)

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

    step_cuda.LAUNCHES = 0
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
        step_cuda.LAUNCHES = 0
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
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            p0 = time.perf_counter()
            st, obs = rollout(st, obs, 50)
            torch.cuda.synchronize()
            prof_wall_us = (time.perf_counter() - p0) * 1e6
        # device-side events only: a CPU op's entry repeats the device
        # time of the kernels it launched
        kernels = sorted(
            ((e.key, e.self_device_time_total) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.self_device_time_total > 0), key=lambda kv: -kv[1])
        busy_us = sum(t for _, t in kernels)
        print(f"  profile of 50 steps at {n} envs: device busy "
              f"{busy_us / prof_wall_us:.3f} of {prof_wall_us / 50:.1f} us "
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
                st_p, o_p = step_cuda.step_mono_plain(
                    cfg, st_p, a, variant="external", masked=True,
                    autoreset=True)
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
            "device_busy_share": busy_us / prof_wall_us,
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
            return step_cuda.step_mono_plain(
                cfg, st, a, variant="external", masked=True, autoreset=True)

        wall_ms = cuda_ms(launch, 200)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(100):
                launch()
            torch.cuda.synchronize()
        dev_us = [e.device_time_total / e.count
                  for e in prof.key_averages() if "step_mono_kernel" in e.key]
        if not dev_us:
            raise AssertionError("the profiler saw no step_mono_kernel")
        plain_ms = cuda_ms(plain, 20)
        n_bytes = sum(x.numel() * x.element_size()
                      for x in (*[getattr(st, nm) for nm in
                                  step_cuda.IN_NAMES], a))
        out_st, out = launch()
        n_bytes += sum(x.numel() * x.element_size() for x in out_st
                       if x is not None)
        n_bytes += sum(out[k].numel() * out[k].element_size()
                       for k in (0, 2, 3, 6))    # obs, terminated, action, purity
        n_bytes += 2 * 4 * n                     # raw sort arg, press reward
        n_reset = int((st.current_step + 1 >= cfg.max_steps).sum())
        int_ops, f32_ops = step_ops(cfg, "external", TB._support_for(cfg),
                                    n, n_reset)
        # bytes, integer and f32 work run on separate units at once: the
        # bound is the largest of the three times
        t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
        t_ops = max(int_ops / H100_INT32_PER_S, f32_ops / H100_F32_PER_S) * 1e3
        kern[n] = {
            "ms": dev_us[0] / 1e3, "wall_ms_per_launch": wall_ms,
            "plain_ms": plain_ms, "bytes": n_bytes, "int_ops": int_ops,
            "f32_ops": f32_ops, "envs_reset": n_reset,
            "bytes_ms": t_bytes, "ops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print(f"step_mono kernel at {n} envs: {kern[n]['ms'] * 1e3:.3f} us "
              f"per launch (profiler device time; {wall_ms * 1e3:.3f} us "
              f"per launch with the wrapper), plain path {plain_ms:.3f} ms "
              f"per step, bound {kern[n]['bound_ms'] * 1e3:.3f} us "
              f"({kern[n]['bound_by']}; bytes {t_bytes * 1e3:.3f} us, "
              f"operations {t_ops * 1e3:.3f} us)", flush=True)
    report["step_mono"] = kern
    report["seconds"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    k = kern[4096]
    print(json.dumps({"kernels": [{
        "name": "step_mono", "route": "cuda",
        "source": "marl_sortingenv_tpu_torch/csrc/step_mono.cu",
        "replaces": "marl_sortingenv_tpu/ops/step_pallas.py:636",
        "launches": eval_launches + rollout_launches,
        "max_abs_err": max_err, "bitwise": True, "n_envs": 4096,
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
