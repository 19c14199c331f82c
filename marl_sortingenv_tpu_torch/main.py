"""Experiment orchestration CLI — the reference ``main.py`` equivalent
(``run_sim``, ``run_training_flow``, ``create_environment``,
``train_agent``; reference main.py:28-263), with argparse flags instead
of edit-the-file constants.

The port of ``marl_sortingenv_tpu.main``, with the same flags and
defaults and one more, ``--device`` (``cuda`` unless ``cpu`` is asked
for).  The env analysis and the benchmark figure need matplotlib.

Usage:
    python -m marl_sortingenv_tpu_torch.main --env-analysis
    python -m marl_sortingenv_tpu_torch.main --train-and-benchmark \
        --timesteps 100000 --n-envs 256 --engine fastb --device cuda
    python -m marl_sortingenv_tpu_torch.main --train-without-masking ...
"""

from __future__ import annotations

import argparse
import json
import os
from datetime import datetime

from . import resolve_device
from .config.config import load_config
from .eval import harness, plots
from .learn import trainer
from .utils.metrics import MetricsLogger


def create_environment(env_type: str, max_steps: int = 200, seed: int = 42,
                       noise_sorting: float = 0.0, balesize: int = 200,
                       device="cuda"):
    """Reference main.py:192-212 (host Gymnasium wrappers)."""
    from . import envs

    cls = {"Sorting": envs.Env_1_Sorting, "Pressing": envs.Env_2_Pressing,
           "Monolith": envs.Env_3_Monolith}[env_type]
    return cls(max_steps=max_steps, seed=seed, noise_sorting=noise_sorting,
               balesize=balesize, device=device)


def run_env_analysis(cfg, steps, seed, out_dir, tag, device="cuda"):
    """Reference main.py:84-105: random/rule-based episodes with and
    without masking, dashboards rendered."""
    print("\n--- Running Environment Analysis (Monolith) ---")
    results = {}
    for masking in (True, False):
        mtag = "Masking" if masking else "No Masking"
        for mode in ("random", "rule_based"):
            res = harness.run_episode(
                cfg, seed=seed, steps=steps, mode=mode,
                use_action_masking=masking,
                collect_series=(mode == "rule_based"),
                render=(mode == "rule_based"),
                render_kwargs={"save": True, "log_dir": out_dir,
                               "filename": f"{tag}_{mode}_"
                                           f"{'mask' if masking else 'nomask'}",
                               "fmt": "png"},
                device=device)
            results[f"{mode}/{mtag}"] = res.cumulative_reward
            print(f"  {mode:>10} ({mtag}): {res.cumulative_reward:9.2f}")
    return results


def run_sim(args) -> dict:
    device = resolve_device(args.device)
    cfg = load_config(args.config, max_steps=args.steps,
                      noise_sorting=args.noise_sorting,
                      balesize=args.balesize)
    tag = args.tag or f"Gold_{datetime.now().strftime('%d-%m-%Y_%H-%M')}"
    out: dict = {"tag": tag}

    print("\n--------------------------------")
    print("Starting Simulation... 🚀")
    print("--------------------------------")

    if args.env_analysis:
        out_dir = os.path.join(args.fig_dir, tag)
        os.makedirs(out_dir, exist_ok=True)
        out["env_analysis"] = run_env_analysis(
            cfg, args.steps, args.seed, out_dir, tag, device)

    for masked, flag in ((True, args.train_and_benchmark),
                         (False, args.train_without_masking)):
        if not flag:
            continue
        mtag = f"{tag}_{'Masked' if masked else 'NoMask'}"
        print(f"\n--- Training & Benchmark "
              f"{'WITH' if masked else 'WITHOUT'} Action Masking ---")
        logger = MetricsLogger(args.log_dir, mtag)
        flow = trainer.run_training_flow(
            cfg, use_action_masking=masked,
            total_timesteps=args.timesteps, n_envs=args.n_envs,
            seed=args.seed, engine=args.engine,
            bench_seeds=args.bench_seeds, steps_test=args.steps,
            models_dir=args.models_dir, logger=logger,
            tuned=args.tuned, ckpt_dir=args.ckpt_dir,
            resume=args.resume, device=device)
        logger.close()
        bench_dir = plots.make_benchmark_dir(
            os.path.join(args.fig_dir, "benchmarks"),
            prefix=f"benchmark_{mtag}")
        plots.plot_benchmark(flow["benchmark"], bench_dir, masked,
                             args.bench_seeds)
        with open(os.path.join(bench_dir, "summary.json"), "w") as f:
            json.dump(flow["benchmark"], f, indent=2)
        out[mtag] = flow["benchmark"]

    print("\n--------------------------------")
    print("Simulation Completed. 🌵")
    print("--------------------------------")
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--env-analysis", action="store_true")
    p.add_argument("--train-and-benchmark", action="store_true")
    p.add_argument("--train-without-masking", action="store_true")
    p.add_argument("--timesteps", type=int, default=100_000)  # main.py:48
    p.add_argument("--steps", type=int, default=200)          # main.py:49-50
    p.add_argument("--seed", type=int, default=42)            # main.py:51
    p.add_argument("--bench-seeds", type=int, default=10)     # main.py:52
    p.add_argument("--noise-sorting", type=float, default=0.0)  # main.py:42
    p.add_argument("--balesize", type=int, default=200)       # main.py:43
    p.add_argument("--n-envs", type=int, default=16)
    p.add_argument("--engine", choices=["fastb", "fast", "parity"],
                   default="fastb")
    p.add_argument("--tuned", action="store_true",
                   help="use the swept PPO preset (lr 1e-3, ent 0.01) instead of the reference-mirroring defaults")
    p.add_argument("--config", default=None, help="reference-format yml")
    p.add_argument("--tag", default=None)
    p.add_argument("--models-dir", default="./models")
    p.add_argument("--ckpt-dir", default=None,
                   help="directory for durable full-train-state "
                        "checkpoints (params + optimizer + env state + "
                        "RNG), written at every eval boundary")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint in --ckpt-dir and "
                        "continue; a resumed run's parameters are bitwise-"
                        "equal to an uninterrupted one")
    p.add_argument("--log-dir", default="./log")
    p.add_argument("--fig-dir", default="./img")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, or cpu)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not (args.env_analysis or args.train_and_benchmark
            or args.train_without_masking):
        args.env_analysis = True
    run_sim(args)


if __name__ == "__main__":
    main()
