"""Training orchestration — the port of ``marl_sortingenv_tpu.learn.trainer``
(``Train_Agent`` of the reference's ``src/training.py``), vectorized.

``train_agent`` trains one stage of the reference's modular flow: sort,
then press with the frozen sort agent in the env step, then mono.  It
keeps the SB3-behavioural pieces: periodic evaluation on a fixed-seed eval
env with best-checkpoint retention, a final evaluation, model saving with
``prev/`` rotation, and full-state checkpoints for a bitwise resume.
``run_training_flow`` runs the three stages and then the 5-policy
benchmark on the parity engine (``eval/harness.run_model_benchmark``).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np

from .. import resolve_device
from ..config.config import SimConfig
from ..eval import harness
from ..models import mlp
from ..utils import checkpoint as CK
from ..utils.metrics import MetricsLogger
from . import ppo


def _resume_tree(ts, best_eval, next_eval):
    """Template tree for full-run checkpoints (structure only)."""
    return {"ts": ts, "iter": 0, "best_eval": float(best_eval),
            "best_params": ts.params, "next_eval": int(next_eval)}


@dataclasses.dataclass
class TrainResult:
    params: mlp.ActorCritic
    final_eval_mean: float
    final_eval_std: float
    history: list


def train_agent(cfg: SimConfig, variant: str, total_timesteps: int,
                n_envs: int = 64, use_action_masking: bool = True,
                sort_params: Optional[mlp.ActorCritic] = None,
                seed: int = 42, engine: str = "fastb",
                eval_freq: int = 10_000, eval_envs: int = 10,
                models_dir: str = "./models",
                save_prefix: Optional[str] = None,
                pcfg: Optional[ppo.PPOConfig] = None,
                logger: Optional[MetricsLogger] = None,
                init_params: Optional[mlp.ActorCritic] = None,
                tuned: bool = False,
                ckpt_dir: Optional[str] = None,
                resume: bool = False,
                verbose: bool = True,
                device="cuda") -> TrainResult:
    """``Train_Agent`` equivalent.  ``variant``: 'sort' | 'press' | 'mono'.

    Only 'press' and 'mono' use action masks; with masking off their
    invalid actions go through the env step's sanitize path.  For 'press',
    ``sort_params`` is the frozen sort agent in the env step.

    ``ckpt_dir``: when set, the full train state and the best-checkpoint
    bookkeeping are checkpointed at every eval boundary (the 2 newest
    kept).  ``resume=True`` restores the latest one and continues; the
    iterations are deterministic functions of the train state, so a killed
    and resumed run ends with parameters bitwise equal to an uninterrupted
    one on the same device.  Pre-kill ``history`` entries are not replayed.
    """
    dev = resolve_device(device)
    spec = ppo.spec_for(variant, engine=engine)
    masking = use_action_masking and spec.use_mask

    if tuned and pcfg is not None:
        raise ValueError(
            "pass either tuned=True or an explicit pcfg, not both — "
            "tuned only selects the preset when pcfg is None")
    if pcfg is None:
        # SB3's cadence: 2048 samples per iteration, minibatches of 64
        n_steps = max(128, 2048 // max(1, n_envs))
        if tuned:
            pcfg = ppo.PPOConfig.tuned(n_steps=n_steps, batch_size=64)
        else:
            pcfg = ppo.PPOConfig(n_steps=n_steps, batch_size=64)

    sort_policy = None
    if variant == "press" and sort_params is not None:
        sort_policy = copy.deepcopy(sort_params).to(dev).requires_grad_(False)

    ts = ppo.init_train_state(cfg, pcfg, spec, n_envs=n_envs, seed=seed,
                              device=dev)
    if init_params is not None:
        # warm start with a fresh optimizer state
        ts = ts._replace(params=copy.deepcopy(init_params).to(dev))
    samples_per_iter = pcfg.n_steps * n_envs
    n_iters = max(1, total_timesteps // samples_per_iter)

    train_iteration = ppo.make_train_iteration(cfg, pcfg, spec, sort_policy,
                                               masking)

    best_eval = -np.inf
    best_params = ts.params
    history = []
    next_eval = eval_freq
    t0 = time.time()
    start_k = 0
    if resume and ckpt_dir:
        s = CK.latest_step(ckpt_dir)
        if s is not None:
            r = CK.restore_train_state(
                ckpt_dir, s, _resume_tree(ts, best_eval, next_eval))
            ts = r["ts"]
            start_k = int(r["iter"])
            best_eval = float(r["best_eval"])
            best_params = r["best_params"]
            next_eval = int(r["next_eval"])
            if verbose:
                print(f"  [{variant}] resumed from {ckpt_dir} step {s} "
                      f"(iteration {start_k}/{n_iters})")

    def evaluate(params):
        rets = ppo.evaluate(
            cfg, spec, params, n_envs=eval_envs, n_steps=cfg.max_steps,
            seed0=99, sort_policy=sort_policy, use_action_masking=masking,
            device=dev)
        return rets.cpu().numpy()

    for k in range(start_k + 1, n_iters + 1):
        ts, stats = train_iteration(ts)
        steps_done = k * samples_per_iter
        stats = ppo.stats_to_numpy(stats)
        history.append({"steps": steps_done,
                        **{kk: float(v) for kk, v in stats.items()}})
        if logger is not None:
            logger.log(steps_done, {f"train/{kk}": float(v)
                                    for kk, v in stats.items()})
        # evals and checkpoints land on the JAX trainer's iterations: the
        # first whose samples reach the threshold
        if steps_done >= next_eval:
            next_eval += eval_freq
            m = float(evaluate(ts.params).mean())
            if logger is not None:
                logger.log(steps_done, {"eval/mean_return": m})
            if m > best_eval:
                best_eval = m
                best_params = ts.params
                if save_prefix:
                    # durable best-so-far model: a run killed later still
                    # yields its best model
                    CK.save_model(best_params, f"{save_prefix}_best",
                                  steps_done, models_dir)
            if verbose:
                print(f"  [{variant}] {steps_done}/{total_timesteps} "
                      f"eval {m:.2f} (best {best_eval:.2f})")
            if ckpt_dir:
                CK.save_train_state(
                    ckpt_dir, steps_done,
                    {"ts": ts, "iter": k, "best_eval": best_eval,
                     "best_params": best_params, "next_eval": next_eval})
                CK.prune_train_states(ckpt_dir, keep=2)

    # final evaluation; keep the best checkpoint if better
    # (training.py:196-209)
    rets = evaluate(ts.params)
    final_mean, final_std = float(rets.mean()), float(rets.std())
    params = ts.params
    if best_eval > final_mean:
        rets_b = evaluate(best_params)
        if float(rets_b.mean()) > final_mean:
            params = best_params
            final_mean, final_std = float(rets_b.mean()), float(rets_b.std())
            if verbose:
                print("  using the best checkpoint")

    if save_prefix:
        CK.save_model(params, save_prefix, total_timesteps, models_dir)
    if verbose:
        print(f"  [{variant}] done in {time.time() - t0:.1f}s — final "
              f"{final_mean:.2f} ± {final_std:.2f}")
    return TrainResult(params, final_mean, final_std, history)


def run_training_flow(cfg: SimConfig, use_action_masking: bool,
                      total_timesteps: int = 100_000, n_envs: int = 16,
                      seed: int = 42, engine: str = "fastb",
                      bench_seeds: int = 10, steps_test: int = 200,
                      models_dir: str = "./models",
                      logger: Optional[MetricsLogger] = None,
                      tuned: bool = False,
                      ckpt_dir: Optional[str] = None,
                      resume: bool = False,
                      verbose: bool = True,
                      device="cuda") -> Dict:
    """The reference's main.py:137-185: sort -> press (frozen sort) ->
    mono -> benchmark.

    ``ckpt_dir``/``resume``: per-stage full-state checkpointing (see
    ``train_agent``) in ``<ckpt_dir>/<variant>_<Masked|NoMask>``.  A
    killed flow resumed with ``resume=True`` fast-forwards completed
    stages (their last checkpoint is at or near the final iteration, so
    the training loop re-runs at most the post-checkpoint tail) and
    continues the interrupted stage from its last eval boundary."""
    dev = resolve_device(device)
    tagm = "Masked" if use_action_masking else "NoMask"

    def stage_ckpt(variant):
        if ckpt_dir is None:
            return None
        return os.path.join(ckpt_dir, f"{variant}_{tagm}")

    if verbose:
        print(f"\n[1/3] Training Sorting Agent ({tagm})...")
    sort_res = train_agent(cfg, "sort", total_timesteps, n_envs,
                           use_action_masking, seed=seed, engine=engine,
                           models_dir=models_dir,
                           save_prefix=f"PPO_Sorting_{tagm}", logger=logger,
                           tuned=tuned, ckpt_dir=stage_ckpt("sort"),
                           resume=resume, verbose=verbose, device=dev)
    if verbose:
        print(f"\n[2/3] Training Pressing Agent ({tagm})...")
    press_res = train_agent(cfg, "press", total_timesteps, n_envs,
                            use_action_masking,
                            sort_params=sort_res.params, seed=seed,
                            engine=engine, models_dir=models_dir,
                            save_prefix=f"PPO_Pressing_{tagm}",
                            logger=logger, tuned=tuned,
                            ckpt_dir=stage_ckpt("press"), resume=resume,
                            verbose=verbose, device=dev)
    if verbose:
        print(f"\n[3/3] Training Monolith Agent ({tagm})...")
    mono_res = train_agent(cfg, "mono", total_timesteps, n_envs,
                           use_action_masking, seed=seed, engine=engine,
                           models_dir=models_dir,
                           save_prefix=f"PPO_Monolith_{tagm}", logger=logger,
                           tuned=tuned, ckpt_dir=stage_ckpt("mono"),
                           resume=resume, verbose=verbose, device=dev)

    if verbose:
        print("\n--- Running Final Model Benchmark ---")
    # print_table renders the reference's per-seed lines + pandas
    # summary table (benchmark_models.py:26-47, 176-181)
    summary, rows = harness.run_model_benchmark(
        cfg, num_seeds=bench_seeds, steps=steps_test,
        sort_params=sort_res.params, press_params=press_res.params,
        mono_params=mono_res.params,
        use_action_masking=use_action_masking,
        print_table=verbose, device=dev)
    return {
        "sort": sort_res, "press": press_res, "mono": mono_res,
        "benchmark": summary, "benchmark_rows": rows,
    }
