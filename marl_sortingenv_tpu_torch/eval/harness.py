"""Evaluation harness: the episode runner and the 5-policy benchmark.

The port of ``marl_sortingenv_tpu.eval.harness`` (the reference's
``testing.py::test_env`` and ``benchmark_models.py``).  The five scenarios
per seed (Random, Rule-Based, PPO Sort-Only, PPO Modular, PPO Monolith on
the monolith env reset with that seed) run on the bit-exact parity engine
(``run_episode``, ``benchmark_seed_all``, ``run_model_benchmark``), so
each seed's cumulative reward equals the reference's; ``Random`` draws
from the legacy MT19937 stream (``core/legacy_random.py``).  The same
protocol also runs on the fast engines (``run_engine_benchmark``,
``num_episodes`` lockstep envs from ``seed0``), whose threefry streams
make a policy's mean and std, not single episodes, what compares; and
``compare_engine_drift`` puts the two side by side.

The agents are ``ActorCritic`` modules, the port's stand-in for the JAX
package's parameter pytrees.  The parity benchmark runs one policy at a
time with all its seeds as one batch (the envs are independent, so each
seed's total is the number a run of that seed alone gives).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config.config import SimConfig
from ..core import fast as FE
from ..core import fastb as FB
from ..core import legacy_random as LR
from ..core import state as S
from ..core import step as ST
from ..models import mlp
from ..ops import graphs
from ..utils import profiling

POLICY_KEYS = ["Random", "Rule-Based", "PPO Sort-Only", "PPO Modular",
               "PPO Monolith"]

_SERIES = ("sensor_setting", "belt_occupancy", "belt_counts", "cont_true",
           "cont_false", "press_timer")


@dataclasses.dataclass
class EpisodeResult:
    cumulative_reward: float
    action_sequence: np.ndarray
    rewards: np.ndarray           # [T] total per step
    reward_pairs: np.ndarray      # [T, 2] (sort, press)
    purities: np.ndarray          # [T]
    final_state: object           # EnvState of one env (N = 1)
    series: Optional[dict] = None  # dashboard series (collect_series=True)


@torch.no_grad()
def _run_batch(cfg: SimConfig, seeds, steps: int, mode: str,
               sort_params=None, press_params=None, mono_params=None,
               use_action_masking: bool = True, collect_series: bool = False,
               device="cuda"):
    """One episode per seed of ``seeds``, all as one batch, ``steps``
    steps of ``mode`` without auto-reset.  Returns (final state, the
    StepOut fields stacked [T, N] as numpy, the series' state fields after
    each step [T, N, ...] or None)."""
    dev = resolve_device(device)
    st = S.reset(cfg, seeds, device=dev)
    m = use_action_masking
    if mode == "rule_based":
        step = lambda st: ST.step_mono_rule(cfg, st)  # noqa: E731
    elif mode == "model":
        step = lambda st: ST.step_mono_model(  # noqa: E731
            cfg, st, sort_params, press_params, m, True)
    elif mode == "mono":
        # the benchmark hands the model to test_env, which predicts on the
        # previous obs (masked iff masking is on) through the external path
        step = lambda st: ST.step_mono_policy(  # noqa: E731
            cfg, st, mono_params, m)
    elif mode == "random":
        lr = LR.mt19937_init(seeds, device=dev)

        def step(st):
            nonlocal lr
            st, lr, out = ST.step_mono_legacy_random(cfg, st, lr, m)
            return st, out
    else:
        raise ValueError(mode)
    outs, extra = [], []
    for _ in range(steps):
        st, out = step(st)
        outs.append(out)
        if collect_series:
            extra.append([getattr(st, f) for f in _SERIES])
    outs = ST.StepOut(*(torch.stack(x).cpu().numpy() for x in zip(*outs)))
    series = None
    if collect_series:
        series = {f: torch.stack(x).cpu().numpy()
                  for f, x in zip(_SERIES, zip(*extra))}
    return st, outs, series


def _total(rewards: np.ndarray) -> float:
    """An episode's cumulative reward: NumPy's sum of its contiguous
    per-step rewards, as the JAX harness sums them."""
    return float(np.ascontiguousarray(rewards).sum())


def _pack(st, outs) -> EpisodeResult:
    rewards = np.asarray(outs.reward)
    return EpisodeResult(
        cumulative_reward=_total(rewards),
        action_sequence=np.asarray(outs.action),
        rewards=rewards,
        reward_pairs=np.stack([np.asarray(outs.sort_reward),
                               np.asarray(outs.press_reward)], 1),
        purities=np.asarray(outs.purity),
        final_state=st)


def episode_series(cfg: SimConfig, outs_and_extra) -> dict:
    """The dashboard series of one episode from its outputs and its
    per-step state fields (``_run_batch``'s, for one env)."""
    outs, extra = outs_and_extra
    return {
        "sort_reward": np.asarray(outs.sort_reward),
        "press_reward": np.asarray(outs.press_reward),
        "purity": np.asarray(outs.purity),
        "press_log": np.asarray(outs.press_log),
        "setting": np.asarray(extra["sensor_setting"]),
        "belt_occupancy": np.asarray(extra["belt_occupancy"]),
        "belt_counts": np.asarray(extra["belt_counts"]),
        "cont_true": np.asarray(extra["cont_true"]),
        "cont_false": np.asarray(extra["cont_false"]),
        "press_timer": np.asarray(extra["press_timer"]),
    }


def run_episode(cfg: SimConfig, seed: int, steps: int,
                mode: str = "rule_based", sort_params=None,
                press_params=None, mono_params=None,
                use_action_masking: bool = True,
                collect_series: bool = False, render: bool = False,
                render_kwargs: Optional[dict] = None,
                device="cuda") -> EpisodeResult:
    """``test_env`` on a monolith env reset with ``seed``.

    mode: 'rule_based' | 'model' (the modular agents with random
    fallbacks) | 'mono' (the monolith agent) | 'random' (the legacy global
    MT19937 stream; no series, no render).  ``render`` draws the
    dashboard of the episode (``viz.dashboard.plot_env`` with
    ``render_kwargs``, by default ``{"save": True}``); it needs
    matplotlib."""
    series = (collect_series or render) and mode != "random"
    st, outs, extra = _run_batch(cfg, [seed], steps, mode, sort_params,
                                 press_params, mono_params,
                                 use_action_masking, series, device)
    one = ST.StepOut(*(x[:, 0] for x in outs))
    res = _pack(st, one)
    if series:
        res.series = episode_series(
            cfg, (one, {k: v[:, 0] for k, v in extra.items()}))
        if render:
            from ..viz.dashboard import plot_env

            plot_env(cfg, res.series, S.env_at(st), seed=seed,
                     **(render_kwargs or {"save": True}))
    return res


def _policy_totals_parity(cfg: SimConfig, key: str, seeds, steps: int,
                          sort_params, press_params, mono_params,
                          use_action_masking: bool, device) -> List[float]:
    """Each seed's cumulative reward under policy ``key``, the seeds run
    as one batch."""
    mode, sp, pp = {
        "Random": ("random", None, None),
        "Rule-Based": ("rule_based", None, None),
        "PPO Sort-Only": ("model", sort_params, None),
        "PPO Modular": ("model", sort_params, press_params),
        "PPO Monolith": ("mono", None, None)}[key]
    _, outs, _ = _run_batch(cfg, seeds, steps, mode, sp, pp, mono_params,
                            use_action_masking, False, device)
    return [_total(outs.reward[:, i]) for i in range(len(seeds))]


def _benchmark_rows(cfg, seeds, steps, sort_params, press_params,
                    mono_params, use_action_masking, include_random,
                    device) -> List[Dict[str, float]]:
    keys = [k for k in POLICY_KEYS
            if (k != "Random" or include_random)
            and (k != "PPO Monolith" or mono_params is not None)]
    totals = {k: _policy_totals_parity(cfg, k, seeds, steps, sort_params,
                                       press_params, mono_params,
                                       use_action_masking, device)
              for k in keys}
    return [{"seed": s, **{k: totals[k][i] for k in keys}}
            for i, s in enumerate(seeds)]


def benchmark_seed_all(cfg: SimConfig, seed: int, steps: int,
                       sort_params=None, press_params=None, mono_params=None,
                       use_action_masking: bool = True,
                       include_random: bool = True,
                       device="cuda") -> Dict[str, float]:
    """All five scenarios for one seed (the Monolith one only with
    ``mono_params``)."""
    return _benchmark_rows(cfg, [seed], steps, sort_params, press_params,
                           mono_params, use_action_masking, include_random,
                           device)[0]


def run_model_benchmark(cfg: SimConfig, num_seeds: int = 10,
                        steps: int = 200, sort_params=None,
                        press_params=None, mono_params=None,
                        use_action_masking: bool = True,
                        include_random: bool = True,
                        print_table: bool = False, device="cuda"):
    """Mean and population std per policy over seeds 1..num_seeds.
    Returns ({policy: {"mean", "std"}}, the per-seed rows).
    ``print_table`` prints the per-seed lines and the summary the
    reference prints."""
    seeds = list(range(1, num_seeds + 1))
    rows = _benchmark_rows(cfg, seeds, steps, sort_params, press_params,
                           mono_params, use_action_masking, include_random,
                           device)
    if print_table:
        header = ("Seed\t    Random\tRule-Based\t Sort-Only\t   Modular"
                  "\t  Monolith")
        print(f"\n⚙ Running benchmark sequentially across {num_seeds} "
              "seeds...\n")
        print(header)
        print("-" * (len(header) + 20))
        for row in rows:
            line = f"  {row['seed']: >4}"
            for key in POLICY_KEYS:
                val = row.get(key)
                line += (f"\t{val: >10.2f}" if val is not None
                         else "\t       N/A")
            print(line)
    summary = {}
    for key in POLICY_KEYS:
        vals = [r[key] for r in rows if key in r]
        if vals:
            summary[key] = {"mean": float(np.mean(vals)),
                            "std": float(np.std(vals))}
    if print_table and summary:
        try:
            import pandas as pd

            df = pd.DataFrame(summary).T
            df.index.name = "Policy"
            print("\n" + "=" * 80)
            print("Summary of Benchmark Results:")
            print(df.to_string(float_format="%.2f"))
            print("=" * 80)
        except ImportError:
            pass
    return summary, rows


def compare_engine_drift(cfg: SimConfig, num_seeds: int = 10,
                         steps: int = 200, sort_params=None,
                         press_params=None, mono_params=None,
                         use_action_masking: bool = True,
                         engines=("fast", "fastb"), device="cuda"):
    """One table: the parity benchmark (the bit-exact protocol) beside
    each fast engine's distribution.  Returns {engine: {policy: {mean,
    std}}} with 'parity' included."""
    parity, _ = run_model_benchmark(
        cfg, num_seeds=num_seeds, steps=steps, sort_params=sort_params,
        press_params=press_params, mono_params=mono_params,
        use_action_masking=use_action_masking, device=device)
    table = {"parity": parity}
    for eng in engines:
        table[eng] = run_engine_benchmark(
            cfg, engine=eng, num_episodes=num_seeds, steps=steps,
            sort_params=sort_params, press_params=press_params,
            mono_params=mono_params, use_action_masking=use_action_masking,
            device=device)
    return table


def policy_steps(cfg: SimConfig, policy: str, engine: str = "fastb",
                 num_episodes: int = 10, steps: int = 200,
                 sort_params=None, press_params=None, mono_params=None,
                 use_action_masking: bool = True, seed0: int = 1,
                 device="cuda"):
    """The step outputs, one per step, of ``num_episodes`` lockstep
    episodes of one policy of ``POLICY_KEYS`` on ``engine``: the episodes
    reset from ``seed0`` and step ``steps`` times without autoreset.  On
    ``fastb`` with CUDA (``graphs.eligible``) the steps that are eager
    bodies replay a CUDA graph (``fastb.graphed_step``: Random, PPO
    Sort-Only, PPO Modular); each output is a tensor of its own."""
    mod = {"fast": FE, "fastb": FB}[engine]
    dev = resolve_device(device)
    m = use_action_masking
    # each policy's step but the monolith agent's: its name on the engine
    # and its arguments after the state
    named = {"Random": ("step_mono_random", (m,)),
             "Rule-Based": ("step_mono_rule", ()),
             "PPO Sort-Only": ("step_mono_model", (sort_params, None, m)),
             "PPO Modular": ("step_mono_model",
                             (sort_params, press_params, m))}
    if policy == "PPO Monolith":
        if mono_params is None:
            raise ValueError("the PPO Monolith policy needs mono_params")
    elif policy not in named:
        raise ValueError(f"unknown policy {policy!r}")

    st = mod.reset_batch(cfg, seed0, num_episodes, device=dev)
    with torch.no_grad():
        if policy != "PPO Monolith":
            name, args = named[policy]
            graphed = (FB.graphed_step(cfg, name, args, st)
                       if graphs.eligible(engine, dev) else None)
            if graphed is not None:
                with graphed.loaded(st):
                    for _ in range(steps):
                        with profiling.span("eval.step", policy=policy):
                            out = graphed.step()
                        yield out
                return
            step = getattr(mod, name)
            for _ in range(steps):
                with profiling.span("eval.step", policy=policy):
                    st, out = step(cfg, st, *args)
                yield out
            return
        # the monolith agent acts on the last observation, its logits
        # masked iff masking is on, as the JAX harness's scan does
        obs = mod.get_mono_obs(cfg, st)
        for _ in range(steps):
            with profiling.span("eval.step", policy=policy):
                logits = mono_params.policy_logits(obs)
                if m:
                    logits = mlp.masked_logits(
                        logits, mod.monolith_action_masks(cfg, st))
                st, out = mod.step_mono_external(cfg, st,
                                                 FB.agent_argmax(logits), m)
            obs = out.obs
            yield out


def policy_totals(cfg: SimConfig, policy: str, engine: str = "fastb",
                  num_episodes: int = 10, steps: int = 200,
                  sort_params=None, press_params=None, mono_params=None,
                  use_action_masking: bool = True, seed0: int = 1,
                  device="cuda") -> np.ndarray:
    """Each episode's summed reward, f64[num_episodes], for one policy
    (``policy_steps``).  The rewards stay on the device until the end and
    are summed over the steps in f64 on the host, as the JAX harness sums
    its scanned rewards."""
    rewards = torch.stack([out.reward for out in policy_steps(
        cfg, policy, engine, num_episodes, steps, sort_params, press_params,
        mono_params, use_action_masking, seed0, device)])
    return np.asarray(rewards.cpu().numpy(), np.float64).sum(axis=0)


def run_engine_benchmark(cfg: SimConfig, engine: str = "fastb",
                         num_episodes: int = 10, steps: int = 200,
                         sort_params=None, press_params=None,
                         mono_params=None, use_action_masking: bool = True,
                         include_random: bool = True, seed0: int = 1,
                         device="cuda"):
    """The 5-policy protocol on ``engine`` ('fastb' or 'fast'): returns
    ``{policy: {"mean", "std"}}`` over ``num_episodes`` lockstep episodes of
    ``steps`` steps (population std).  Random is left out unless
    ``include_random``, the monolith agent unless ``mono_params`` is
    given."""
    if engine not in ("fast", "fastb"):
        raise ValueError(f"unknown engine {engine!r}")
    summary = {}
    for key in POLICY_KEYS:
        if (key == "Random" and not include_random) or (
                key == "PPO Monolith" and mono_params is None):
            continue
        totals = policy_totals(
            cfg, key, engine, num_episodes, steps, sort_params,
            press_params, mono_params, use_action_masking, seed0, device)
        summary[key] = {"mean": float(totals.mean()),
                        "std": float(totals.std())}
    return summary
