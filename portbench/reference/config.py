"""Frozen configuration pytree mirroring the reference ``config.yml``.

Every field name/default matches the reference exactly (values loaded at
reference ``src/envs_train/env_super.py:27-137``; file ``config.yml``).
Dead keys that the reference loads but never uses in any step path
(``occupancy_reduction_factor``, ``full_bale_bonus``,
``reward_scaling_factor``, ``sorting_mode_change_penalty``,
``decay_steepness_k``, ``min_weight`` — SURVEY.md §2.9) are kept for API
compatibility but do not influence the dynamics.

The config is a frozen dataclass of Python floats/ints: the step functions
read it as host constants.

This is the PyTorch port's own copy of ``marl_sortingenv_tpu.config.config``
(the port imports nothing of the JAX package).  Field names and defaults
are identical, so a config built by either package describes the same env.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SimConfig:
    # --- simulation --- (config.yml:4-9)
    input_occupancy_min: int = 60
    input_occupancy_max: int = 80
    input_batch_size: int = 100
    steps_per_pattern: int = 20
    input_history_length: int = 10

    # --- sorting_station --- (config.yml:12-18)
    baseline_accuracy: Tuple[float, float, float, float] = (0.75, 0.75, 0.75, 0.75)
    boost: float = 0.5
    occupancy_reduction_factor: float = 0.2  # dead key (never read by dynamics)
    noise: float = 0.05
    stage_capacity: int = 100

    # --- pressing_station --- (config.yml:21-32)
    press_time_1: int = 12
    press_time_2: int = 15
    container_capacity: int = 700
    bale_standard_size: int = 200
    bale_remainder_threshold: float = 0.5
    quality_threshold: float = 0.9  # identical for A..D in the reference

    # --- rewards.sorting --- (config.yml:37-45)
    purity_threshold_theta: float = 0.80
    decay_steepness_k: float = 170.0      # dead (only _calculate_asymmetric_weight)
    min_weight: float = 0.1               # dead
    reward_scaling_factor: float = 2.0    # loaded but unused (env_super.py:122)
    sorting_mode_change_penalty: float = -0.1  # loaded twice, never applied
    tanh_temperature: float = 0.5
    purity_scaling_factor: float = 2.0    # hard-coded at env_super.py:971

    # --- rewards.pressing --- (config.yml:48-56)
    overflow_penalty_catastrophic: float = -1.0
    overflow_penalty_severe: float = -0.5
    overflow_penalty_mild: float = -0.2
    bale_efficiency_factor: float = 1.0
    full_bale_bonus: float = 0.1          # dead key
    max_state_reward: float = 0.5

    # --- rewards --- (config.yml:59)
    overflow_termination_penalty: float = -10.0

    # --- constructor-level parameters (env_super.py:25, main.py:42-52) ---
    max_steps: int = 200
    noise_sorting: float = 0.0   # main.py:42 overrides the config noise
    balesize: int = 200          # main.py:43 (same as bale_standard_size)

    # --- TPU-build parameters (no reference counterpart) ---
    max_bales: int = 112  # fixed-capacity ring for the variable-length lists
    # Bale bookkeeping strategy of the batch-last engine (core.fastb):
    # "auto"   — (default) the engine picks "events", the production
    #            path, and the only one the port's step kernel takes);
    #            engines without an event mode
    #            (core.fast, the parity/exact engines) are unaffected.
    # "full"   — materialize the (5, max_bales, N) ring buffers every step.
    #            The one reason to pick it: consumers that read the dense
    #            bale_size/bale_qual/bale_cnt arrays straight off the
    #            DEVICE state inside jit (the host-side accessors rebuild
    #            them losslessly from events, but only outside jit);
    # "events" — record one (material, amount, quality) event per finished
    #            press into an (max_press_events, N) log and rebuild the
    #            exact bale lists on host only when a consumer needs them
    #            (core.bale_events).  Lossless, and removes the dominant
    #            HBM write traffic of the step (the bale buffers).
    bale_mode: str = "auto"
    max_press_events: int = 36  # >= floor(T/12)+floor(T/15)+slack for T=200
    # sort_kernel / step_kernel are kept for API compatibility with the JAX
    # package.  The port ignores them: its fastb step dispatches on the
    # state's device (CUDA tensors -> the hand-written CUDA step kernel,
    # ops/step_cuda.py; CPU tensors -> the eager torch body).  The
    # comments below describe the JAX package's reading.
    # Sorting-redistribution implementation of the batch-last engine:
    # "auto"   — fused Pallas kernel (ops/sort_pallas.py) on TPU when the
    #            env batch fills whole 128-lane rows, XLA otherwise;
    # "pallas"/"xla" force the choice.  Both are bitwise-identical
    # (tests/test_sort_pallas.py); the kernel collapses ~300 small serial
    # VPU ops (threefry chain + 12 hypergeometric inverse-CDF draws) into
    # one VMEM-resident dispatch.  Use "xla" for pjit-sharded fastb
    # rollouts (pallas_call is opaque to the SPMD partitioner).
    sort_kernel: str = "auto"
    # Whole-step implementation of the batch-last MONOLITH step
    # (core.fastb step_mono_rule / step_mono_external):
    # "auto"   — the fused full-step Pallas kernel (ops/step_pallas.py)
    #            on TPU when bale_mode=="events" and the env batch fills
    #            whole 128-lane rows — the entire step (input generator,
    #            accuracy noise, sorting redistribution, press/bale-event
    #            bookkeeping, rewards, observations) in ONE VMEM-resident
    #            dispatch, bitwise-identical to the XLA path
    #            (tests/test_step_pallas.py);
    # "pallas"/"xla" force the choice.  When the step kernel runs, the
    # separate sort_kernel setting is irrelevant (subsumed).
    step_kernel: str = "auto"

    @property
    def press_times(self) -> Tuple[int, int]:
        return (self.press_time_1, self.press_time_2)

    @property
    def effective_noise(self) -> float:
        """Reference: constructor arg overrides config (env_super.py:71)."""
        return self.noise_sorting if self.noise_sorting is not None else self.noise

    @property
    def effective_balesize(self) -> int:
        return self.balesize if self.balesize is not None else self.bale_standard_size

    def with_(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


def default_max_bales(cfg: SimConfig) -> int:
    """Capacity bound for the per-material bale buffer: total input over an
    episode is max_steps * input_batch_size units; bales smaller than half a
    standard bale only occur when a material's list is empty (reference
    env_super.py:674-684), so the count is bounded by
    total_units / (balesize/2) + slack."""
    total = cfg.max_steps * cfg.input_batch_size
    return max(8, total // max(1, cfg.effective_balesize // 2) + 8)


def default_max_press_events(cfg: SimConfig) -> int:
    """Per-episode bound on finished presses: press p can complete at most
    floor(max_steps / press_time_p) times between (auto)resets."""
    t = cfg.max_steps if cfg.max_steps is not None else 256
    return t // max(1, cfg.press_time_1) + t // max(1, cfg.press_time_2) + 4


def load_config(yaml_path: str | None = None, **overrides) -> SimConfig:
    """Build a config, optionally reading a reference-format ``config.yml``."""
    cfg = SimConfig()
    if yaml_path is not None:
        import yaml

        with open(yaml_path) as f:
            raw = yaml.safe_load(f)
        sim = raw.get("simulation", {})
        sort = raw.get("sorting_station", {})
        press = raw.get("pressing_station", {})
        rew = raw.get("rewards", {})
        rs = rew.get("sorting", {})
        rp = rew.get("pressing", {})
        qt = press.get("bale_quality_thresholds", {})
        cfg = cfg.with_(
            input_occupancy_min=sim.get("input_occupancy_min", cfg.input_occupancy_min),
            input_occupancy_max=sim.get("input_occupancy_max", cfg.input_occupancy_max),
            input_batch_size=sim.get("input_batch_size", cfg.input_batch_size),
            steps_per_pattern=sim.get("steps_per_pattern", cfg.steps_per_pattern),
            input_history_length=sim.get("input_history_length", cfg.input_history_length),
            baseline_accuracy=tuple(sort.get("baseline_accuracy", cfg.baseline_accuracy)),
            boost=sort.get("boost", cfg.boost),
            occupancy_reduction_factor=sort.get("occupancy_reduction_factor", cfg.occupancy_reduction_factor),
            noise=sort.get("noise", cfg.noise),
            stage_capacity=sort.get("stage_capacity", cfg.stage_capacity),
            press_time_1=press.get("press_times", {}).get(1, cfg.press_time_1),
            press_time_2=press.get("press_times", {}).get(2, cfg.press_time_2),
            container_capacity=press.get("container_capacity", cfg.container_capacity),
            bale_standard_size=press.get("bale_standard_size", cfg.bale_standard_size),
            bale_remainder_threshold=press.get("bale_remainder_threshold", cfg.bale_remainder_threshold),
            quality_threshold=qt.get("A", cfg.quality_threshold),
            purity_threshold_theta=rs.get("purity_threshold_theta", cfg.purity_threshold_theta),
            decay_steepness_k=rs.get("decay_steepness_k", cfg.decay_steepness_k),
            min_weight=rs.get("min_weight", cfg.min_weight),
            reward_scaling_factor=rs.get("reward_scaling_factor", cfg.reward_scaling_factor),
            sorting_mode_change_penalty=rs.get("sorting_mode_change_penalty", cfg.sorting_mode_change_penalty),
            tanh_temperature=rs.get("tanh_temperature", cfg.tanh_temperature),
            overflow_penalty_catastrophic=rp.get("overflow_penalty_catastrophic", cfg.overflow_penalty_catastrophic),
            overflow_penalty_severe=rp.get("overflow_penalty_severe", cfg.overflow_penalty_severe),
            overflow_penalty_mild=rp.get("overflow_penalty_mild", cfg.overflow_penalty_mild),
            bale_efficiency_factor=rp.get("bale_efficiency_factor", cfg.bale_efficiency_factor),
            full_bale_bonus=rp.get("full_bale_bonus", cfg.full_bale_bonus),
            max_state_reward=rp.get("max_state_reward", cfg.max_state_reward),
            overflow_termination_penalty=rew.get("overflow_termination_penalty", cfg.overflow_termination_penalty),
        )
    if overrides:
        cfg = cfg.with_(**overrides)
    if "max_bales" not in overrides:
        cfg = cfg.with_(max_bales=default_max_bales(cfg))
    if "max_press_events" not in overrides:
        cfg = cfg.with_(max_press_events=default_max_press_events(cfg))
    return cfg
