"""Host-side ``reward_data`` equivalent (reference
``env_super.py:928-946`` ``_log_step_data`` + plotting inputs).

The port's copy of ``marl_sortingenv_tpu.eval.episode_log``.  The engine
returns stacked ``StepOut`` arrays from an episode; this module reshapes
them into the dict-of-series structure the reference accumulates per
step, and computes the console *checksum* fingerprint the reference
prints from ``plot_env`` (``utils/plotting.py:663-678``): total material
in containers + presses + bales, plus the input count.

A state here is the state of one env, without the env axis
(``core.state.env_at``); its leaves may be tensors on any device, which
``host`` copies to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


def host(x) -> np.ndarray:
    """A state leaf as a numpy array: a tensor, on the card or the CPU, is
    copied to the host first."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x)


@dataclasses.dataclass
class EpisodeLog:
    reward_data: Dict[str, np.ndarray]
    final_state: object

    @property
    def cumulative_total(self) -> float:
        return float(np.sum(self.reward_data["Total"]))


def build_episode_log(cfg, outs, final_state, belt_props=None) -> EpisodeLog:
    """``outs``: stacked StepOut over time [T, ...] of one env.
    ``final_state``: the env's state after the episode."""
    sort_r = host(outs.sort_reward)
    press_r = host(outs.press_reward)
    press_log = getattr(outs, "press_log", None)
    rd = {
        "Reward": np.stack([sort_r, press_r], axis=1),
        "Total": sort_r + press_r,
        "Accuracy": host(outs.purity),
        "Action": host(outs.action),
        "PressLog": (np.zeros_like(sort_r) if press_log is None
                     else host(press_log)),
    }
    return EpisodeLog(reward_data=rd, final_state=final_state)


def checksum(state) -> Dict[str, int]:
    """Reference checksum (plotting.py:663-678): material in containers +
    presses + bales; input length from the conservation counter."""
    in_containers = int(host(state.cont_true).sum()
                        + host(state.cont_false).sum())
    in_presses = int(host(state.press_n).sum())
    in_bales = int(host(state.bale_size).sum())
    return {
        "checksum": in_containers + in_presses + in_bales,
        "containers": in_containers,
        "presses": in_presses,
        "bales": in_bales,
        "input_length": int(host(state.total_input_units)),
    }


def first_inputs(cfg, seed, k: int = 10) -> List[str]:
    """Replay the seasonal input generator's FIRST batch on the host and
    return its first ``k`` unit symbols — the reference's "First 10
    elements" checksum line (``utils/plotting.py:676-678``, fed by
    ``env_super.py:446`` ``input_history_batches``).

    The engines carry material *counts*; the per-unit symbol order only
    exists inside the generator's shuffle
    (``utils/input_generator.py:49-62``).  That generator draws from a
    plain ``np.random.default_rng(seed)`` stream (permutation of the 2
    pattern keys, one ``choice`` per remainder unit, one ``shuffle`` of
    the batch), so an exact host replay of the first batch is three
    numpy calls — no engine state needed, bit-exact by construction."""
    names = ["A", "B", "C", "D"]
    patterns = {1: [0.40, 0.15, 0.35, 0.10],   # A & C dominant
                2: [0.15, 0.40, 0.10, 0.35]}   # B & D dominant
    rng = np.random.default_rng(seed)
    seq = rng.permutation(list(patterns.keys()))
    ratios = patterns[int(seq[0])]
    bs = cfg.input_batch_size
    units = {m: int(np.floor(r * bs)) for m, r in zip(names, ratios)}
    for _ in range(bs - sum(units.values())):
        units[str(rng.choice(names))] += 1
    batch: List[str] = []
    for m in names:
        batch.extend([m] * units[m])
    rng.shuffle(batch)
    return batch[:k]


def print_checksum(state, seed=None, cfg=None) -> None:
    c = checksum(state)
    print(
        f"🔍 Checksum (Seed={seed}): {c['checksum']} = "
        f"({c['containers']} Containers + {c['presses']} Presses + "
        f"{c['bales']} Bales)"
    )
    print("🔍 Length of Inputs: ", c["input_length"])
    if cfg is not None and seed is not None:
        print(f"First 10 elements: {first_inputs(cfg, seed)}")
