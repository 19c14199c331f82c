"""PyTorch/CUDA port of ``marl_sortingenv_tpu``.

Same layout as the JAX package; the JAX package stays the reference the
port is tested against.  Entry points take an explicit ``device`` that
defaults to ``"cuda"`` and raise when CUDA is absent unless the caller
asks for the CPU.

Subpackage map (component parity vs reference documented per module):
  config/    frozen config                <-> reference config.yml
  core/      env state machines + RNG     <-> src/envs_train/env_super.py,
                                               utils/input_generator.py,
                                               env_1_sort / env_2_press /
                                               env_monolith
             (the bit-exact parity engine; the fastb/fast engines)
  ops/       the CUDA kernels (csrc/) and their plain versions
  models/    the actor-critic (+ rules)   <-> SB3 MlpPolicy 32x32
  learn/     Maskable PPO + the trainer   <-> SB3 PPO / sb3-contrib MaskablePPO,
                                               src/training.py
  eval/      episode runner + benchmark   <-> src/testing.py,
                                               utils/benchmark_models.py
  viz/       dashboard + analysis figures <-> utils/plotting.py,
                                               utils/plot_env_analysis.py
  utils/     checkpoints, metrics, env checker, profiling (the
             program's spans and the trace exporter)
  envs.py    the Gymnasium drop-in envs   <-> src/envs_train/*
  testing.py ``test_env``                 <-> src/testing.py
  training.py ``Train_Agent``/``RL_Trainer`` <-> src/training.py
  main.py    the CLI (``run_sim``)        <-> main.py
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is present
    (there is no quiet fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


_CONSTS: dict = {}


def const(value, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(value, dtype=dtype, device=device)`` of a host number
    or sequence, made on the first call and shared by every later one.  On
    CUDA each ``torch.tensor`` is a blocking copy from pageable memory,
    which a CUDA graph's capture refuses; a step whose constants come from
    here makes no copy after its first call.  Values are told apart by
    their bits (0.0 from -0.0).  Never write to the tensor returned."""
    a = np.asarray(value)
    key = (a.dtype.str, a.shape, a.tobytes(), dtype, torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(value, dtype=dtype, device=device)
    return t
