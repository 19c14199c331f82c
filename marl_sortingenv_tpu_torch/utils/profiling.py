"""Tracing / profiling hooks — the port of
``marl_sortingenv_tpu.utils.profiling`` on ``torch.profiler``.

* ``trace(log_dir)`` — context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA's where a card is present) that writes a Chrome
  trace (``chrome://tracing``, Perfetto) under ``log_dir``; no
  TensorBoard package is needed.
* ``annotate(name)`` — a named trace span (``record_function``).
* ``Throughput`` — steps/s counter that waits for the card before it
  counts.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity


@contextlib.contextmanager
def trace(log_dir: str = "./log/profile"):
    """Profile the block; on exit the trace is written to
    ``<log_dir>/trace_<pid>_<ns>.json``.  Yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


class Throughput:
    """Wall-clock env-steps/s measurement with device sync."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0: Optional[float] = None
        self._steps = 0

    def start(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n_steps: int, sync=None):
        """Count ``n_steps``; with ``sync`` (a tensor) on the card, wait
        first for the work queued on its device."""
        if isinstance(sync, torch.Tensor) and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        self._steps += n_steps

    def rate(self) -> float:
        if self._t0 is None or self._steps == 0:
            return 0.0
        return self._steps / (time.perf_counter() - self._t0)
