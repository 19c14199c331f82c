"""Metrics logging — the port's copy of ``marl_sortingenv_tpu.utils.metrics``
(the TensorBoard-equivalent sink of the trainer).

Writes JSONL (always) and TensorBoard event files when a writer is
available; both under ``log_dir/tag``.  Device-side accumulators live in
the learner (``TrainState.ep_return_acc``); this class is the host-side
sink.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, log_dir: str = "./log", tag: str = "run",
                 tensorboard: bool = True):
        self.dir = os.path.join(log_dir, tag)
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(self.dir)
            except ImportError:
                self._tb = None

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time(), **metrics}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
