"""PyTorch/CUDA port of ``marl_sortingenv_tpu``.

Same layout as the JAX package (``config``, ``core``, ``ops``, ``models``,
``learn``, ``eval``, ``utils``); the JAX package stays the reference the
port is tested against.  Entry points take an explicit ``device`` that defaults to
``"cuda"`` and raise when CUDA is absent unless the caller asks for the
CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing CUDA when no card is present
    (there is no quiet fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
