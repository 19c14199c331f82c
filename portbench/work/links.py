"""The frozen peak of the links between the cards of a four-card cell, per
direction: the most one card can receive in a second, whatever the
collective.

Read on the cards (NVIDIA H100 80GB HBM3, 700 W, four on one host):
``nvidia-smi nvlink -s`` lists 18 active NVLink links on each card, each at
26.562 GB/s; ``nvidia-smi topo -m`` does not run there.  NVIDIA's H100 SXM
data sheet gives NVLink 4 as 900 GB/s for the 18 links in both directions
together: 25 GB/s per link and direction, the rate taken here.  Were the
cards joined by PCIe alone, one Gen5 x16 link (64 GB/s per direction)
would be the peak.
"""

from __future__ import annotations

NVLINKS_PER_CARD = 18
NVLINK4_BYTES_PER_S = 25e9          # per link and direction


def peak_bytes_per_s() -> float:
    """The most one card can receive from the others, in bytes/s."""
    return NVLINKS_PER_CARD * NVLINK4_BYTES_PER_S
