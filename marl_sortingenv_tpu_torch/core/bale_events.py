"""Host-side reconstruction for the fastb event-log bale mode.

The port's copy of ``marl_sortingenv_tpu.core.bale_events`` (NumPy only).
With ``cfg.bale_mode == "events"`` the batch-last engine (``core/fastb.py``)
does not keep the (5, MAX_BALES, N) bale buffers; each finished press
appends one event ``(material, amount, quality)`` to an (E, N) log.  The
bale lists of full mode (full bales of ``bale_standard_size``, a remainder
above the threshold as its own bale, a small remainder merged into the last
bale) are a deterministic replay of that log, made here on the host when a
consumer needs them.  The replay follows ``fastb._press_bale``'s full-mode
branch; ``tests/test_torch_fastb_full.py`` holds it bitwise against a
full-mode run with the same keys and against the JAX package's copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config.config import SimConfig

__all__ = ["rebuild_bales", "events_to_full"]


def rebuild_bales(cfg: SimConfig, ev_mat, ev_n, ev_q, ev_cnt,
                  max_bales: int | None = None):
    """Replay press events into dense bale buffers.

    The arguments are the event-log leaves of a fastb ``BState`` (batch
    last: ``ev_mat/ev_n/ev_q`` i16[E, N], ``ev_cnt`` i32[N]), as tensors on
    any device or as arrays.  Returns numpy ``(bale_size i16[5, MAX, N],
    bale_qual i16[5, MAX, N], bale_cnt i32[5, N])``: the arrays a
    ``bale_mode="full"`` run with the same keys would hold."""
    ev_mat, ev_n, ev_q, ev_cnt = (
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in (ev_mat, ev_n, ev_q, ev_cnt))
    ev_n = ev_n.astype(np.int64)
    E, N = ev_n.shape
    if np.any(ev_cnt > E):
        raise ValueError(
            f"event log overflow: max ev_cnt {int(ev_cnt.max())} > capacity "
            f"{E}; raise cfg.max_press_events")
    MAX = max_bales if max_bales is not None else cfg.max_bales
    bs = cfg.effective_balesize
    thresh = float(bs) * float(cfg.bale_remainder_threshold)

    bale_size = np.zeros((5, MAX, N), np.int16)
    bale_qual = np.zeros((5, MAX, N), np.int16)
    bale_cnt = np.zeros((5, N), np.int32)

    for i in range(N):
        for e in range(int(ev_cnt[i])):
            m = int(ev_mat[e, i])
            n = int(ev_n[e, i])
            q = ev_q[e, i]
            full, rem = divmod(n, bs)
            c = bale_cnt[m, i]
            if full:
                bale_size[m, c:c + full, i] = bs
                bale_qual[m, c:c + full, i] = q
                c += full
            if rem > 0:
                # a big remainder (or an empty list) becomes its own bale,
                # a small one merges into the last bale, whose quality stays
                if rem > thresh or c == 0:
                    bale_size[m, c, i] = rem
                    bale_qual[m, c, i] = q
                    c += 1
                else:
                    bale_size[m, c - 1, i] += rem
            bale_cnt[m, i] = c
    return bale_size, bale_qual, bale_cnt


def events_to_full(cfg: SimConfig, st):
    """An event-mode fastb ``BState`` converted to full-bale mode: its
    ``bale_size/bale_qual/bale_cnt`` populated as tensors on the state's
    device and its ``ev_*`` leaves set to ``None``.  A full-mode state is
    returned as it is."""
    if st.ev_cnt is None:
        return st
    size, qual, cnt = rebuild_bales(cfg, st.ev_mat, st.ev_n, st.ev_q,
                                    st.ev_cnt)
    dev = st.ev_cnt.device
    return st._replace(
        bale_size=torch.from_numpy(size).to(dev),
        bale_qual=torch.from_numpy(qual).to(dev),
        bale_cnt=torch.from_numpy(cnt).to(dev),
        ev_mat=None, ev_n=None, ev_q=None, ev_cnt=None)
