"""What the per-layer metrics' readers share.  Each returns None where
the run gave it nothing to read, and the metric is then left out."""

from __future__ import annotations

import statistics


def mean_ms(r, span: str):
    """The mean of a span's durations, in ms."""
    xs = r.spans.get(span)
    return 1e3 * statistics.fmean(xs) if xs else None


def mfu(r, flops: float, seconds: float):
    """Model FLOPs over the time they took, as % of the card's f32
    peak."""
    if not flops or not seconds:
        return None
    return 100.0 * flops / seconds / r.work.F32_FLOP_PER_S


def ops_per_step(r):
    """Device operations (kernels, copies, fills) per batched env step of
    the traced slice."""
    if not r.slice_steps or not r.slice.ops:
        return None
    return len(r.slice.ops) / r.slice_steps


def roofline(r, kernel: str):
    """The frozen bound of the slice's launches of ``kernel`` over the
    kernel's device time there, in %."""
    runs = [(v, n, c) for k, v, n, c in r.launches if k == kernel and c > 0]
    dev_s = r.slice.device_seconds(kernel + "_kernel")
    if not runs or dev_s <= 0:
        return None
    bound = sum(c * r.work.kernel_bound_s(r.sim, kernel, v, n)
                for v, n, c in runs)
    return 100.0 * bound / dev_s


def idle_share(r):
    """The share of the slice's time with nothing on the device, in %."""
    if r.slice.window_s <= 0 or not r.slice.ops:
        return None
    return 100.0 * (1.0 - r.slice.busy_s / r.slice.window_s)
