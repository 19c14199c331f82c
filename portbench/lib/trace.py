"""Spans, and the reduction of a profiled slice to what the metrics read.

A traced run records, from the benchmark's own files, host spans around
calls into the program (``Spans``) and profiles one bounded slice of the
timed path (``profile_slice``).  The slice keeps in memory only its device
operations' intervals and the benchmark's spans; no trace file is
written.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

SPAN_PREFIX = "pb."


class Spans:
    """Durations by name, in seconds, of the spans recorded with
    ``span``.  With ``sync`` the span waits for the device at both ends,
    so that it holds the work its calls queued."""

    def __init__(self, sync: bool = True):
        self.sync = sync and torch.cuda.is_available()
        self.seconds = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        with torch.profiler.record_function(SPAN_PREFIX + name):
            if self.sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.sync:
                    torch.cuda.synchronize()
                self.seconds[name].append(time.perf_counter() - t0)


def _union(intervals):
    """Sorted disjoint intervals covering ``intervals`` (pairs, us)."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


class Slice:
    """A profiled slice: the device operations ``ops`` as (name, start,
    end) in us on the profiler's clock, the benchmark spans ``spans`` and
    the top-level host calls ``cpu_ops`` alike, and the slice's bounds
    ``t0``, ``t1`` on that clock."""

    def __init__(self, ops, spans, cpu_ops, t0, t1):
        self.ops, self.spans, self.cpu_ops = ops, spans, cpu_ops
        self.t0, self.t1 = t0, t1
        self.busy = _union((max(s, t0), min(e, t1)) for _, s, e in ops
                           if e > t0 and s < t1)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def device_seconds(self, name_part: str) -> float:
        """Device time of the operations whose name holds ``name_part``."""
        return sum(e - s for n, s, e in self.ops if name_part in n) * 1e-6

    def top_ops(self, k: int = 10):
        by = defaultdict(float)
        for n, s, e in self.ops:
            by[n] += (e - s) * 1e-6
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda nv: -nv[1])[:k]

    def idle_gaps(self, k: int = 10):
        """The ``k`` longest stretches with nothing on the device, each
        named by the benchmark span and the outermost program call the host
        was in at the gap's middle."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: -g[0])
        out = []
        for dur, s, e in gaps[:k]:
            mid = 0.5 * (s + e)
            span = [n for n, a, b in self.spans if a <= mid <= b]
            call = [(a, n) for n, a, b in self.cpu_ops if a <= mid <= b]
            label = span[-1] if span else "outside the spans"
            if call:
                label += " / " + min(call)[1]
            out.append([label, dur * 1e-6])
        return out


def profile_slice(fn) -> Slice:
    """``fn()`` under the profiler, then synchronised: the slice's device
    operations, spans and top-level host calls."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN_PREFIX + "slice"):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    ops, spans, cpu_ops, bounds = [], [], [], None
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # the device timeline also carries the host spans' ranges
            if not ev.name.startswith(SPAN_PREFIX):
                ops.append((ev.name, tr.start, tr.end))
        elif ev.name == SPAN_PREFIX + "slice":
            bounds = (tr.start, tr.end)
        elif ev.name.startswith(SPAN_PREFIX):
            spans.append((ev.name[len(SPAN_PREFIX):], tr.start, tr.end))
        elif ev.cpu_parent is None or ev.cpu_parent.name.startswith(
                SPAN_PREFIX):
            cpu_ops.append((ev.name, tr.start, tr.end))
    if bounds is None:
        raise RuntimeError("the profiler lost the slice's own span")
    spans.sort(key=lambda s: s[2] - s[1], reverse=True)
    return Slice(ops, spans, cpu_ops, bounds[0], bounds[1])
