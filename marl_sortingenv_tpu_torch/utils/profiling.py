"""Tracing — the port of ``marl_sortingenv_tpu.utils.profiling`` on
``torch.profiler``, with the program's own spans.

* ``span(name, **attrs)`` — a context manager around one phase of the
  program.  Tracing is on exactly while a torch profiler runs
  (``torch.autograd.profiler._is_profiler_enabled``): the benchmark's
  profiled slice and ``trace()`` turn it on, and nothing else does.  While
  it is on, a span adds one record to the current profiling session: its
  name, its start and end by ``time.time_ns()``, the index of the span
  open around it and its attributes.  Each start of the profiler begins a
  new session.  While it is off, ``span`` returns one
  shared no-op object.  A span never calls ``record_function``, launches
  nothing, synchronises nothing and reads nothing from the device, so the
  profiler's device timeline is the same with spans as without.  Spans
  nest by a stack of the thread that opens them: the program opens them
  from one thread.
* ``spanned(name, **attrs)`` — the decorator form: each call inside
  ``span(name, **attrs)``.
* ``spans()``, ``summary()`` — the last session's records, and per span
  name its count and mean total and self time (the duration less what
  its child spans cover).
* ``trace(log_dir)`` — profiles the block (CPU activity, and CUDA's where a
  card is present) and writes a Chrome trace (``chrome://tracing``,
  Perfetto) under ``log_dir`` with the session's spans on a track of
  their own; the ``Trace`` it yields then holds the block's device-idle
  time by innermost open span.

Every profiler event's time is ``trace_start_ns`` plus its relative time,
on the wall clock that ``time.time_ns()`` reads, so a span stamped here
lies on the device's timeline as it is: ``trace_us`` converts.
"""

from __future__ import annotations

import array
import contextlib
import dataclasses
import functools
import json
import os
import time
from collections import defaultdict
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity

OUTSIDE = "outside any span"


class Record(NamedTuple):
    """One span: ``name``, ``start_ns`` and ``end_ns`` (``time.time_ns``;
    ``end_ns`` is None while it is open), ``parent`` (the index of the
    span open around it in the session's list, or None) and ``attrs``."""
    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    attrs: dict


class _Session:
    """A session's spans, in columns of names, ints and shared attribute
    dicts: a span keeps no object of its own, so recording adds nothing
    for Python's garbage collector to count (each object it keeps would
    bring the next collection nearer, and one over a large heap takes up
    to seconds)."""
    __slots__ = ("names", "start", "end", "parent", "attrs", "stack")

    def __init__(self):
        self.names: list = []
        self.start, self.end, self.parent = (array.array("q")
                                             for _ in range(3))
        self.attrs: list = []     # a shared dict of _ATTRS, or None
        self.stack: list = []     # indices of the open spans


_session = _Session()
# one dict per distinct set of attributes (their values are hashable)
_ATTRS: dict = {}


def _start_session(start=_autograd_profiler._run_on_profiler_start):
    global _session
    start()
    _session = _Session()


# every start of a torch profiler (``torch.profiler.profile``, the
# autograd profiler, ``trace`` below) passes through this hook
_autograd_profiler._run_on_profiler_start = _start_session


class _Span:
    __slots__ = ("name", "attrs", "session", "index")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        s = self.session = _session
        self.index = len(s.names)
        s.names.append(self.name)
        s.parent.append(s.stack[-1] if s.stack else -1)
        s.attrs.append(_ATTRS.setdefault(tuple(self.attrs.items()),
                                         self.attrs) if self.attrs else None)
        s.end.append(-1)
        s.stack.append(self.index)
        s.start.append(time.time_ns())
        return self

    def __exit__(self, exc_type, exc, tb):
        self.session.end[self.index] = time.time_ns()
        self.session.stack.pop()
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NO_SPAN = _NoSpan()


def span(name: str, **attrs):
    """A span of the program's phase ``name`` (a context manager); a
    shared no-op while no profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, attrs)


def spanned(name: str, **attrs):
    """Decorator: every call of the function inside ``span(name,
    **attrs)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name, **attrs):
                return fn(*args, **kwargs)
        return inner
    return wrap


def spans() -> list:
    """The ``Record``s of the last profiling session, in the order their
    spans opened."""
    s = _session
    return [Record(name, s.start[i], None if s.end[i] < 0 else s.end[i],
                   None if s.parent[i] < 0 else s.parent[i],
                   dict(s.attrs[i] or {}))
            for i, name in enumerate(s.names)]


def summary() -> dict:
    """Per span name of the last session's closed spans: ``count``,
    ``mean_us`` (total time) and ``self_us`` (total less the time its child
    spans cover), both means over the count."""
    recs = spans()
    child_ns = [0] * len(recs)
    for r in recs:
        if r.parent is not None and r.end_ns is not None:
            child_ns[r.parent] += r.end_ns - r.start_ns
    acc = defaultdict(lambda: [0, 0, 0])
    for r, c in zip(recs, child_ns):
        if r.end_ns is None:
            continue
        a = acc[r.name]
        a[0] += 1
        a[1] += r.end_ns - r.start_ns
        a[2] += r.end_ns - r.start_ns - c
    return {name: {"count": n, "mean_us": tot / n / 1e3,
                   "self_us": own / n / 1e3}
            for name, (n, tot, own) in acc.items()}


def trace_us(ns: int, base_ns: int) -> float:
    """A ``time.time_ns()`` stamp in us after ``base_ns``: the time base of
    the profiler's events (``trace_start_ns``) or of its Chrome trace
    (``baseTimeNanoseconds``)."""
    return (ns - base_ns) / 1e3


def _innermost(records: list, t0: int, t1: int) -> list:
    """``[t0, t1]`` cut into (start, end, name) pieces, in order, each
    named by the innermost span open over it (``OUTSIDE`` where none
    is).  Spans nest, and ``records`` are in the order they opened."""
    pieces, open_ = [], []            # open_: (name, end) of the stack

    def cut(upto):
        nonlocal cur
        if upto > cur:
            pieces.append((cur, upto, open_[-1][0] if open_ else OUTSIDE))
            cur = upto

    cur = t0
    for r in records:
        s = min(max(r.start_ns, t0), t1)
        e = t1 if r.end_ns is None else min(max(r.end_ns, t0), t1)
        while open_ and open_[-1][1] <= s:
            cut(open_[-1][1])
            open_.pop()
        cut(s)
        open_.append((r.name, e))
    while open_:
        cut(open_[-1][1])
        open_.pop()
    cut(t1)
    return pieces


def idle_by_span(device_ns: list, records: list, t0: int, t1: int) -> dict:
    """Seconds of ``[t0, t1]`` with no device interval of ``device_ns``
    ((start, end) pairs) running, by the innermost span open (``OUTSIDE``
    where none is, always present); the values sum to the block's idle
    time."""
    busy = []
    for s, e in sorted((max(s, t0), min(e, t1)) for s, e in device_ns):
        if e <= s:
            continue
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    idle, cur = [], t0
    for s, e in busy:
        if s > cur:
            idle.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        idle.append((cur, t1))
    out = {OUTSIDE: 0.0}
    i = 0
    for s, e, name in _innermost(records, t0, t1):
        while i < len(idle) and idle[i][1] <= s:
            i += 1
        j = i
        while j < len(idle) and idle[j][0] < e:
            out[name] = out.get(name, 0.0) + (
                min(e, idle[j][1]) - max(s, idle[j][0])) * 1e-9
            j += 1
    return out


@dataclasses.dataclass
class Trace:
    """What ``trace`` yields: the profiler, and after the block the Chrome
    trace's ``path``, the block's ``window_s`` and its device-idle
    seconds by innermost open span, ``idle_s``."""
    profiler: torch.profiler.profile
    path: Optional[str] = None
    window_s: float = 0.0
    idle_s: dict = dataclasses.field(default_factory=dict)


def _device_intervals(prof) -> list:
    """(start, end) ns of the device's operations (kernels, copies,
    fills); the profiler's echoes of ``record_function`` ranges on the
    device's timeline are left out."""
    return [(e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation()]


def _add_spans(path: str, records: list, pid: int) -> None:
    """The spans as complete events on a track of their own in the Chrome
    trace at ``path``, on its time base."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    ev = doc.setdefault("traceEvents", [])
    ev.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
               "args": {"name": "program spans"}})
    for r in records:
        if r.end_ns is None:
            continue
        ev.append({"ph": "X", "cat": "program_span", "name": r.name,
                   "pid": pid, "tid": 0, "ts": trace_us(r.start_ns, base),
                   "dur": (r.end_ns - r.start_ns) / 1e3,
                   "args": {"parent": r.parent, **{
                       k: v if isinstance(v, (int, float, bool)) else str(v)
                       for k, v in r.attrs.items()}}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str = "./log/profile"):
    """Profile the block; yields a ``Trace``.  On exit the block waits for
    the card, and the Chrome trace, with the program's spans, is written to
    ``<log_dir>/trace_<pid>_<ns>.json``."""
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        out = Trace(prof)
        t0 = time.time_ns()
        yield out
        if cuda:
            torch.cuda.synchronize()
        t1 = time.time_ns()
    records = spans()
    out.window_s = (t1 - t0) * 1e-9
    out.idle_s = idle_by_span(_device_intervals(prof), records, t0, t1)
    out.path = os.path.join(log_dir,
                            f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(out.path)
    _add_spans(out.path, records, os.getpid())
