"""What the program's own spans read (``marl_sortingenv_tpu_torch.utils.
profiling``): the records of its last profiling session, which in a
traced run is the profiled slice.  A program without spans gives nothing
to read, and its readers return None."""

from __future__ import annotations


def _profiling():
    try:
        from marl_sortingenv_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "summary") else None


def records() -> list:
    p = _profiling()
    return p.spans() if p is not None else []


def summary() -> dict:
    p = _profiling()
    return p.summary() if p is not None else {}


def count(name: str) -> int:
    s = summary().get(name)
    return s["count"] if s else 0


def mean_us(name: str):
    """The mean duration of the span ``name``, in us, or None."""
    s = summary().get(name)
    return s["mean_us"] if s else None


def total_us_within(name: str, within: tuple) -> float:
    """The summed duration, in us, of the spans ``name`` that have a span
    named in ``within`` around them."""
    recs = records()
    total = 0
    for r in recs:
        if r.name != name or r.end_ns is None:
            continue
        p = r.parent
        while p is not None and recs[p].name not in within:
            p = recs[p].parent
        if p is not None:
            total += r.end_ns - r.start_ns
    return total / 1e3
