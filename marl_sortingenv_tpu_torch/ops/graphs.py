"""CUDA graphs of the port's steps: capture, replay and one cache.

On CUDA, on ``fastb`` and without a mesh (``eligible``), a step that
dispatches hundreds of small device operations from Python (the
evaluation's eager steps, ``fastb.graphed_step``; the learner's rollout
step, ``ppo.graphed_rollout``) is captured once into a CUDA graph over
static buffers and replayed: the same kernels on the same memory, with one
launch.  ``capture`` is the one hook the CPU tests replace.
"""

from __future__ import annotations

import weakref

import torch

CAPTURES = 0     # steps captured
REPLAYS = 0      # steps replayed


def eligible(engine: str, device, mesh=None) -> bool:
    """Whether steps on ``engine`` and ``device`` replay from CUDA graphs:
    on CUDA, on ``fastb``, without a mesh.  The parity and ``fast`` engines
    read the device from the host; a mesh's step holds a collective."""
    return (engine == "fastb" and torch.device(device).type == "cuda"
            and mesh is None)


def _kernel_counters():
    from . import mvhg_cuda, sort_cuda, step_cuda
    return step_cuda, sort_cuda, mvhg_cuda


def copy_leaves(dst, src) -> None:
    """``d.copy_(s)`` for each pair whose ``d`` is not None, as one
    multi-tensor copy per pair of dtypes: a CUDA graph records a few
    copies, not one per leaf."""
    groups: dict = {}
    for d, s in zip(dst, src):
        if d is None:
            continue
        ds, ss = groups.setdefault((d.dtype, s.dtype), ([], []))
        ds.append(d)
        ss.append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def store(static, new, keep=()) -> tuple:
    """Write each leaf of ``new`` into the leaf of ``static`` at its place
    (None leaves, and leaves that are the static one, are skipped), and
    return ``keep``.  A new leaf, or a kept tensor, that shares memory with
    ``static`` is copied out first, so that no write clobbers what a later
    one reads (a step hands leaves on: the belt's counts become the
    sorter's)."""
    held = {x.untyped_storage().data_ptr() for x in static if x is not None}

    def own(x):
        return x.clone() if x.untyped_storage().data_ptr() in held else x
    keep = tuple(map(own, keep))
    writes = [(s, own(x)) for s, x in zip(static, new)
              if s is not None and x is not s]
    if writes:
        copy_leaves(*zip(*writes))
    return keep


def capture(device, run):
    """``run()`` warmed up once on a side stream, then captured into a CUDA
    graph: (the graph, what the captured ``run()`` returned, the kernel
    launches the capture recorded, which are taken off the counters)."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        mods = _kernel_counters()
        before = [m.LAUNCHES for m in mods]
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            out = run()
        launches = [m.LAUNCHES - n for m, n in zip(mods, before)]
        for m, n in zip(mods, before):
            m.LAUNCHES = n
    return graph, out, launches


class Graph:
    """``run()`` captured on ``device`` (``capture``; counted in
    ``CAPTURES``).  ``out`` is what the captured ``run()`` returned: static
    memory that each replay rewrites."""

    def __init__(self, device, run):
        global CAPTURES
        self._graph, self.out, self._launches = capture(device, run)
        CAPTURES += 1

    def replay(self) -> None:
        """One replay, counted in ``REPLAYS``, with the kernel launches its
        capture recorded added to ``step_cuda``/``sort_cuda``/
        ``mvhg_cuda.LAUNCHES``."""
        global REPLAYS
        self._graph.replay()
        for m, k in zip(_kernel_counters(), self._launches):
            m.LAUNCHES += k
        REPLAYS += 1


# step function -> {the rest of the key: (entry, the agents' parameters)}
_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _key_part(x):
    if isinstance(x, torch.nn.Module):
        return tuple((p.data_ptr(), tuple(p.shape), p.dtype)
                     for p in x.parameters())
    return x


def _drop(fn_ref, key) -> None:
    if fn_ref() is not None:
        _CACHE.get(fn_ref(), {}).pop(key, None)


def cached(fn, key: tuple, buffers, make):
    """The graphed form of the step function ``fn``, ``make()`` at its
    first request.  Keyed on ``fn`` itself (a patched step is captured
    anew), on ``key`` (the caller's configuration and the step's other
    arguments; an agent, an ``nn.Module``, by its parameters' storages),
    on the shapes, dtypes and device of the static ``buffers``, and on
    whether products may run in TF32.  Kept while ``fn`` and every agent in
    ``key`` live: ``fn`` is held weakly (so the entry must not hold it; a
    capture keeps no Python object of its step), an agent only through its
    parameters, which the graph reads.  So a rollout's graph goes with the
    iteration whose step function keys it, an evaluation's model graph
    with its agents; the graph of a module's own step function and no
    agent stays for the life of the process."""
    agents = [x for x in key if isinstance(x, torch.nn.Module)]
    full = (tuple(map(_key_part, key)),
            tuple(None if x is None else (tuple(x.shape), x.dtype)
                  for x in buffers),
            next(x.device for x in buffers if x is not None),
            torch.backends.cuda.matmul.allow_tf32)
    entries = _CACHE.setdefault(fn, {})
    if full not in entries:
        entries[full] = (make(), [p.detach() for a in agents
                                  for p in a.parameters()])
        for a in agents:
            weakref.finalize(a, _drop, weakref.ref(fn), full)
    return entries[full][0]
