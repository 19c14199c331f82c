"""The sorting redistribution given pre-drawn uniforms, as one hand-written
CUDA kernel.

Replaces the TPU kernel
``marl_sortingenv_tpu/ops/mvhg_pallas.py::sort_redistribute``.  The kernel
(``csrc/sort_redistribute.cu``, CUDA C++ for sm_90a) computes, bit for
bit, what ``sort_redistribute_plain`` computes: ``fastb.redistribute_u``
on the transposed operands, at the same support.  It keeps the JAX
kernel's batch-first layout: counts i32[N, 4], acc f32[N, 4], uniforms
f32[N, 12] (station-major) -> leftover, true, false i32[N, 4].

It takes the JAX kernel's whole range, supports 1 to 128 (``SUPPORT``),
beyond the engine's cap of 104 that kernels 1 and 2 keep.  Like them it
comes in designs ``(lanes, cap)``, a group of ``lanes`` lanes of a warp
per env (``REDISTRIBUTE_DESIGNS``, its own list; ``(1, 16)`` is one thread
per env at support 16 alone, and ``(32, 128)`` covers every support);
``lanes_for(support, n)`` picks one from the table that the card's
timings chose (``PERF.md``), and a design that is not built, or does not
cover the support, raises.

``sort_redistribute`` launches the kernel for tensors on CUDA and runs the
plain version for tensors on the CPU.  ``LAUNCHES`` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import fastb as FB
from ..utils import profiling
from ._build import DesignSet
from .sort_cuda import check_operand

LAUNCHES = 0

_I32, _F32 = torch.int32, torch.float32

# The largest support: the JAX kernel's lane width, mvhg_pallas.SUPPORT.
SUPPORT = 128

# (lanes, cap) of every design csrc/sort_redistribute.cu builds
# (REDISTRIBUTE_DESIGNS there): each the fastest somewhere in the sweep.
REDISTRIBUTE_DESIGNS = ((1, 16), (16, 16), (32, 32), (32, 64), (32, 128))
DESIGN_SET = DesignSet(REDISTRIBUTE_DESIGNS, SUPPORT)

# lanes_for's table (see _build.DesignSet.pick), from the design sweep
# of chip_smoke.py on an H100 (PERF.md): the fastest design at 4096 ..
# 65536 envs, switching halfway between measured widths; supports 33-64
# take the row measured at support 40, 65-128 the one at 88 and 128.
LANES_TABLE = ((16, 12288, (1, 16)), (16, 0, (16, 16)), (32, 0, (32, 32)),
               (64, 0, (32, 64)), (128, 0, (32, 128)))


def lanes_for(support: int, n: int) -> tuple:
    """The redistribution kernel's design ``(lanes, cap)`` for ``support``
    and ``n`` envs."""
    return DESIGN_SET.pick(LANES_TABLE, support, n)


def _library():
    from . import _build
    lib = _build.load("sort_redistribute")
    if not getattr(lib, "_sort_redistribute_bound", False):
        lib.sort_redistribute_launch.restype = ctypes.c_int
        lib.sort_redistribute_launch.argtypes = (
            [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        DESIGN_SET.bind(lib, "sort_redistribute")
        lib._sort_redistribute_bound = True
    return lib


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, or a fresh copy when its data is not 16-byte aligned
    (the kernel reads rows as 16-byte vectors)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


@profiling.spanned("sort_redistribute.launch")
def sort_redistribute_kernel(counts, acc, uniforms, support: int,
                             design=None):
    """The redistribution of every env through the kernel (CUDA tensors).
    ``design`` is a ``(lanes, cap)`` of ``REDISTRIBUTE_DESIGNS``; by
    default ``lanes_for(support, N)``."""
    global LAUNCHES
    dev = counts.device
    if dev.type != "cuda":
        raise ValueError(f"the redistribution kernel needs CUDA tensors, "
                         f"got {dev}")
    n = counts.shape[0] if counts.dim() == 2 else 0
    if n < 1:
        raise ValueError("the redistribution kernel needs at least one env")
    lanes, cap = DESIGN_SET.check_design(
        lanes_for(support, n) if design is None else design, support)
    check_operand("counts", counts, (n, 4), _I32, dev)
    check_operand("acc", acc, (n, 4), _F32, dev)
    check_operand("uniforms", uniforms, (n, 12), _F32, dev)
    counts, acc, uniforms = (_aligned(x) for x in (counts, acc, uniforms))
    outs = [torch.empty((n, 4), dtype=_I32, device=dev) for _ in range(3)]
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.sort_redistribute_launch(
            n, support, counts.data_ptr(), acc.data_ptr(),
            uniforms.data_ptr(), *[o.data_ptr() for o in outs], lanes, cap,
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"sort_redistribute kernel launch failed: "
                           f"cudaError_t {rc}")
    LAUNCHES += 1
    return tuple(outs)


def sort_redistribute_plain(counts, acc, uniforms, support: int):
    """The kernel's plain PyTorch version, on the tensors' device."""
    DESIGN_SET.check_support(support)
    outs = FB.redistribute_u(counts.T, acc.T, uniforms.T, support)
    return tuple(o.T.contiguous() for o in outs)


def sort_redistribute(counts, acc, uniforms, support: int):
    """The redistribution: the CUDA kernel for tensors on CUDA, the plain
    version for tensors on the CPU.  Any other device raises."""
    dev = counts.device
    if dev.type == "cuda":
        return sort_redistribute_kernel(counts, acc, uniforms, support)
    if dev.type == "cpu":
        return sort_redistribute_plain(counts, acc, uniforms, support)
    raise ValueError(f"sort_redistribute runs on CUDA or the CPU, got {dev}")
