"""The sorting redistribution given pre-drawn uniforms, as one hand-written
CUDA kernel.

Replaces the TPU kernel
``marl_sortingenv_tpu/ops/mvhg_pallas.py::sort_redistribute``.  The kernel
(``csrc/sort_redistribute.cu``, CUDA C++ for sm_90a, one thread per env)
computes, bit for bit, what ``sort_redistribute_plain`` computes:
``fastb.redistribute_u`` on the transposed operands, at the same support.
It keeps the JAX kernel's batch-first layout: counts i32[N, 4], acc
f32[N, 4], uniforms f32[N, 12] (station-major) -> leftover, true, false
i32[N, 4].

The JAX kernel's default ``SUPPORT = 128`` was its lane width; here the
support is the engine's bound (``fastb._support_for``), at most 104.

``sort_redistribute`` launches the kernel for tensors on CUDA and runs the
plain version for tensors on the CPU.  ``LAUNCHES`` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import fastb as FB
from .sort_cuda import check_operand, check_support

LAUNCHES = 0

_I32, _F32 = torch.int32, torch.float32


def _library():
    from . import _build
    lib = _build.load("sort_redistribute")
    if not getattr(lib, "_sort_redistribute_bound", False):
        lib.sort_redistribute_launch.restype = ctypes.c_int
        lib.sort_redistribute_launch.argtypes = (
            [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7)
        lib._sort_redistribute_bound = True
    return lib


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, or a fresh copy when its data is not 16-byte aligned
    (the kernel reads rows as 16-byte vectors)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def sort_redistribute_kernel(counts, acc, uniforms, support: int):
    """The redistribution of every env through the kernel (CUDA
    tensors)."""
    global LAUNCHES
    dev = counts.device
    if dev.type != "cuda":
        raise ValueError(f"the redistribution kernel needs CUDA tensors, "
                         f"got {dev}")
    n = counts.shape[0] if counts.dim() == 2 else 0
    if n < 1:
        raise ValueError("the redistribution kernel needs at least one env")
    check_support(support)
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
            uniforms.data_ptr(), *[o.data_ptr() for o in outs],
            ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"sort_redistribute kernel launch failed: "
                           f"cudaError_t {rc}")
    LAUNCHES += 1
    return tuple(outs)


def sort_redistribute_plain(counts, acc, uniforms, support: int):
    """The kernel's plain PyTorch version, on the tensors' device."""
    check_support(support)
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
