"""The sorting core of the env step as one hand-written CUDA kernel.

Replaces the TPU kernel
``marl_sortingenv_tpu/ops/sort_pallas.py::sort_material_fused``.  The
kernel (``csrc/sort_material.cu``, CUDA C++ for sm_90a, one thread per env)
computes, bit for bit, what ``sort_material_plain`` computes: the 12
uniforms of ``fastb._sort_uniforms`` and the redistribution of
``fastb.redistribute_u``, returning the new keys.  It runs the sorting core
of every eager step whose state lies on CUDA (the frozen-sort press step of
the training flow); the full-step kernel (``ops/step_cuda.py``) carries its
own copy of the same device code (``csrc/sort_core.cuh``).

``sort_material`` launches the kernel for tensors on CUDA and runs the
plain version for tensors on the CPU.  ``LAUNCHES`` counts the kernel's
launches.  Any ``N >= 1`` works (the TPU kernel needed whole 128-lane rows).
"""

from __future__ import annotations

import ctypes

import torch

from ..core import fastb as FB

LAUNCHES = 0

_I32, _F32 = torch.int32, torch.float32


def _library():
    from . import _build
    lib = _build.load("sort_material")
    if not getattr(lib, "_sort_material_bound", False):
        lib.sort_material_launch.restype = ctypes.c_int
        lib.sort_material_launch.argtypes = (
            [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8)
        lib._sort_material_bound = True
    return lib


def check_operand(name: str, x: torch.Tensor, shape: tuple, dtype,
                  dev: torch.device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``dev``."""
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected {dtype} {shape} on {dev}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_support(support: int) -> None:
    if not 1 <= support <= FB._HG_SUPPORT:
        raise ValueError(f"support {support} is outside the kernels' range "
                         f"[1, {FB._HG_SUPPORT}]")


def sort_material_kernel(counts, acc, keys, support: int):
    """The sorting core of every env through the kernel (CUDA tensors):
    counts i32[4, N], acc f32[4, N], keys i32[N, 2] -> (leftover, true,
    false) i32[4, N] and the new keys i32[N, 2]."""
    global LAUNCHES
    dev = counts.device
    if dev.type != "cuda":
        raise ValueError(f"the sort kernel needs CUDA tensors, got {dev}")
    n = counts.shape[-1] if counts.dim() == 2 else 0
    if n < 1:
        raise ValueError("the sort kernel needs at least one env")
    check_support(support)
    check_operand("counts", counts, (4, n), _I32, dev)
    check_operand("acc", acc, (4, n), _F32, dev)
    check_operand("keys", keys, (n, 2), _I32, dev)
    leftover, true_arr, false_arr = (torch.empty((4, n), dtype=_I32, device=dev)
                                     for _ in range(3))
    new_keys = torch.empty((n, 2), dtype=_I32, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.sort_material_launch(
            n, support, counts.data_ptr(), acc.data_ptr(), keys.data_ptr(),
            leftover.data_ptr(), true_arr.data_ptr(), false_arr.data_ptr(),
            new_keys.data_ptr(), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"sort_material kernel launch failed: "
                           f"cudaError_t {rc}")
    LAUNCHES += 1
    return leftover, true_arr, false_arr, new_keys


def sort_material_plain(counts, acc, keys, support: int):
    """The kernel's plain PyTorch version, on the tensors' device:
    ``fastb._sort_uniforms`` then ``fastb.redistribute_u``.  It launches no
    kernel."""
    us, new_keys = FB._sort_uniforms(keys)
    leftover, true_arr, false_arr = FB.redistribute_u(counts, acc, us,
                                                      support)
    return leftover, true_arr, false_arr, new_keys


def sort_material(counts, acc, keys, support: int):
    """The sorting core: the CUDA kernel for tensors on CUDA, the plain
    version for tensors on the CPU.  Any other device raises."""
    dev = counts.device
    if dev.type == "cuda":
        return sort_material_kernel(counts, acc, keys, support)
    if dev.type == "cpu":
        return sort_material_plain(counts, acc, keys, support)
    raise ValueError(f"sort_material runs on CUDA or the CPU, got {dev}")
