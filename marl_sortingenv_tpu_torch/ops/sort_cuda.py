"""The sorting core of the env step as one hand-written CUDA kernel.

Replaces the TPU kernel
``marl_sortingenv_tpu/ops/sort_pallas.py::sort_material_fused``.  The
kernel (``csrc/sort_material.cu``, CUDA C++ for sm_90a) computes, bit for
bit, what ``sort_material_plain`` computes: the 12 uniforms of
``fastb._sort_uniforms`` and the redistribution of
``fastb.redistribute_u``, returning the new keys.  It runs the sorting core
of every eager step whose state lies on CUDA (the frozen-sort press step of
the training flow); the full-step kernel (``ops/step_cuda.py``) carries its
own copy of the same device code (``csrc/sort_core.cuh``).

The kernel comes in several designs, ``(lanes, cap)``: a group of
``lanes`` lanes of a warp sorts one env, covering supports up to ``cap``
(``DESIGNS``; ``(1, 104)`` is one thread per env at any support).
``DesignSet`` holds the checks on a kernel's designs; kernel 3
(``ops/mvhg_cuda.py``) has its own.
``lanes_for(support, n)`` picks the design from the table that the card's
timings chose (``PERF.md``); a design that is not built, or does not cover
the support, raises.  Both this kernel and the step kernel
(``ops/step_cuda.py``) are built in every design.

``sort_material`` launches the kernel for tensors on CUDA and runs the
plain version for tensors on the CPU.  ``LAUNCHES`` counts the kernel's
launches.  Any ``N >= 1`` works (the TPU kernel needed whole 128-lane rows).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core import fastb as FB
from ..utils import profiling

LAUNCHES = 0

_I32, _F32 = torch.int32, torch.float32


class DesignSet(NamedTuple):
    """The designs ``(lanes, cap)`` one kernel's library builds: a group of
    ``lanes`` lanes of a warp per env, supports up to ``cap``.  The one-lane
    design at ``max_support`` (the largest support the kernel takes) is its
    generic path; a one-lane design below it runs at exactly its cap (a
    compile-time support keeps its sampler's arrays in registers)."""
    designs: tuple
    max_support: int

    def check_support(self, support: int) -> None:
        if not 1 <= support <= self.max_support:
            raise ValueError(f"support {support} is outside the kernels' "
                             f"range [1, {self.max_support}]")

    def covers(self, design, support: int) -> bool:
        """Whether ``design`` runs the sampler at ``support``."""
        lanes, cap = design
        if lanes == 1 and cap < self.max_support:
            return support == cap
        return support <= cap

    def designs_for(self, support: int) -> list:
        """The built designs that cover ``support``."""
        return [d for d in self.designs if self.covers(d, support)]

    def check_design(self, design, support: int) -> tuple:
        """``design`` as a ``(lanes, cap)`` tuple; raises unless it is
        built and covers ``support``."""
        self.check_support(support)
        design = tuple(design)
        if design not in self.designs:
            raise ValueError(f"design {design} is not built; the designs "
                             f"are {self.designs}")
        if not self.covers(design, support):
            raise ValueError(f"design {design} covers supports up to "
                             f"{design[1]}, not {support}"
                             + (" (a one-lane design runs at its cap alone)"
                                if design[0] == 1 else ""))
        return design

    def pick(self, table, support: int, n: int) -> tuple:
        """The first design of ``table`` -- rows (largest support, smallest
        n or 0, design) -- whose bounds admit ``(support, n)`` and which
        covers ``support``."""
        self.check_support(support)
        for max_support, min_n, design in table:
            if (support <= max_support and n >= min_n
                    and self.covers(design, support)):
                return design
        raise ValueError(f"no design for support {support} at n = {n}")

    def bind(self, lib, name: str) -> None:
        """Raise unless the library ``name`` builds exactly these
        designs."""
        fn = getattr(lib, f"{name}_designs")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        want = self.designs
        buf = (ctypes.c_int * (2 * len(want)))()
        k = fn(buf, len(want))
        built = tuple((buf[2 * j], buf[2 * j + 1])
                      for j in range(min(k, len(want))))
        if k != len(want) or built != want:
            raise RuntimeError(f"{name}.cu builds designs {built} (of {k}), "
                               f"the wrapper expects {want}")


# (lanes, cap) of every design the sources of kernels 1 and 2 build
# (STEP_DESIGNS in csrc/step_mono.cu, SORT_DESIGNS in csrc/sort_material.cu);
# (1, 104) is the generic one-lane path, the groups at caps 64 and 128 cover
# supports 33 .. 104.
DESIGNS = ((1, 16), (4, 16), (8, 16), (16, 16), (8, 32), (16, 32), (32, 32),
           (8, 64), (16, 64), (32, 64), (16, 128), (32, 128), (1, 104))
DESIGN_SET = DesignSet(DESIGNS, FB._HG_SUPPORT)

# lanes_for's table: (largest support, smallest n or 0, design), the first
# entry whose bounds admit (support, n) and whose design covers the support
# wins.  From the design sweep of chip_smoke.py on an H100 (PERF.md): the
# fastest design at 4096 .. 65536 envs, switching halfway between measured
# widths; supports 33-64 take the row measured at support 40, 65-104 the
# one at 88.
LANES_TABLE = ((16, 24576, (1, 16)), (16, 0, (16, 16)),
               (32, 12288, (16, 32)), (32, 0, (32, 32)),
               (64, 0, (32, 64)), (104, 0, (32, 128)))


def lanes_for(support: int, n: int) -> tuple:
    """The sorting-core kernel's design ``(lanes, cap)`` for ``support``
    and ``n`` envs."""
    return DESIGN_SET.pick(LANES_TABLE, support, n)


def _library():
    from . import _build
    lib = _build.load("sort_material")
    if not getattr(lib, "_sort_material_bound", False):
        lib.sort_material_launch.restype = ctypes.c_int
        lib.sort_material_launch.argtypes = (
            [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        DESIGN_SET.bind(lib, "sort_material")
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


@profiling.spanned("sort_material.launch")
def sort_material_kernel(counts, acc, keys, support: int, design=None):
    """The sorting core of every env through the kernel (CUDA tensors):
    counts i32[4, N], acc f32[4, N], keys i32[N, 2] -> (leftover, true,
    false) i32[4, N] and the new keys i32[N, 2].  ``design`` is a
    ``(lanes, cap)`` of ``DESIGNS``; by default ``lanes_for(support, N)``."""
    global LAUNCHES
    dev = counts.device
    if dev.type != "cuda":
        raise ValueError(f"the sort kernel needs CUDA tensors, got {dev}")
    n = counts.shape[-1] if counts.dim() == 2 else 0
    if n < 1:
        raise ValueError("the sort kernel needs at least one env")
    lanes, cap = DESIGN_SET.check_design(
        lanes_for(support, n) if design is None else design, support)
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
            new_keys.data_ptr(), lanes, cap, ctypes.c_void_p(stream))
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
