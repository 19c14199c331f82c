"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/*.cu`` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` and loaded with ``ctypes``.  The build
goes to ``build/kernels/`` at the root of the checkout and is keyed on a
hash of every source and of the flags, so a changed source is rebuilt and
an unchanged one is loaded as it is.  All sources are compiled in
parallel, one ``nvcc`` each.  ``DesignSet`` holds the checks on the designs
each kernel's wrapper lists and its library builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# --fmad=false: no multiply-add is contracted unless the source writes
# __fmaf_rn, so float rounding follows the source expression by expression
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}      # source name -> nvcc's -Xptxas -v output
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str, digest: str) -> Path:
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all at once."""
    digest = _digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = _lib_path(src.stem, digest)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        todo[src.stem] = (proc, tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in todo.items():
        log, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    return {src.stem: _lib_path(src.stem, digest)
            for src in sorted(CSRC.glob("*.cu"))}


def ptxas_usage(name: str) -> dict:
    """``{mangled kernel name: (registers, stack bytes)}`` of the library
    built from ``csrc/<name>.cu``, from nvcc's ``-Xptxas -v`` log kept
    beside it."""
    log = _lib_path(name, _digest()).with_suffix(".log")
    usage, entry = {}, None
    for line in (log.read_text().splitlines() if log.exists() else ()):
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and "registers" in line:
            regs = int(line.split("Used ")[1].split(" registers")[0])
            stack = (int(line.split(" bytes cumulative stack")[0]
                         .rsplit(" ", 1)[1])
                     if "cumulative stack" in line else 0)
            usage[entry] = (regs, stack)
            entry = None
    return usage


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        _LIBS[name] = lib
    return lib


class DesignSet(NamedTuple):
    """The designs ``(lanes, cap)`` one kernel's library builds: a group of
    ``lanes`` lanes of a warp per env, supports up to ``cap``; a one-lane
    design runs at exactly its cap (a compile-time support keeps its
    sampler's arrays in registers).  ``max_support`` is the largest support
    the kernel takes."""
    designs: tuple
    max_support: int

    def check_support(self, support: int) -> None:
        if not 1 <= support <= self.max_support:
            raise ValueError(f"support {support} is outside the kernels' "
                             f"range [1, {self.max_support}]")

    def covers(self, design, support: int) -> bool:
        """Whether ``design`` runs the sampler at ``support``."""
        lanes, cap = design
        return support == cap if lanes == 1 else support <= cap

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
