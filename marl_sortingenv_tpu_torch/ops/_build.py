"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/*.cu`` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` and loaded with ``ctypes``.  The build
goes to ``build/kernels/`` at the root of the checkout and is keyed on a
hash of every source and of the flags, so a changed source is rebuilt and
an unchanged one is loaded as it is.  All sources are compiled in
parallel, one ``nvcc`` each.
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
        os.replace(tmp, out)
    return {src.stem: _lib_path(src.stem, digest)
            for src in sorted(CSRC.glob("*.cu"))}


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        _LIBS[name] = lib
    return lib
