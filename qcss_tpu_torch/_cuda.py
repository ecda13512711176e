"""Build and load the package's CUDA kernels (`csrc/*.cu`).

The sources are compiled with nvcc for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ctypes. The build
runs at first use, into ``build/cuda/<hash of sources and flags>/`` at the
root of the checkout (listed in .gitignore), so a changed source is
rebuilt and an unchanged one is built once per checkout. Nothing here
runs at import time; without nvcc, `load` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
SOURCES = ("uf_stencil_full.cu", "sparse_growth.cu")
HEADERS = ("block_reduce.cuh",)
BUILD_ROOT = _PKG.parent / "build" / "cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
#: nvcc's output (ptxas register and shared-memory report) of the build
#: made by this process, or None when the library was already built
build_log: str | None = None


def nvcc_path() -> str:
    """The nvcc of the CUDA toolkit torch was built against, else PATH's."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of qcss_tpu_torch are built "
            "from qcss_tpu_torch/csrc at first use and need the CUDA toolkit")
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libqcss_kernels.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns the
    library's path."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *(str(CSRC / name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    build_log = proc.stdout + proc.stderr
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.qcss_uf_stencil_full.argtypes = [
            ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr]
        lib.qcss_uf_stencil_full.restype = i32
        lib.qcss_sparse_growth.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr]
        lib.qcss_sparse_growth.restype = i32
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
