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
SOURCES = ("uf_stencil_full.cu", "uf_stencil_staged.cu", "sparse_growth.cu",
           "gf2_packed.cu", "chp_measure.cu")
HEADERS = ("block_reduce.cuh", "residency.cuh", "uf_stencil_common.cuh")
BUILD_ROOT = _PKG.parent / "build" / "cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

#: the most dynamic shared memory one block can have on the card (227 KB)
MAX_SHARED_BYTES = 232448

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
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libqcss_kernels.so"


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns the
    library's path. Each source compiles in its own nvcc process, all at
    once, and one more nvcc links the objects."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
        objs = [str(Path(tmpdir) / (name + ".o")) for name in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(name, p.returncode, log) for name, p, log
                  in zip(SOURCES, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        tmp = str(Path(tmpdir) / out.name)
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        build_log = "".join(logs)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.qcss_uf_stencil_full.argtypes = [
            ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, i32, i32, i32, i32,
            ptr, ptr, ptr, ptr, ptr]
        lib.qcss_uf_stencil_full.restype = i32
        lib.qcss_uf_stencil_full_config.argtypes = [
            i32, i32, i32, i32, i32, ptr]
        lib.qcss_uf_stencil_full_config.restype = i32
        lib.qcss_stencil_staged_config.argtypes = [
            i32, i32, i32, i32, i32, ptr, ptr]
        lib.qcss_stencil_staged_config.restype = i32
        lib.qcss_stencil_prop.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr]
        lib.qcss_stencil_prop.restype = i32
        lib.qcss_stencil_act.argtypes = [
            ptr, ptr, ptr, i32, i32, i32, ptr, ptr]
        lib.qcss_stencil_act.restype = i32
        lib.qcss_stencil_round.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr,
            ptr]
        lib.qcss_stencil_round.restype = i32
        lib.qcss_sparse_growth.argtypes = [
            ptr, i64, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr,
            ptr]
        lib.qcss_sparse_growth.restype = i32
        lib.qcss_sparse_growth_config.argtypes = [i32, ptr]
        lib.qcss_sparse_growth_config.restype = i32
        lib.qcss_syndromes_packed.argtypes = [
            ptr, ptr, i64, i32, i32, ptr, ptr]
        lib.qcss_syndromes_packed.restype = i32
        lib.qcss_syndromes_packed_t.argtypes = [
            ptr, ptr, i64, i32, i32, ptr, ptr]
        lib.qcss_syndromes_packed_t.restype = i32
        lib.qcss_decode_residual_packed.argtypes = [
            ptr, ptr, ptr, i64, i32, i32, ptr, ptr]
        lib.qcss_decode_residual_packed.restype = i32
        lib.qcss_gf2_packed_config.argtypes = [i32, i32, i32, ptr, ptr, ptr]
        lib.qcss_gf2_packed_config.restype = i32
        lib.qcss_chp_measure.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, ptr, ptr, ptr,
            ptr, ptr]
        lib.qcss_chp_measure.restype = i32
        lib.qcss_chp_measure_config.argtypes = [i32, i32, i32, ptr]
        lib.qcss_chp_measure_config.restype = i32
        _lib = lib
    return _lib


def resolve_device(device) -> "torch.device":
    """``device`` as a `torch.device`. The port's entry points default to
    the card; asked for CUDA where there is none, this raises rather than
    run on the CPU."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: qcss_tpu_torch runs on the card by default; "
            "pass device='cpu' to run the plain PyTorch versions")
    return device


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU): timers around device work call this at each mark."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
