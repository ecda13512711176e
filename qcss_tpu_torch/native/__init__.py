"""Native (C++) host kernels, loaded via ctypes (PyTorch port of
`qcss_tpu.native`).

The C++ sources beside this file are byte-for-byte copies of the JAX
package's (`syndrome_table.cc`, `uf_decoder.cc`, `mwpm_decoder.cc`,
`osd_decoder.cc`; a test holds them equal): the syndrome-table
enumerator, the threaded union-find decoder, the exact-MWPM decoder and
the OSD decoders. They are built with g++ on first use into
``build/native/<hash>/libqcss.so`` at the root of the checkout (listed in
.gitignore), or under ``$QCSS_NATIVE_CACHE`` when that is set; the hash
covers the sources, the flags and what ``-march=native`` resolves to, so
a library built for another CPU is rebuilt, not loaded. Each source compiles in its own g++ process, all at once, and the
library appears by an atomic rename, so concurrent processes never load a
half-written file; a lock file lets one of them build while the others
wait. Every entry point returns None when the library is unavailable (no
g++), and its callers fall back to their pure-Python paths
(`ops.gf2`, `decode.uf`, `decode.mwpm`), so the package works without a
toolchain.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCES = ("syndrome_table.cc", "uf_decoder.cc", "mwpm_decoder.cc",
           "osd_decoder.cc")
#: the JAX package's g++ flags: compile, then link into one library
CXX_FLAGS = ("-O3", "-march=native", "-fPIC")
LINK_FLAGS = ("-shared", "-lpthread")
_LIB_NAME = "libqcss.so"
_lib = None
_load_attempted = False
#: seconds the build made by this process took, or None when the library
#: was already built (or could not be)
build_seconds: float | None = None
#: why the library is unavailable, or None
load_error: str | None = None


def _build_root() -> Path:
    d = os.environ.get("QCSS_NATIVE_CACHE")
    if d:
        return Path(d)
    return _DIR.parent.parent / "build" / "native"


@functools.lru_cache(maxsize=None)
def _host_target() -> str:
    """What ``-march=native`` resolves to on this host (g++'s target
    options), so that a library built for another CPU is never loaded
    here; empty without g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        return ""
    proc = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True, timeout=60)
    return proc.stdout


def library_path() -> Path:
    """Where the library of these sources and flags, for this host's CPU,
    is built."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(_host_target().encode())
    return _build_root() / h.hexdigest()[:16] / _LIB_NAME


def build() -> Path:
    """Compile the library unless this exact build exists; returns its
    path. Raises RuntimeError when g++ is missing or fails."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one builder; the rest wait
        if out.exists():
            return out
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
            objs = [str(Path(tmpdir) / (name + ".o")) for name in SOURCES]
            procs = [subprocess.Popen(
                [cxx, *CXX_FLAGS, "-c", "-o", obj, str(_DIR / name)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for name, obj in zip(SOURCES, objs)]
            logs = [p.communicate(timeout=300)[0] for p in procs]
            failed = [f"{name} ({p.returncode}):\n{log}" for name, p, log
                      in zip(SOURCES, procs, logs) if p.returncode != 0]
            if failed:
                raise RuntimeError("g++ failed:\n" + "\n".join(failed))
            tmp = str(Path(tmpdir) / _LIB_NAME)
            proc = subprocess.run([cxx, *objs, "-o", tmp, *LINK_FLAGS],
                                  capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ link failed ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)  # atomic: a loader sees all or nothing
        build_seconds = time.perf_counter() - t0
    return out


def _try_load() -> ctypes.CDLL | None:
    """Load the native library, building it with g++ on first use."""
    global _lib, _load_attempted, load_error
    if _load_attempted:
        return _lib
    _load_attempted = True
    try:
        _lib = _bind(ctypes.CDLL(str(build())))
    except (OSError, AttributeError, RuntimeError,
            subprocess.SubprocessError) as exc:
        _lib = None
        load_error = f"{type(exc).__name__}: {exc}"
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.qcss_syndrome_table.restype = ctypes.c_int32
    lib.qcss_syndrome_table.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        u64p, u64p, u8p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.qcss_rref.restype = ctypes.c_int32
    lib.qcss_rref.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32]
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.qcss_uf_decode_batch.restype = ctypes.c_int32
    lib.qcss_uf_decode_batch.argtypes = [
        i32p, i32p, u32p, u8p,  # edges, qubit, obs, weight
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        u8p, ctypes.c_int64,
        ctypes.c_void_p,  # corrections (nullable)
        u32p,
        ctypes.c_void_p,  # per-shot weights (nullable)
        ctypes.c_int32,
    ]
    lib.qcss_mwpm_create.restype = ctypes.c_void_p
    lib.qcss_mwpm_create.argtypes = [
        i32p, i32p, u32p, u8p,  # edges, qubit, obs, weight
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.qcss_mwpm_destroy.restype = None
    lib.qcss_mwpm_destroy.argtypes = [ctypes.c_void_p]
    lib.qcss_mwpm_decode_batch.restype = ctypes.c_int32
    lib.qcss_mwpm_decode_batch.argtypes = [
        ctypes.c_void_p, u8p, ctypes.c_int64,
        ctypes.c_void_p,  # corrections (nullable)
        u32p, ctypes.c_int32,
    ]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.qcss_osd0_batch.restype = ctypes.c_int32
    lib.qcss_osd0_batch.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32,
        u8p, f32p, ctypes.c_int64, u8p, ctypes.c_int32,
    ]
    lib.qcss_osde_batch.restype = ctypes.c_int32
    lib.qcss_osde_batch.argtypes = [
        u8p, ctypes.c_int32, ctypes.c_int32,
        u8p, f32p, ctypes.c_int64, u8p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    return lib


def available() -> bool:
    return _try_load() is not None


def syndrome_table_native(
    parity_check: np.ndarray,
    max_weight: int,
    stop_on_collision: bool,
    capacity: int | None = None,
):
    """Run the native enumerator. Returns (t, syndromes int array,
    errors [k, n] uint8) or None if the library is unavailable or r > 128.
    Semantics match `ops.gf2.syndrome_table` / `min_weight_table` exactly.
    """
    lib = _try_load()
    if lib is None:
        return None
    h = np.ascontiguousarray(parity_check, dtype=np.uint8) & 1
    r, n = h.shape
    if r > 128:
        return None
    cap = capacity if capacity is not None else min(1 << min(r, 26), 1 << 26)
    syn_lo = np.zeros(cap, dtype=np.uint64)
    syn_hi = np.zeros(cap, dtype=np.uint64)
    errors = np.zeros((cap, n), dtype=np.uint8)
    n_out = ctypes.c_int64(0)
    t_out = ctypes.c_int32(0)
    rc = lib.qcss_syndrome_table(
        h, r, n, max_weight, 1 if stop_on_collision else 0,
        syn_lo, syn_hi, errors.reshape(-1), cap,
        ctypes.byref(n_out), ctypes.byref(t_out),
    )
    if rc != 0:
        return None
    k = n_out.value
    if r <= 64:
        keys = syn_lo[:k].astype(object)
    else:
        keys = (syn_hi[:k].astype(object) << 64) | syn_lo[:k].astype(object)
    return t_out.value, [int(s) for s in keys], errors[:k].copy()


def uf_decode_batch_native(
    edges: np.ndarray,
    edge_qubit: np.ndarray,
    edge_obs: np.ndarray,
    edge_weight: np.ndarray,
    num_nodes: int,
    n_qubits: int,
    syndromes: np.ndarray,
    want_corrections: bool = True,
    n_threads: int | None = None,
    shot_weights: np.ndarray | None = None,
):
    """Batched union-find decode (see `uf_decoder.cc`). Returns
    (corrections [B, n_qubits] uint8 or None, obs_flips [B] uint32), or
    None if the native library is unavailable. ``shot_weights``
    ([B, E] uint8) overrides the per-graph edge weights per shot."""
    lib = _try_load()
    if lib is None:
        return None
    edges = np.ascontiguousarray(edges, dtype=np.int32)
    edge_qubit = np.ascontiguousarray(edge_qubit, dtype=np.int32)
    edge_obs = np.ascontiguousarray(edge_obs, dtype=np.uint32)
    edge_weight = np.ascontiguousarray(edge_weight, dtype=np.uint8)
    syndromes = np.ascontiguousarray(syndromes, dtype=np.uint8)
    batch = syndromes.shape[0]
    if syndromes.shape[1] != num_nodes:
        raise ValueError("syndromes second axis must equal num_nodes")
    if shot_weights is not None:
        shot_weights = np.ascontiguousarray(shot_weights, dtype=np.uint8)
        if shot_weights.shape != (batch, edges.shape[0]):
            raise ValueError("shot_weights must be [batch, num_edges]")
    corr = np.zeros((batch, n_qubits), dtype=np.uint8) if want_corrections else None
    obs = np.zeros(batch, dtype=np.uint32)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    rc = lib.qcss_uf_decode_batch(
        edges.reshape(-1), edge_qubit, edge_obs, edge_weight,
        np.int32(num_nodes), np.int32(edges.shape[0]), np.int32(n_qubits),
        syndromes.reshape(-1), np.int64(batch),
        None if corr is None else corr.ctypes.data_as(ctypes.c_void_p),
        obs,
        None if shot_weights is None
        else shot_weights.ctypes.data_as(ctypes.c_void_p),
        np.int32(n_threads),
    )
    if rc != 0:
        return None
    return corr, obs


class MwpmNativeHandle:
    """Owns a native MWPM decoder handle (graph + threaded APSP tables).
    Create via `mwpm_create_native`; freed on GC or explicit `close()`."""

    def __init__(self, lib, ptr, num_nodes: int, n_qubits: int):
        self._lib = lib
        self._ptr = ptr
        self.num_nodes = num_nodes
        self.n_qubits = n_qubits

    def close(self):
        if self._ptr:
            self._lib.qcss_mwpm_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        # During interpreter teardown the ctypes machinery (or the
        # library itself, or even `sys.is_finalizing`) may already be
        # torn down — leak rather than raise noise.
        try:
            import sys

            if sys.is_finalizing():
                return
            self.close()
        except BaseException:
            pass

    def decode_batch(self, syndromes: np.ndarray, want_corrections: bool = True,
                     n_threads: int | None = None):
        """(corrections [B, n_qubits] uint8 or None, obs [B] uint32).
        Raises ValueError on an unmatchable syndrome."""
        if self._ptr is None:
            raise RuntimeError("handle closed")
        syndromes = np.ascontiguousarray(syndromes, dtype=np.uint8)
        batch = syndromes.shape[0]
        if syndromes.shape[1] != self.num_nodes:
            raise ValueError("syndromes second axis must equal num_nodes")
        corr = (
            np.zeros((batch, self.n_qubits), dtype=np.uint8)
            if want_corrections else None
        )
        obs = np.zeros(batch, dtype=np.uint32)
        if n_threads is None:
            n_threads = min(os.cpu_count() or 1, 16)
        rc = self._lib.qcss_mwpm_decode_batch(
            self._ptr, syndromes.reshape(-1), np.int64(batch),
            None if corr is None else corr.ctypes.data_as(ctypes.c_void_p),
            obs, np.int32(n_threads),
        )
        if rc != 0:
            raise ValueError(
                "unmatchable syndrome (odd defect count in a boundaryless "
                "component)"
            )
        return corr, obs


def mwpm_create_native(
    edges: np.ndarray,
    edge_qubit: np.ndarray,
    edge_obs: np.ndarray,
    edge_weight: np.ndarray,
    num_nodes: int,
    n_qubits: int,
    n_threads: int | None = None,
) -> MwpmNativeHandle | None:
    """Build a native exact-MWPM decoder over a matching graph (see
    `mwpm_decoder.cc`); returns None if the library is unavailable."""
    lib = _try_load()
    if lib is None:
        return None
    edges = np.ascontiguousarray(edges, dtype=np.int32)
    edge_qubit = np.ascontiguousarray(edge_qubit, dtype=np.int32)
    edge_obs = np.ascontiguousarray(edge_obs, dtype=np.uint32)
    edge_weight = np.ascontiguousarray(edge_weight, dtype=np.uint8)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    ptr = lib.qcss_mwpm_create(
        edges.reshape(-1), edge_qubit, edge_obs, edge_weight,
        np.int32(num_nodes), np.int32(edges.shape[0]), np.int32(n_qubits),
        np.int32(n_threads),
    )
    if not ptr:
        return None
    return MwpmNativeHandle(lib, ptr, num_nodes, n_qubits)


def osd0_batch_native(h: np.ndarray, synd: np.ndarray, soft: np.ndarray,
                      n_threads: int | None = None):
    """Batched OSD-0 (see `osd_decoder.cc`): h [r, n], synd [B, r],
    soft [B, n] float32 LLR totals -> [B, n] uint8 estimates, or None if
    the native library is unavailable. Bit-identical to
    `decode.bp.BPDecoder._osd0`'s Python loop."""
    lib = _try_load()
    if lib is None:
        return None
    h = np.ascontiguousarray(h, dtype=np.uint8) & 1
    synd = np.ascontiguousarray(synd, dtype=np.uint8)
    soft = np.ascontiguousarray(soft, dtype=np.float32)
    r, n = h.shape
    batch = synd.shape[0]
    if synd.shape != (batch, r) or soft.shape != (batch, n):
        raise ValueError("shape mismatch")
    out = np.zeros((batch, n), dtype=np.uint8)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    rc = lib.qcss_osd0_batch(h.reshape(-1), np.int32(r), np.int32(n),
                             synd.reshape(-1), soft.reshape(-1),
                             np.int64(batch), out.reshape(-1),
                             np.int32(n_threads))
    if rc != 0:
        return None
    return out


def osde_batch_native(h: np.ndarray, synd: np.ndarray, soft: np.ndarray,
                      osd_order: int, lam1: int, lam2: int,
                      n_threads: int | None = None):
    """Batched order-E ordered-statistics decode (combination sweep over
    the most suspect free columns — see `osd_decoder.cc`), or None if the
    native library is unavailable. osd_order=0 is bit-identical to
    `osd0_batch_native`; order 1 tries single flips among the first
    ``lam1`` free columns, order 2 additionally all pairs among the first
    ``lam2``; the least soft-weight syndrome-satisfying solution wins."""
    lib = _try_load()
    if lib is None:
        return None
    h = np.ascontiguousarray(h, dtype=np.uint8) & 1
    synd = np.ascontiguousarray(synd, dtype=np.uint8)
    soft = np.ascontiguousarray(soft, dtype=np.float32)
    r, n = h.shape
    batch = synd.shape[0]
    if synd.shape != (batch, r) or soft.shape != (batch, n):
        raise ValueError("shape mismatch")
    out = np.zeros((batch, n), dtype=np.uint8)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    rc = lib.qcss_osde_batch(h.reshape(-1), np.int32(r), np.int32(n),
                             synd.reshape(-1), soft.reshape(-1),
                             np.int64(batch), out.reshape(-1),
                             np.int32(n_threads), np.int32(osd_order),
                             np.int32(lam1), np.int32(lam2))
    if rc != 0:
        return None
    return out


def rref_native(mat: np.ndarray):
    """Native GF(2) RREF; returns (rref matrix, rank) or None."""
    lib = _try_load()
    if lib is None:
        return None
    m = np.ascontiguousarray(mat, dtype=np.uint8) & 1
    m = m.copy()
    rank = lib.qcss_rref(m, m.shape[0], m.shape[1])
    return m, int(rank)
