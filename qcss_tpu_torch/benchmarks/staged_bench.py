"""Times of the staged stencil kernels K3 (`stencil_prop`), K4
(`stencil_act`) and K5 (`stencil_round`) on the card, and of the two
staged decodes that call them, at the d=11 fused memory's shape.

The graph and detectors are `chip_smoke.py`'s: the d=11, R=11
circuit-level DEM graph (`NoiseModel(p_gate2=2e-3, p_meas=1e-2)`, V=721)
and B=16384 sampled rows (generator seed 1234). The states entering growth
rounds 1-6 of the fused staged decode are walked with the plain pieces
(`device_uf_staged.round_inputs`); per round, by CUDA events:

* ``ms``: device time a launch of the bare C entry point on preallocated
  outputs, from a CUDA graph of launches (at B=16384 every input exceeds
  the 50 MB L2, so each launch finds its data in device memory). The
  kernel is judged against its bound on this one;
* ``wrapper_ms``: the `device_uf_cuda` wrapper back to back, its checks,
  allocations and ctypes call included;
* ``plain_ms`` (round 2 only): the plain version (`device_uf._prop_plain`,
  `_act_plain`, `_round_plain`); no single PyTorch call computes any of
  the three (``library_ms`` null);
* ``copy_ms`` (round 2 only): a yardstick of the memory rate, one
  `Tensor.copy_` from a CUDA graph that moves as many bytes as the
  kernel's C interface reads and writes (``io_bytes``: its planes as they
  are, int32 where the bound counts a byte; half of them read, half
  written);

beside the bound (`profiling.bound`): each input byte read once and each
output byte written once at 3.35 TB/s, int32 planes for labels and
supports, one byte an element for every 0/1 plane (K3's and K4's masks,
K4's act, K5's seed and grew), and the tables each kernel reads. K3 and
K5 are the controls when K4 changes. Each kernel's output is held against
its plain version first, and the launch plans of K3, K4 and K5 are
printed where the checkout reports them.

Then each whole decode (`decode_stencil_staged`: K3 and K4 a round;
`decode_stencil_fused`: K5 a round), host-fenced, against K1's labels.

``--phases`` builds `csrc/uf_stencil_staged.cu` alone again with
QCSS_STAGED_PHASES (clock counters at the phase boundaries of K3, K4 and
K5: lane 0 of every warp adds each phase's cycles to a device counter) into
`build/cuda-phases/` and reports cycles a shot in each phase on the
round-2 state.

The script needs only the C entry points, the wrappers and
`device_uf_staged.round_inputs`, so it also times an older checkout: copy
it and `profiling.py` into that checkout's `qcss_tpu_torch/benchmarks/`
(and `decode/device_uf_staged.py` into its `decode/` where that one lacks
`round_inputs`), and run it there.

    python -m qcss_tpu_torch.benchmarks.staged_bench [--reps N] [--phases]

prints one JSON line per (kernel, round), per decode and per kernel's
phases, the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import tempfile
import time

import torch

from qcss_tpu_torch import _cuda
from qcss_tpu_torch.benchmarks.device_uf_bench import build_pipeline
from qcss_tpu_torch.benchmarks.profiling import bound, cuda_ms, graph_ms
from qcss_tpu_torch.codes.families import rotated_surface
from qcss_tpu_torch.decode import device_uf as duf
from qcss_tpu_torch.decode import device_uf_cuda
from qcss_tpu_torch.decode import device_uf_staged as dstaged
from qcss_tpu_torch.sim.noise import NoiseModel

D = 11
ROUNDS = 11
BATCH = 16384
SEED = 1234
STAGED_ROUNDS = 6
#: K3's, K4's and K5's phases, by the index of their clock counter
PHASES = {"K3": {0: "label row in", 1: "masks in, folded; members",
                 2: "propagation", 3: "labels out, reset"},
          "K4": {4: "act row and pass bytes in, folded",
                 5: "frontier", 6: "spread", 7: "row out, reset"},
          "K5": {8: "label and seed rows in",
                 9: "supports through, folded", 10: "members, activity",
                 11: "growth, grew row out", 12: "propagation",
                 13: "labels out, reset"}}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def setup(dev, batch: int = BATCH):
    """(dg, detectors [B, num_nodes]) of `chip_smoke.py`'s d=11 memory."""
    graph, _, _, sample_dets = build_pipeline(
        rotated_surface(D), ROUNDS, NoiseModel(p_gate2=2e-3, p_meas=1e-2),
        "dem", device=dev)
    dg = duf.build_device_graph(graph).to(dev)
    dets, _ = sample_dets(torch.Generator(device=dev).manual_seed(SEED),
                          batch, ROUNDS)
    return dg, dets


def _kernels(dg, s, lib=None):
    """Per kernel: (bare launch, wrapper call, plain call, bytes of the
    bound, bytes its interface moves); the bare launches call ``lib``'s
    entry points (default: the package's build)."""
    lib = lib or _cuda.load()
    st = dg.stencil
    B, V = s["packed"].shape
    O, KB = len(st.deltas), st.bmask.shape[0]
    L = dg.pack_shift
    tab, deltas = st.kernel_tables, st.kernel_deltas
    plane, flags = 4 * B * V, B * V
    packed, seed, sup = s["packed"], s["seed"], s["sup"]
    satm, satb, passes = s["satm"], s["satb"], s["passes"]
    o3 = torch.empty_like(packed)
    o4 = torch.empty_like(packed)
    o5 = (torch.empty_like(packed), torch.empty_like(sup),
          torch.empty_like(packed))

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def k3():
        _cuda.check(lib.qcss_stencil_prop(
            packed.data_ptr(), satm.data_ptr(), satb.data_ptr(),
            tab.data_ptr(), deltas.data_ptr(), B, V, O, KB, L,
            o3.data_ptr(), stream()), "qcss_stencil_prop")
        return o3

    def k4():
        _cuda.check(lib.qcss_stencil_act(
            seed.data_ptr(), passes.data_ptr(), deltas.data_ptr(), B, V, O,
            o4.data_ptr(), stream()), "qcss_stencil_act")
        return o4

    def k5():
        _cuda.check(lib.qcss_stencil_round(
            packed.data_ptr(), seed.data_ptr(), sup.data_ptr(),
            tab.data_ptr(), deltas.data_ptr(), B, V, O, KB, L,
            o5[0].data_ptr(), o5[1].data_ptr(), o5[2].data_ptr(),
            stream()), "qcss_stencil_round")
        return o5

    def k5_plain():
        r = duf._round_plain(dg, packed, seed, sup[:, :O], sup[:, O:])
        return r[0], torch.cat([r[1], r[2]], dim=1), r[3]

    def io(*xs):
        return sum(x.numel() * x.element_size() for x in xs)

    return {
        "K3": (k3, lambda: device_uf_cuda.stencil_prop(dg, packed, satm,
                                                       satb),
               lambda: duf._prop_plain(dg, packed, satm, satb),
               2 * plane + (O + KB) * flags + 4 * ((O + KB) * V + O),
               io(packed, satm, satb, o3)),
        "K4": (k4, lambda: device_uf_cuda.stencil_act(dg, seed, passes),
               lambda: duf._act_plain(dg, seed, passes),
               (2 + O) * flags + 4 * O, io(seed, passes, o4)),
        "K5": (k5, lambda: device_uf_cuda.stencil_round(dg, packed, seed,
                                                        sup),
               k5_plain,
               (2 + 2 * (O + KB)) * plane + 2 * flags
               + 4 * (tab.numel() + O), io(packed, seed, sup, *o5)),
    }


def _max_abs(a, b) -> int:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               if x.numel() else 0 for x, y in zip(a, b))


def plans(dg) -> dict:
    """The staged kernels' launch plans, those the checkout reports (an
    older one may report K3's and K5's, or none)."""
    if not hasattr(device_uf_cuda, "stencil_staged_config"):
        return {}
    out = {}
    for key, kernel in (("K3", "prop"), ("K4", "act"), ("K5", "round")):
        try:
            out[key] = device_uf_cuda.stencil_staged_config(dg, kernel)
        except KeyError:  # an older checkout has no plan of K4
            pass
    return out


def copy_ms(nbytes: int, reps: int) -> float:
    """Device ms of one `Tensor.copy_` that reads nbytes / 2 and writes as
    many, a launch from a CUDA graph."""
    src = torch.zeros(nbytes // 2, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    dst.copy_(src)
    return graph_ms([lambda: dst.copy_(src)], reps)


def kernel_rows(dg, dets, reps: int = 20,
                rounds: int = STAGED_ROUNDS) -> list[dict]:
    """One row per (kernel, round): graph and wrapper times, the bound,
    and (round 2) the plain version's time and the copy yardstick; each
    output held against the plain version."""
    defect = duf.stencil_defect(dg, dets)
    rows = []
    for rnd, s in enumerate(dstaged.round_inputs(dg, defect, rounds), 1):
        for name, (bare, wrap, plain, nbytes, io_bytes) in \
                _kernels(dg, s).items():
            err = _max_abs(bare(), plain())
            if err or _max_abs(wrap(), plain()):
                raise RuntimeError(f"{name} disagrees with its plain "
                                   f"version at round {rnd} (max abs err "
                                   f"{err})")
            bound_ms, bound_by = bound(nbytes)
            rows.append({
                "kernel": name, "round": rnd, "B": defect.shape[0],
                "V": defect.shape[1], "ms": graph_ms([bare], reps),
                "wrapper_ms": cuda_ms(wrap, reps),
                "plain_ms": cuda_ms(plain, 2) if rnd == 2 else None,
                "library_ms": None, "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes": nbytes, "io_bytes": io_bytes,
                "copy_ms": copy_ms(io_bytes, reps) if rnd == 2 else None,
                "max_abs_err": err})
    return rows


def decode_rows(dg, dets, reps: int = 3) -> list[dict]:
    """Each staged decode's wall time a call (host-fenced, after a warm
    call), its kernel launches a call, and its labels against K1's."""
    ref, conv = duf.decode_labels(dg, dets)
    rows = []
    for fn in (dstaged.decode_stencil_staged, dstaged.decode_stencil_fused):
        fn(dg, dets)
        torch.cuda.synchronize()
        before = dict(device_uf_cuda.staged_launches)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            lab, c = fn(dg, dets)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if not (torch.equal(lab[0], ref[0]) and torch.equal(c, conv)):
            raise RuntimeError(f"{fn.__name__} disagrees with K1's labels")
        launches = {k: (v - before[k]) // reps
                    for k, v in device_uf_cuda.staged_launches.items()
                    if v != before[k]}
        rows.append({"decode": fn.__name__, "B": dets.shape[0],
                     "ms": times, "launches_a_call": launches,
                     "equal_to_k1": True})
    return rows


def build_phases() -> ctypes.CDLL:
    """`csrc/uf_stencil_staged.cu` alone, built with QCSS_STAGED_PHASES
    into build/cuda-phases/<hash of sources, flags and nvcc>/ (its entry
    points bound as the package binds them, and `qcss_stencil_phases`)."""
    nvcc = _cuda.nvcc_path()
    flags = (*_cuda.NVCC_FLAGS, "-DQCSS_STAGED_PHASES", "-shared")
    h = hashlib.sha256(" ".join((nvcc,) + flags).encode())
    h.update(subprocess.run([nvcc, "--version"], capture_output=True,
                            check=True, text=True).stdout.encode())
    for name in ("uf_stencil_staged.cu", "uf_stencil_common.cuh"):
        h.update((_cuda.CSRC / name).read_bytes())
    out = _cuda.BUILD_ROOT.parent / "cuda-phases" / h.hexdigest()[:16] \
        / "libstaged.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=out.parent) as tmpdir:
            tmp = os.path.join(tmpdir, out.name)
            subprocess.run([nvcc, *flags, "-o", tmp,
                            str(_cuda.CSRC / "uf_stencil_staged.cu")],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, out)  # a concurrent loader sees all or nothing
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.qcss_stencil_prop.argtypes = [ptr, ptr, ptr, ptr, ptr] + \
        [i32] * 5 + [ptr, ptr]
    lib.qcss_stencil_act.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr, ptr]
    lib.qcss_stencil_round.argtypes = [ptr, ptr, ptr, ptr, ptr] + \
        [i32] * 5 + [ptr] * 4
    lib.qcss_stencil_phases.argtypes = [ptr]
    return lib


def phase_rows(dg, dets) -> list[dict]:
    """Clock cycles a shot in each phase of K3, K4 and K5 (a build with
    QCSS_STAGED_PHASES), one launch each on the round-2 state."""
    s = dstaged.round_inputs(dg, duf.stencil_defect(dg, dets), 2)[1]
    lib = build_phases()
    counts = (ctypes.c_ulonglong * 16)()
    ks = _kernels(dg, s, lib)
    B = s["packed"].shape[0]
    rows = []
    for key, names in PHASES.items():
        _cuda.check(lib.qcss_stencil_phases(counts), "qcss_stencil_phases")
        ks[key][0]()
        torch.cuda.synchronize()
        _cuda.check(lib.qcss_stencil_phases(counts), "qcss_stencil_phases")
        cyc = {name: counts[i] / B for i, name in names.items()}
        total = sum(cyc.values())
        rows.append({"kernel": key, "B": B, "cycles_a_shot": cyc,
                     "share": {k: v / total for k, v in cyc.items()}})
    return rows


def run(reps: int = 20, dg=None, dets=None) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("staged_bench times the card's kernels: no CUDA "
                           "device")
    if dg is None:
        dg, dets = setup(torch.device("cuda"))
    return {"plans": plans(dg), "kernels": kernel_rows(dg, dets, reps),
            "decodes": decode_rows(dg, dets)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--phases", action="store_true",
                    help="also count the kernels' cycles by phase")
    args = ap.parse_args()
    dg, dets = setup(torch.device("cuda"))
    out = run(args.reps, dg, dets)
    print(json.dumps({"plans": out["plans"]}), flush=True)
    rows = out["kernels"] + out["decodes"]
    if args.phases:
        rows += phase_rows(dg, dets)
    for row in rows:
        print(json.dumps(row), flush=True)
    print(card(), flush=True)
