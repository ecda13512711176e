#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`qcss_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from `qcss_tpu_torch/csrc` (nvcc, sm_90a) and
drives the port's main path, the circuit-level surface-code memory with
sampling and decoding fused on the card, at distance 11 over 11 rounds:

1. prints the toolchain and the card;
2. builds the kernels;
3. holds the stencil union-find kernel against its plain PyTorch version
   on 1024 sampled detector rows (packed labels, activity, obs and
   convergence must be identical), and against the plain version on the
   CPU;
4. holds the sparse growth kernel against its plain version on the same
   rows, at d_max=48 and at d_max=16 (where shots overflow);
5. runs `memory_experiment(..., decoder="device-dem", engine="frames",
   batch=16384, device="cuda")`;
6. runs the fused dense, sparse and hybrid pipelines at B=16384 and prints
   shots/s and the logical failure rate;
7. times each kernel and its plain version at B=16384;
8. checks that both kernels were launched by steps 5-6.

Any failure exits non-zero. The last line is one JSON object
``{"ok": true, "device": {...}}``; the line before it is the card's name
and power limit from nvidia-smi, and the one before that the kernels'
JSON line. Without a CUDA device, or without the package beside it, the
script prints no result and exits with 2.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

D = 11
ROUNDS = 11
BATCH = 16384
CHECK_ROWS = 1024
D_MAX = 48


def log(msg: str) -> None:
    print(msg, flush=True)


def run_text(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs(a, b) -> int:
    import torch

    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import qcss_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the qcss_tpu_torch package is not beside this "
              f"script ({exc})", file=sys.stderr)
        return 2

    from qcss_tpu_torch import _cuda
    from qcss_tpu_torch.benchmarks.device_uf_bench import build_pipeline
    from qcss_tpu_torch.benchmarks.device_uf_bench import run as bench_run
    from qcss_tpu_torch.codes.families import rotated_surface
    from qcss_tpu_torch.decode import device_sparse as dsp
    from qcss_tpu_torch.decode import device_sparse_cuda, device_uf_cuda
    from qcss_tpu_torch.decode import device_uf as duf
    from qcss_tpu_torch.experiments.memory import memory_experiment
    from qcss_tpu_torch.sim.noise import NoiseModel

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # 0/1 products stay exact

    # -- 1. toolchain
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    try:
        import importlib.metadata as md

        triton_version = md.version("triton")
    except Exception:  # noqa: BLE001 - report only; triton is not used
        triton_version = "not installed"
    nvcc_version = run_text([_cuda.nvcc_path(), "--version"]).splitlines()[-1]
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch.version.cuda {torch.version.cuda}  triton {triton_version}")
    log(f"nvcc: {nvcc_version}")
    log(f"card: {smi}  (device count {torch.cuda.device_count()})")

    # -- 2. build
    t0 = time.perf_counter()
    _cuda.load()
    log(f"built kernels in {time.perf_counter() - t0:.1f} s: "
        f"{_cuda.library_path()}")
    if _cuda.build_log:
        for line in _cuda.build_log.splitlines():
            if "registers" in line or "Function properties" in line \
                    or "spill" in line:
                log("  ptxas: " + line.strip())

    code = rotated_surface(D)
    noise = NoiseModel(p_gate2=2e-3, p_meas=1e-2)
    t0 = time.perf_counter()
    graph, _, _, sample_dets = build_pipeline(code, ROUNDS, noise, "dem",
                                              device=dev)
    dg = duf.build_device_graph(graph)
    st = dg.stencil
    if st is None or st.chunks:
        raise RuntimeError("the d=11 DEM graph must be stencil-eligible "
                           "with no spilled lanes")
    dg = dg.to(dev)
    tables = dsp.build_sparse_tables(graph)
    tables_dev = dsp._tables_to(tables, dev)
    log(f"d={D} R={ROUNDS} DEM graph: V={graph.num_nodes + 1} "
        f"E={graph.num_edges} deltas={st.deltas} KB={st.bmask.shape[0]} "
        f"L={dg.pack_shift}; built in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(1234)
    dets_big, _ = sample_dets(gen, BATCH, ROUNDS)
    dets = dets_big[:CHECK_ROWS].contiguous()
    defects_per_shot = dets_big.to(torch.float32).sum(1)
    log(f"sampled detectors: mean {float(defects_per_shot.mean()):.2f} "
        f"defects/shot, max {int(defects_per_shot.max())}")

    # -- 3. K1 against its plain version
    defect = duf.stencil_defect(dg, dets)
    packed_k, act_k = device_uf_cuda.stencil_full(dg, defect)
    packed_p, act_p = duf._stencil_plain(dg, defect)
    torch.cuda.synchronize()
    lab_k, conv_k = duf._stencil_labels(dg, defect, packed_k, act_k)
    lab_p, conv_p = duf._stencil_labels(dg, defect, packed_p, act_p)
    k1_err = max(max_abs(packed_k, packed_p), max_abs(act_k, act_p),
                 max_abs(lab_k[0], lab_p[0]))
    if not (torch.equal(packed_k, packed_p) and torch.equal(act_k, act_p)
            and torch.equal(lab_k[0], lab_p[0])
            and torch.equal(conv_k, conv_p)):
        raise RuntimeError(f"stencil kernel disagrees with its plain "
                           f"version (max abs err {k1_err})")
    if not bool(conv_k.all()):
        raise RuntimeError("stencil kernel left shots unconverged")
    dg_cpu = dg.to("cpu")
    lab_c, conv_c = duf._decode_stencil(dg_cpu, dets.cpu())
    if not (torch.equal(lab_c[0], lab_k[0].cpu())
            and torch.equal(conv_c, conv_k.cpu())):
        raise RuntimeError("stencil kernel disagrees with the plain "
                           "version on the CPU")
    log(f"K1 stencil kernel == plain version on {CHECK_ROWS} rows "
        f"(packed, act, obs, converged; also vs the CPU)")

    # -- 4. K2 against its plain version, then with overflow
    ev48 = D_MAX * (D_MAX + 1) // 2 + 4
    for d_max in (D_MAX, 16):
        ev = d_max * (d_max + 1) // 2 + 4
        obs_k, c_k = device_sparse_cuda.sparse_decode_cuda(
            tables_dev, d_max, ev, dets)
        obs_p, c_p = dsp._sparse_plain(tables_dev, d_max, ev, dets)
        torch.cuda.synchronize()
        overflow = int((defects_per_shot[:CHECK_ROWS] > d_max).sum())
        if not (torch.equal(obs_k, obs_p) and torch.equal(c_k, c_p)):
            raise RuntimeError(
                f"sparse kernel disagrees with its plain version at "
                f"d_max={d_max} (max abs err {max_abs(obs_k, obs_p)}, "
                f"converged differ on {int((c_k != c_p).sum())} shots)")
        log(f"K2 sparse kernel == plain version on {CHECK_ROWS} rows at "
            f"d_max={d_max} ({overflow} overflow shots, "
            f"{int((~c_k).sum())} unconverged)")
        if d_max == D_MAX:
            conv_s = c_k
            agree = float(((obs_k & 1) == (lab_k[0] & 1))[c_k]
                          .to(torch.float32).mean())
    k2_err = 0
    log(f"sparse vs dense decode agree on {agree:.4f} of converged shots")
    if agree < 0.97:
        raise RuntimeError("sparse and dense decoders disagree too often")
    if not bool(conv_s.all()):
        raise RuntimeError("sparse decoder left shots unconverged at "
                           f"d_max={D_MAX}")

    # -- a failure rate that is not zero: the card's sampler and kernels
    #    against the plain path on the CPU, at d=5 R=5 and p=1e-2, where
    #    shots fail. Different generators, so a two-sample test (99.9%).
    hot = NoiseModel(p_gate2=1e-2, p_meas=1e-2)
    rates = {}
    for where in ("cuda", "cpu"):
        rates[where] = memory_experiment(
            rotated_surface(5), rounds=5, noise=hot, decoder="device-dem",
            engine="frames", batch=BATCH, device=where,
            seed=3)["logical_fail"]
    pooled = (rates["cuda"] + rates["cpu"]) / 2
    spread = 3.2905 * math.sqrt(pooled * (1 - pooled) * 2 / BATCH)
    log(f"d=5 R=5 p=1e-2 B={BATCH}: logical_fail on the card "
        f"{rates['cuda']:.6f}, on the CPU {rates['cpu']:.6f} "
        f"(allowed difference {spread:.6f})")
    if not (rates["cuda"] > 0
            and abs(rates["cuda"] - rates["cpu"]) <= spread):
        raise RuntimeError("the card's failure rate disagrees with the CPU's")

    # -- 5-6. the main path, counted
    device_uf_cuda.launches = 0
    device_sparse_cuda.launches = 0
    t0 = time.perf_counter()
    res = memory_experiment(code, rounds=ROUNDS, noise=noise,
                            decoder="device-dem", engine="frames",
                            batch=BATCH, device="cuda", seed=7)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rate = res["logical_fail"]
    if not (0.0 <= rate < 0.05):
        raise RuntimeError(f"implausible logical failure rate {rate}")
    log(f"memory_experiment d={D} R={ROUNDS} device-dem frames B={BATCH}: "
        f"logical_fail {rate:.6f}, {dt:.2f} s (graph build included), "
        f"every shot converged")

    pipelines = {}
    for decoder in ("dense", "sparse", "hybrid"):
        out = bench_run(D, ROUNDS, BATCH, 3, noise, "dem", decoder, seed=99)
        pipelines[decoder] = {k: out[k] for k in (
            "shots_per_sec", "sample_only_shots_per_sec", "logical_fail")}
        log(f"fused {decoder} d={D} R={ROUNDS} B={BATCH}: "
            f"{out['shots_per_sec']:.1f} shots/s (sampling alone "
            f"{out['sample_only_shots_per_sec']:.1f}), logical_fail "
            f"{out['logical_fail']:.6f}, every shot converged")
    n_k1 = device_uf_cuda.launches
    n_k2 = device_sparse_cuda.launches
    log(f"main-path launches: stencil kernel {n_k1}, sparse kernel {n_k2}")
    if n_k1 <= 0 or n_k2 <= 0:
        raise RuntimeError("a kernel of the main path was never launched")
    rates = [p["logical_fail"] for p in pipelines.values()] + [rate]
    if max(rates) >= 0.05:
        raise RuntimeError(f"implausible logical failure rates {rates}")

    # -- 7. kernel and plain-version times at the main path's shapes
    defect_big = duf.stencil_defect(dg, dets_big)
    k1_ms = cuda_ms(lambda: device_uf_cuda.stencil_full(dg, defect_big), 5)
    k1_plain_ms = cuda_ms(lambda: duf._stencil_plain(dg, defect_big), 2)
    pk, ak = device_uf_cuda.stencil_full(dg, defect_big)
    pp, ap = duf._stencil_plain(dg, defect_big)
    k1_err = max(k1_err, max_abs(pk, pp), max_abs(ak, ap))
    if k1_err:
        raise RuntimeError(f"stencil kernel disagrees at B={BATCH}")
    k2_ms = cuda_ms(lambda: device_sparse_cuda.sparse_decode_cuda(
        tables_dev, D_MAX, ev48, dets_big), 5)
    k2_plain_ms = cuda_ms(lambda: dsp._sparse_plain(
        tables_dev, D_MAX, ev48, dets_big), 2)
    ok_, ck_ = device_sparse_cuda.sparse_decode_cuda(tables_dev, D_MAX, ev48,
                                                     dets_big)
    op_, cp_ = dsp._sparse_plain(tables_dev, D_MAX, ev48, dets_big)
    k2_err = max(k2_err, max_abs(ok_, op_), max_abs(ck_, cp_))
    if k2_err:
        raise RuntimeError(f"sparse kernel disagrees at B={BATCH}")
    log(f"K1 stencil B={BATCH}: kernel {k1_ms:.3f} ms, plain "
        f"{k1_plain_ms:.3f} ms")
    log(f"K2 sparse B={BATCH} d_max={D_MAX}: kernel {k2_ms:.3f} ms, plain "
        f"{k2_plain_ms:.3f} ms (compaction and distance fetch included)")

    if any(m.split(".")[0] in ("jax", "jaxlib", "qcss_tpu")
           for m in sys.modules):
        raise RuntimeError("the port imported jax or qcss_tpu")

    print(json.dumps({"pipelines": pipelines, "memory_experiment": res,
                      "card": smi}), flush=True)
    print(json.dumps({"kernels": [
        {"name": "uf_stencil_full", "route": "cuda",
         "source": "qcss_tpu_torch/csrc/uf_stencil_full.cu",
         "replaces": "qcss_tpu/decode/device_uf_pallas.py:367",
         "launches": n_k1, "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "sparse_growth", "route": "cuda",
         "source": "qcss_tpu_torch/csrc/sparse_growth.cu",
         "replaces": "qcss_tpu/decode/device_sparse.py:395",
         "launches": n_k2, "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
