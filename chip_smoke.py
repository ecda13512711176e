#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`qcss_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from `qcss_tpu_torch/csrc` (nvcc, sm_90a, one
process per source) and drives the port's two paths on the card: the
circuit-level surface-code memory with sampling and decoding fused, at
distance 11 over 11 rounds, and the code-capacity Monte Carlo with the
packed GF(2) kernels:

1. prints the toolchain and the card;
2. builds the kernels;
3. holds the stencil union-find kernel (K1) against its plain PyTorch
   version on 1024 sampled detector rows (packed labels, activity, obs
   and convergence must be identical), and against the plain version on
   the CPU;
4. holds the sparse growth kernel (K2) against its plain version on the
   same rows, at d_max=48 and at d_max=16 (where shots overflow), and the
   card's d=5 failure rate against the CPU's;
5. holds the packed kernels against their plain versions, bit for bit:
   K6 and K7 on random words (about half with bit 31 set) at every
   distance of the syndrome sweep (B = 2^20, and 1000 at d=11), K8 on
   random words at Steane and Golay (B = 2^22), and K8 then K6 on the
   headline's own inputs (Steane errors from its sampler, B = 2^22,
   W = 1, one logical row);
6. main path 1: `memory_experiment(..., decoder="device-dem",
   engine="frames", batch=16384, device="cuda")` and the fused dense,
   sparse and hybrid pipelines at B=16384 (shots/s, logical failure
   rate); K1 and K2 must have launched;
7. main path 2, the headline: `benchmarks/steane_mc.py` (Steane, B=2^22,
   64 rounds, p=0.01; samples/s), its word-failure rate held against the
   plain path on the CPU by a two-sample 99.9% test; K6 and K8 must have
   launched;
8. main path 3: the syndrome sweep (`benchmarks/syndrome_sweep.py`,
   rotated surface d=3..11, B=2^20, dense / packed torch / K7), one JSON
   line per (d, form); K7 must have launched;
9. times each kernel, its plain version and (K6, K7) the dense matmul
   form at the main paths' shapes, beside each kernel's bound, checking
   each timed output against the plain version's; and times one round's
   decode at the headline's shape in the packed form the Monte Carlo
   runs and in the reference's dense forms.

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
MC_BATCH = 1 << 22
MC_ROUNDS = 64
MC_P = 0.01
MC_CPU_BATCH = 1 << 16
SWEEP_BATCH = 1 << 20
Z999 = 3.2905
# the least time the card could take: device memory at 3.35 TB/s (NVIDIA's
# H100 SXM data sheet); 32-bit integer instructions at 64 lanes per SM per
# clock (the Hopper SM), times the SM count and the card's top SM clock as
# this run reads them. The data sheet gives no integer rate.
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64


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

    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def max_abs_words(a, b) -> int:
    """max_abs of two outputs read as uint32 words (int32 storage is
    masked in int64 first); bytes and bits are unchanged by the mask."""
    import torch

    return max_abs(a.to(torch.int64) & 0xFFFFFFFF,
                   b.to(torch.int64) & 0xFFFFFFFF)


def bound(nbytes: float, ops: float = 0.0,
          ops_per_s: float = float("inf")) -> tuple[float, str]:
    """(bound in ms, what bounds it): the larger of the bytes over the
    memory rate and the integer operations over ``ops_per_s``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def two_sample_ok(k1: int, n1: int, k2: int, n2: int) -> tuple[bool, float]:
    """Two-sample 99.9% test of equal rates; (passes, allowed difference)."""
    pooled = (k1 + k2) / (n1 + n2)
    spread = Z999 * math.sqrt(pooled * (1 - pooled) * (1 / n1 + 1 / n2))
    return abs(k1 / n1 - k2 / n2) <= spread, spread


def random_words(gen, shape):
    """Random 32-bit words in int32 storage on the generator's device
    (about half have bit 31 set)."""
    import torch

    return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                         device=gen.device, dtype=torch.int64
                         ).to(torch.int32)


def packed(bits, device):
    from qcss_tpu_torch.ops import gf2_torch

    return gf2_torch.words32(gf2_torch.pack_bits(bits)).to(device)


def sparse_bytes(dets, d_max: int) -> int:
    """Bytes K2 must move on these detectors: the detector rows, the
    distance entries between the defects each shot decodes (its first
    d_max, each distinct entry once), the per-detector tables of the
    fired detectors, and obs and converged out."""
    import torch

    B, V = dets.shape
    defect = dets.to(torch.int64) & 1
    rank = torch.cumsum(defect, dim=1) - defect
    keep = (defect > 0) & (rank < d_max)
    b_idx, v_idx = keep.nonzero(as_tuple=True)
    pairs = torch.zeros(V * V, dtype=torch.bool, device=dets.device)
    slot = rank[b_idx, v_idx]
    ids = torch.full((B, d_max), -1, dtype=torch.int64, device=dets.device)
    ids[b_idx, slot] = v_idx
    a, c = ids[:, :, None], ids[:, None, :]
    ok = (a >= 0) & (c >= 0) & (a != c)
    pairs[(a * V + c)[ok]] = True
    fired = torch.zeros(V, dtype=torch.bool, device=dets.device)
    fired[v_idx] = True
    return (B * V + 4 * int(pairs.sum()) + 3 * 4 * int(fired.sum())
            + 2 * 4 * B)


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
    from qcss_tpu_torch.benchmarks import steane_mc, syndrome_sweep
    from qcss_tpu_torch.benchmarks.device_uf_bench import build_pipeline
    from qcss_tpu_torch.benchmarks.device_uf_bench import run as bench_run
    from qcss_tpu_torch.codes import families
    from qcss_tpu_torch.codes.families import rotated_surface
    from qcss_tpu_torch.decode import device_sparse as dsp
    from qcss_tpu_torch.decode import device_sparse_cuda, device_uf_cuda
    from qcss_tpu_torch.decode import device_uf as duf
    from qcss_tpu_torch.decode import montecarlo
    from qcss_tpu_torch.decode.montecarlo import logical_error_rate
    from qcss_tpu_torch.experiments.memory import memory_experiment
    from qcss_tpu_torch.ops import cuda_gf2, gf2, gf2_torch
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_mhz = float(run_text(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"]
                               ).splitlines()[0])
    int_ops_per_s = sms * INT32_LANES_PER_SM * clock_mhz * 1e6
    log(f"integer bound rate: {sms} SMs x {INT32_LANES_PER_SM} lanes x "
        f"{clock_mhz:.0f} MHz = {int_ops_per_s:.4g} ops/s")

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

    # -- 5. the packed kernels against their plain versions, bit for bit
    gen_w = torch.Generator(device=dev).manual_seed(2024)
    h11 = packed(code.parity_check_c2, dev)  # [60, 4] at d=11
    k6_err = k7_err = k8_err = 0
    for d in syndrome_sweep.DISTANCES:
        hd = h11 if d == D else packed(
            rotated_surface(d).parity_check_c2, dev)
        for B in (SWEEP_BATCH, 1000) if d == D else (SWEEP_BATCH,):
            e = random_words(gen_w, (B, hd.shape[1]))
            e_t = e.T.contiguous()
            k6, p6 = cuda_gf2.syndromes_packed_cuda(e, hd), \
                cuda_gf2.syndromes_packed_plain(e, hd)
            k7, p7 = cuda_gf2.syndromes_packed_t_cuda(e_t, hd), \
                cuda_gf2.syndromes_packed_t_plain(e_t, hd)
            torch.cuda.synchronize()
            k6_err = max(k6_err, max_abs(k6, p6))
            k7_err = max(k7_err, max_abs_words(k7, p7))
            if k6_err or k7_err or not (torch.equal(k6, p6)
                                        and torch.equal(k7, p7)):
                raise RuntimeError(
                    f"K6/K7 disagree with their plain versions at d={d} "
                    f"B={B} (max abs err {k6_err}, {k7_err})")
            log(f"K6 syndromes_packed and K7 syndromes_packed_t == plain "
                f"versions at d={d} (R={hd.shape[0]}, W={hd.shape[1]}), "
                f"B={B}; {int((e < 0).sum())} words with bit 31 set")
    luts = {}
    for name in ("steane", "golay"):
        c = getattr(families, name)()
        h = c.parity_check_c2
        luts[name] = (packed(h, dev), packed(
            gf2.correction_lut(h, c.c2_syndromes), dev))
        hp, lp = luts[name]
        e = random_words(gen_w, (MC_BATCH, hp.shape[1]))
        k8 = cuda_gf2.decode_residual_packed_cuda(e, hp, lp)
        p8 = cuda_gf2.decode_residual_packed_plain(e, hp, lp)
        torch.cuda.synchronize()
        k8_err = max(k8_err, max_abs_words(k8, p8))
        if k8_err or not torch.equal(k8, p8):
            raise RuntimeError(f"K8 disagrees with its plain version on "
                               f"{name} (max abs err {k8_err})")
        log(f"K8 decode_residual_packed == plain version on {name} "
            f"(R={hp.shape[0]}, LUT {tuple(lp.shape)}), B={MC_BATCH}")
    # K8, then K6 on its residual, where and as the headline runs them:
    # Steane errors from its sampler, both sectors, B = 2^22, W = 1, k = 1
    steane = families.steane()
    sectors = montecarlo.packed_sectors(steane, dev)
    errs = montecarlo.sample_depolarizing(
        torch.Generator(device=dev).manual_seed(77), MC_BATCH, steane.n, MC_P)
    for sector, err, sec in zip("XZ", errs, sectors):
        words = packed(err, dev)
        k8 = cuda_gf2.decode_residual_packed_cuda(words, sec.checks, sec.lut)
        p8 = cuda_gf2.decode_residual_packed_plain(words, sec.checks, sec.lut)
        k6 = cuda_gf2.syndromes_packed_cuda(k8, sec.logicals)
        p6 = cuda_gf2.syndromes_packed_plain(p8, sec.logicals)
        torch.cuda.synchronize()
        k8_err = max(k8_err, max_abs_words(k8, p8))
        k6_err = max(k6_err, max_abs(k6, p6))
        if k6_err or k8_err or not (torch.equal(k8, p8)
                                    and torch.equal(k6, p6)):
            raise RuntimeError(
                f"K8/K6 disagree with their plain versions on the "
                f"headline's {sector} sector (max abs err {k8_err}, "
                f"{k6_err})")
        log(f"K8 then K6 == plain versions on the headline's {sector} "
            f"sector (B={MC_BATCH}, W={words.shape[1]}, "
            f"k={sec.logicals.shape[0]}): {int(p6.sum())} logical flips")

    # -- 6. main path 1: the fused circuit-level memory, counted
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
    log(f"main path 1 launches: stencil kernel {n_k1}, sparse kernel {n_k2}")
    if n_k1 <= 0 or n_k2 <= 0:
        raise RuntimeError("a kernel of main path 1 was never launched")
    rates = [p["logical_fail"] for p in pipelines.values()] + [rate]
    if max(rates) >= 0.05:
        raise RuntimeError(f"implausible logical failure rates {rates}")

    # -- 7. main path 2: the headline Steane Monte Carlo, counted
    for k in cuda_gf2.launches:
        cuda_gf2.launches[k] = 0
    mc = steane_mc.run(MC_BATCH, MC_ROUNDS, MC_P, reps=3, seed=5)
    n_k6 = cuda_gf2.launches["syndromes_packed"]
    n_k8 = cuda_gf2.launches["decode_residual_packed"]
    log(f"main path 2 launches: K6 {n_k6}, K8 {n_k8}")
    if n_k6 <= 0 or n_k8 <= 0:
        raise RuntimeError("a kernel of main path 2 was never launched")
    t0 = time.perf_counter()
    cpu = logical_error_rate(families.steane(), MC_P,
                             samples=MC_ROUNDS * MC_CPU_BATCH,
                             batch=MC_CPU_BATCH, seed=6, device="cpu")
    cpu_s = time.perf_counter() - t0
    k_cpu = round(cpu["word_fail"] * cpu["samples"])
    ok, spread = two_sample_ok(mc["word_fail_count"], mc["samples"], k_cpu,
                               cpu["samples"])
    log(f"Steane MC B={MC_BATCH} rounds={MC_ROUNDS} p={MC_P}: "
        f"{mc['samples_per_sec']:.1f} samples/s on the card, word_fail "
        f"{mc['word_fail']:.7f} over {mc['samples']} samples; the plain "
        f"path on the CPU {cpu['word_fail']:.7f} over {cpu['samples']} "
        f"({cpu_s:.1f} s; allowed difference {spread:.7f})")
    if not (mc["word_fail_count"] > 0 and ok):
        raise RuntimeError("the card's Steane word-failure rate disagrees "
                           "with the CPU's")

    # -- 8. main path 3: the syndrome sweep, counted
    for k in cuda_gf2.launches:
        cuda_gf2.launches[k] = 0
    sweep = syndrome_sweep.run(batch=SWEEP_BATCH)
    n_k7 = cuda_gf2.launches["syndromes_packed_t"]
    for row in sweep:
        print(json.dumps(row), flush=True)
    log(f"main path 3 launches: K7 {n_k7}")
    if n_k7 <= 0:
        raise RuntimeError("K7 was never launched by the syndrome sweep")

    # -- 9. kernel and plain-version times at the main paths' shapes
    defect_big = duf.stencil_defect(dg, dets_big)
    k1_ms = cuda_ms(lambda: device_uf_cuda.stencil_full(dg, defect_big), 5)
    k1_plain_ms = cuda_ms(lambda: duf._stencil_plain(dg, defect_big), 2)
    pk, ak = device_uf_cuda.stencil_full(dg, defect_big)
    pp, ap = duf._stencil_plain(dg, defect_big)
    k1_err = max(k1_err, max_abs(pk, pp), max_abs(ak, ap))
    if k1_err:
        raise RuntimeError(f"stencil kernel disagrees at B={BATCH}")
    V1 = defect_big.shape[1]
    k1_bound = bound(4 * (3 * BATCH * V1 + device_uf_cuda._tables(
        st).numel() + len(st.deltas)))
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
    k2_bound = bound(sparse_bytes(dets_big, D_MAX))
    log(f"K1 stencil B={BATCH}: kernel {k1_ms:.4f} ms, plain "
        f"{k1_plain_ms:.3f} ms, bound {k1_bound[0]:.4f} ms ({k1_bound[1]})")
    log(f"K2 sparse B={BATCH} d_max={D_MAX}: kernel {k2_ms:.4f} ms, plain "
        f"{k2_plain_ms:.3f} ms (compaction and distance fetch included), "
        f"bound {k2_bound[0]:.4f} ms ({k2_bound[1]})")

    def packed_times(label, kernel, plain, args, dense_args, nbytes, ops):
        """Times of a packed kernel, its plain version and (dense_args)
        the dense matmul form, and the kernel's bound; the kernel's output
        is held against the plain version's on the same inputs."""
        err = max_abs_words(kernel(*args), plain(*args))
        if err:
            raise RuntimeError(f"{label}: the kernel disagrees with its "
                               f"plain version (max abs err {err})")
        out = {"ms": cuda_ms(lambda: kernel(*args), 20),
               "plain_ms": cuda_ms(lambda: plain(*args), 3),
               "library_ms": (cuda_ms(lambda: gf2_torch.syndromes_dense(
                   *dense_args), 20) if dense_args else None)}
        out["bound_ms"], out["bound_by"] = bound(nbytes, ops, int_ops_per_s)
        log(f"{label}: kernel {out['ms']:.4f} ms (== plain), plain "
            f"{out['plain_ms']:.4f} ms, dense matmul form "
            f"{out['library_ms']} ms, bound {out['bound_ms']:.4f} ms "
            f"({out['bound_by']})")
        return out, err

    # Integer operations counted per (shot, check row): one LOP3 per word
    # for acc ^= e & h, a popcount, and one or two to place the bit (K6:
    # & 1; K7: shift, or; K8: shift-or into the index); K8 adds one XOR
    # per word. Each input byte is read once and each output written once.
    # K6 and K8 where the headline runs them: Steane, B = 2^22, one word
    x_sec = sectors[0]
    resid_bits = (torch.rand((MC_BATCH, steane.n), generator=gen_w,
                             device=dev) < 0.02).to(torch.uint8)
    resid = packed(resid_bits, dev)
    R, W = x_sec.checks.shape
    K = x_sec.logicals.shape[0]
    times = {}
    times["K6"], err = packed_times(
        f"K6 on the headline's residuals (B={MC_BATCH}, k={K}, W={W})",
        cuda_gf2.syndromes_packed_cuda, cuda_gf2.syndromes_packed_plain,
        (resid, x_sec.logicals),
        (resid_bits, x_sec.logicals.new_tensor(steane.z_operator_matrix())),
        4 * MC_BATCH * W + 4 * K * W + MC_BATCH * K,
        MC_BATCH * K * (W + 2))
    k6_err = max(k6_err, err)
    times["K8"], err = packed_times(
        f"K8 on the headline's errors (Steane, B={MC_BATCH}, R={R}, W={W})",
        cuda_gf2.decode_residual_packed_cuda,
        cuda_gf2.decode_residual_packed_plain,
        (resid, x_sec.checks, x_sec.lut), None,
        4 * (2 * MC_BATCH * W + R * W + (1 << R) * W),
        MC_BATCH * (R * (W + 3) + W))
    k8_err = max(k8_err, err)
    hg, lg = luts["golay"]
    _, err = packed_times(
        f"K8 on Golay (B={MC_BATCH}, R={hg.shape[0]}, LUT {tuple(lg.shape)})",
        cuda_gf2.decode_residual_packed_cuda,
        cuda_gf2.decode_residual_packed_plain,
        (resid, hg, lg), None,
        4 * (2 * MC_BATCH + hg.numel() + lg.numel()),
        MC_BATCH * (hg.shape[0] * 4 + 1))
    k8_err = max(k8_err, err)
    # K7 where the sweep runs it hardest, and K6 at the same shape: d=11
    e_bits = (torch.rand((SWEEP_BATCH, code.n), generator=gen_w,
                         device=dev) < 0.5).to(torch.uint8)
    e11 = packed(e_bits, dev)
    h11_bits = torch.as_tensor(code.parity_check_c2, device=dev)
    R11, W11 = h11.shape
    times["K7"], err = packed_times(
        f"K7 at d={D} (B={SWEEP_BATCH}, R={R11}, W={W11})",
        cuda_gf2.syndromes_packed_t_cuda, cuda_gf2.syndromes_packed_t_plain,
        (e11.T.contiguous(), h11), (e_bits, h11_bits),
        4 * (W11 * SWEEP_BATCH + R11 * W11
             + (R11 + 31) // 32 * SWEEP_BATCH),
        SWEEP_BATCH * R11 * (W11 + 3))
    k7_err = max(k7_err, err)
    _, err = packed_times(
        f"K6 at d={D} (B={SWEEP_BATCH}, R={R11}, W={W11})",
        cuda_gf2.syndromes_packed_cuda, cuda_gf2.syndromes_packed_plain,
        (e11, h11), (e_bits, h11_bits),
        4 * (W11 * SWEEP_BATCH + R11 * W11) + R11 * SWEEP_BATCH,
        SWEEP_BATCH * R11 * (W11 + 2))
    k6_err = max(k6_err, err)

    # one round's decode at the headline's shape: the packed form the Monte
    # Carlo runs against the reference's dense forms, on the same errors
    forms = steane_mc.decode_forms(MC_BATCH, MC_P, seed=8)
    log("one round's decode, Steane B=2^22 (both sectors, flags equal): " +
        ", ".join(f"{k} {v:.4f} ms" for k, v in forms.items()))

    if any(m.split(".")[0] in ("jax", "jaxlib", "qcss_tpu")
           for m in sys.modules):
        raise RuntimeError("the port imported jax or qcss_tpu")

    print(json.dumps({"pipelines": pipelines, "memory_experiment": res,
                      "steane_mc": mc, "decode_forms_ms": forms,
                      "card": smi}), flush=True)
    lib_note = ("gf2_torch.syndromes_dense: one float32 torch.matmul with "
                "casts, on the unpacked [B, n] bits (another layout)")
    print(json.dumps({"kernels": [
        {"name": "uf_stencil_full", "route": "cuda",
         "source": "qcss_tpu_torch/csrc/uf_stencil_full.cu",
         "replaces": "qcss_tpu/decode/device_uf_pallas.py:367",
         "launches": n_k1, "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "sparse_growth", "route": "cuda",
         "source": "qcss_tpu_torch/csrc/sparse_growth.cu",
         "replaces": "qcss_tpu/decode/device_sparse.py:395",
         "launches": n_k2, "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None},
        {"name": "syndromes_packed", "route": "cuda",
         "source": "qcss_tpu_torch/csrc/gf2_packed.cu",
         "replaces": "qcss_tpu/ops/pallas_gf2.py:51",
         "launches": n_k6, "max_abs_err": k6_err, **times["K6"],
         "library_note": lib_note},
        {"name": "syndromes_packed_t", "route": "cuda",
         "source": "qcss_tpu_torch/csrc/gf2_packed.cu",
         "replaces": "qcss_tpu/ops/pallas_gf2.py:107",
         "launches": n_k7, "max_abs_err": k7_err, **times["K7"],
         "library_note": lib_note},
        {"name": "decode_residual_packed", "route": "cuda",
         "source": "qcss_tpu_torch/csrc/gf2_packed.cu",
         "replaces": "qcss_tpu/ops/pallas_gf2.py:156",
         "launches": n_k8, "max_abs_err": k8_err, **times["K8"]},
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
