"""Roofline accounting for the four rows of the JAX package's
benchmarks/roofline.py, as the port computes them, on the card.

For each row: time the port's code at the reference's shape, count the work
it needs (floating-point or integer operations, and the bytes each input
read once and each output written once move), and report the achieved
rates as shares of the card's peaks. The roofline bound is the larger of
bytes / HBM_BYTES_PER_S and operations / their peak rate; ``share`` is that
bound over the time. A share above 1.0 means the count exceeds what the
card can do in the time, a counting error, and raises.

Peaks (the card's, none of another chip's):
  * device memory: `profiling.HBM_BYTES_PER_S` (3.35 TB/s, NVIDIA's H100
    SXM data sheet);
  * 32-bit integer instructions: `profiling.int_ops_per_s()` (SMs x 64
    lanes x the card's top SM clock, read from the card);
  * FP32 (TF32 off): `PEAK_FP32_FLOPS`, 67 TFLOP/s, the "FP32" row of the
    H100 SXM column of NVIDIA's H100 Tensor Core GPU data sheet.

Rows:
  bp_totals    — BP min-sum's variable totals, ``lam + m @ scat`` (dense
                 layout, TF32 off), as `BPDecoder._bp_chunk` computes them
                 twice an iteration: bb144, B=4096, an 8-iteration decoder
  osd0_device  — OSD's batched GF(2) elimination, `bp._osd_eliminate`
                 (int64 words, one column a step), on the bb144 circuit
                 Tanner graph (R=12, z sector), B=1024, C=min(n, r+256)
  sparse_fetch — the sparse union-find's distance fetch lives inside K2
                 (csrc/sparse_growth.cu) in the port, so this row is K2
                 at d=11 R=11 B=16384 d_max=48, as a launch in a CUDA
                 graph over data 3x the L2, bounded by its bytes and pair
                 tests (`measure_sparse_bench.k2_row`)
  uf_mosaic    — K1 through `DeviceUFDecoder` on the d=11 phenomenological
                 spacetime graph, B=4096, detectors at 0.008: its byte floor
                 (detectors in, observables out) and K1's bound (the
                 kernel's inputs and outputs once, the candidate reads its
                 data need as integer operations)

    python -m qcss_tpu_torch.benchmarks.roofline   # on the card

Prints one JSON line per row, each with the card's name and power limit.
The work counts (`bp_totals_work`, `osd_work`, `uf_floor_bytes`, `k1_bytes`)
are functions of shape alone.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from qcss_tpu_torch.benchmarks.profiling import (
    HBM_BYTES_PER_S,
    bound,
    cuda_ms,
    int_ops_per_s,
)

# NVIDIA H100 Tensor Core GPU data sheet, H100 SXM: FP32 67 teraFLOPS
PEAK_FP32_FLOPS = 67e12

BP_BATCH = 4096
OSD_BATCH = 1024
OSD_ROUNDS = 12
UF_D = 11
UF_BATCH = 4096
UF_DENSITY = 0.008


# -- work counts (functions of shape) ---------------------------------------

def bp_totals_work(B: int, r: int, dc: int, n: int) -> tuple[float, int]:
    """(flops, bytes) of ``lam + m @ scat``: the [B, r*dc] x [r*dc, n]
    product (a multiply and an add per term) and the add of lam; m, scat
    and lam read once, the [B, n] totals written once, all float32."""
    flops = 2.0 * B * r * dc * n + B * n
    nbytes = 4 * (B * r * dc + r * dc * n + n + B * n)
    return flops, nbytes


def osd_work(B: int, r: int, n: int, C: int) -> tuple[int, int]:
    """(bytes, integer ops) of `bp._osd_eliminate` at these sizes. Bytes:
    h_t [n, r] and the syndromes [B, r] (uint8) and the soft values [B, n]
    (float32) read once; the order, pivot rows (int64), pivot flags and
    solution bits (one byte each) [B, C] and the reduced systems [B, r, W]
    int64, W = (C + 64) // 64, written once. Operations: column c reads its
    bit of every row (one a row) and folds the pivot row into the rows
    that hold it over the words from c's onwards, an int64 masked XOR
    being two 32-bit logic instructions."""
    W = (C + 1 + 63) // 64
    nbytes = (n * r + B * r + 4 * B * n + 8 * B * C + 8 * B * r * W
              + 8 * B * C + B * C + B * C)
    ops = sum(B * r * (2 * (W - c // 64) + 1) for c in range(C))
    return nbytes, ops


def uf_floor_bytes(B: int, V: int) -> int:
    """The reference's byte floor of a whole decode: a byte a detector in,
    an int32 observable mask a shot out."""
    return B * V + 4 * B


def k1_bytes(B: int, V: int, NC: int, n_words: int, n_deltas: int,
             n_chunk_table: int) -> int:
    """The bytes K1 must move (PERF.md's K1 bound): the defects in and the
    labels and activity out, an int32 each a vertex and shot, the chunk
    planes (NC of them) likewise, the edge words, the offsets and the
    chunk tables."""
    return 4 * ((3 + NC) * B * V + n_words + n_deltas + n_chunk_table)


def k1_work(dg, defect):
    """What K1's data need, counted with its plain version (the round loop
    of `device_uf._stencil_rounds`, one Jacobi sweep a call of
    `_propagate`). The plain loop is batch-wide; K1 stops each shot when
    it is quiet, so a round counts the shots still running in it: their
    number, their mean live vertices (the defects and the ends of
    saturated edges and slots), the mean and largest sweeps they take
    (the last, changeless sweep included); and the candidate reads those
    sweeps make over the live vertices, (2O + KB) a vertex and sweep,
    summed over the batch. Returns (rounds, reads, packed), packed the
    plain version's final labels."""
    from qcss_tpu_torch.decode import device_uf as duf

    st = dg.stencil
    B, V = defect.shape
    O, KB = len(st.deltas), st.bmask.shape[0]
    dev = defect.device
    packed = duf.initial_labels(dg, B, dev)
    sup = torch.zeros((B, O, V), dtype=torch.int32, device=dev)
    supb = torch.zeros((B, KB, V), dtype=torch.int32, device=dev)
    vals = tuple(torch.zeros_like(defect) for _ in st.chunks)
    act = defect
    rounds, reads = [], 0
    running = (defect != 0).any(1)
    active = bool(act.any())
    while active and len(rounds) < dg.max_rounds:
        sup, supb, grew = duf._grow_step(dg, packed, act, sup, supb)
        satm, satb = duf._saturated(dg, sup, supb)
        live = (defect != 0) | satm.any(1) | satb.any(1)
        for o, d in enumerate(st.deltas):
            live[:, d:] |= satm[:, o, :V - d]
        sweeps = torch.zeros(B, dtype=torch.int64, device=dev)
        changing = torch.ones(B, dtype=torch.bool, device=dev)
        while bool(changing.any()):
            packed, vals, still = duf._propagate(dg, packed, satm, satb, vals,
                                                 cap=1)
            sweeps += changing
            changing &= still
        act, _ = duf._spread(dg, duf.parity_seeds(dg, packed, defect),
                             duf._cluster_passes(dg, packed, satm))
        n_live = live.sum(1)[running]
        sweeps = sweeps[running]
        reads += int((sweeps * n_live).sum()) * (2 * O + KB)
        rounds.append({"shots": int(running.sum()),
                       "live_mean": float(n_live.float().mean()),
                       "sweeps_mean": float(sweeps.float().mean()),
                       "sweeps_max": int(sweeps.max())})
        running &= act.any(1) & grew.any(1)
        active = bool(act.any() & grew.any())
    return rounds, reads, packed


def k1_graph_bytes(dg, defect) -> int:
    """`k1_bytes` for a stencil device graph and K1's [B, V] defect rows."""
    st = dg.stencil
    B, V = defect.shape
    words = st.kernel_words(dg.pack_shift)[0]
    NC = len(st.chunks)
    return k1_bytes(B, V, NC, words.numel(), len(st.deltas),
                    st.kernel_chunk_tables.numel() if NC else 0)


# -- rows (on the card) -----------------------------------------------------

def _fenced_ms(fn, reps: int) -> float:
    """Mean host-clock milliseconds per call, each call fenced by a device
    synchronisation, after two warm-ups (the reference's `bench`)."""
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _shares(row: dict, ms: float, nbytes: float, ops: float,
            ops_peak: float, ops_kind: str) -> dict:
    """Rates and shares of the peaks for work done in ``ms`` (``ops`` of
    kind ``ops_kind`` at ``ops_peak`` a second); the roofline bound and its
    share. Raises where a share passes 1.0."""
    s = ms / 1e3
    row["ms"] = ms
    row["bytes"] = nbytes
    row["gbps"] = nbytes / s / 1e9
    row["frac_hbm"] = nbytes / s / HBM_BYTES_PER_S
    row["ops"] = ops
    row["ops_kind"] = ops_kind
    row["tops"] = ops / s / 1e12
    row["frac_peak_ops"] = ops / s / ops_peak
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_peak * 1e3
    row["bound_ms"], row["bound_by"] = ((t_ops, "operations")
                                        if t_ops > t_bytes
                                        else (t_bytes, "bytes"))
    row["share"] = row["bound_ms"] / ms
    _check(row)
    return row


def _check(row: dict) -> None:
    for key in ("frac_hbm", "frac_peak_ops", "share"):
        if row.get(key, 0.0) > 1.0:
            raise RuntimeError(
                f"roofline {row['kernel']}: {key} = {row[key]:.4g} > 1.0, a "
                f"counting error")


def bp_totals(dev, reps: int = 50) -> dict:
    from qcss_tpu_torch.codes.families import bb144
    from qcss_tpu_torch.decode import bp

    h = np.asarray(bb144().raw_parity_check_c2, np.uint8)
    dec = bp.BPDecoder(h, 0.003, iters=8, osd=False, device=dev)
    if dec._use_gather:
        raise RuntimeError("bb144's checks must take the dense totals")
    r, n, dc = dec.r, dec.n, dec.dc
    B = BP_BATCH
    m = torch.zeros((B, r * dc), dtype=torch.float32, device=dev)
    lam = dec._lam[None]

    def totals():
        with bp._tf32_off():
            return lam + m @ dec._scat

    ms = cuda_ms(totals, reps)
    flops, nbytes = bp_totals_work(B, r, dc, n)
    return _shares({"kernel": "bp_totals",
                    "shape": f"[{B},{r * dc}]x[{r * dc},{n}]"},
                   ms, nbytes, flops, PEAK_FP32_FLOPS, "fp32")


def osd0_device(dev, reps: int = 3) -> dict:
    from qcss_tpu_torch.codes.families import bb144
    from qcss_tpu_torch.decode import bp
    from qcss_tpu_torch.decode.bp_dem import build_circuit_tanner
    from qcss_tpu_torch.sim.noise import NoiseModel

    noise = NoiseModel(p_gate2=2e-3, p_meas=2e-3, p_reset=2e-3)
    t0 = time.perf_counter()
    tan = build_circuit_tanner(bb144(), OSD_ROUNDS, noise, sector="z")
    build_s = time.perf_counter() - t0
    h = np.asarray(tan.checks, np.uint8)
    r, n = h.shape
    B = OSD_BATCH
    C = min(n, r + 256)
    rng = np.random.default_rng(0)
    e = (rng.random((B, n)) < 0.002).astype(np.uint8)
    synd = torch.as_tensor((e @ h.T) & 1, dtype=torch.uint8, device=dev)
    soft = torch.as_tensor(rng.standard_normal((B, n)), dtype=torch.float32,
                           device=dev)
    h_t = torch.as_tensor(h.T.copy(), device=dev)
    ms = _fenced_ms(lambda: bp._osd_eliminate(h_t, synd, soft, C), reps)
    nbytes, ops = osd_work(B, r, n, C)
    return _shares({"kernel": "osd0_device", "shape": f"B={B} r={r} n={n} "
                    f"C={C}", "tanner_build_s": build_s},
                   ms, nbytes, ops, int_ops_per_s(), "int32")


def sparse_fetch(dev, reps: int = 20, ops_per_s: float | None = None) -> dict:
    from qcss_tpu_torch.benchmarks import measure_sparse_bench as msb

    ops_per_s = ops_per_s or int_ops_per_s()
    tables, dets = msb.k2_case(dev)
    k2 = msb.k2_row(tables, dets, reps, ops_per_s)
    B, V = dets.shape
    row = {"kernel": "sparse_fetch", "route": "K2 (csrc/sparse_growth.cu)",
           "shape": f"B={B} V={V} d_max={k2['d_max']}",
           "ms": k2["cold_ms"], "hot_ms": k2["hot_ms"],
           "wrapper_ms": k2["ms"], "bytes": k2["bytes"],
           "ops": k2["int_ops"], "ops_kind": "int32",
           "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"]}
    s = row["ms"] / 1e3
    row["gbps"] = row["bytes"] / s / 1e9
    row["frac_hbm"] = row["bytes"] / s / HBM_BYTES_PER_S
    row["tops"] = row["ops"] / s / 1e12
    row["frac_peak_ops"] = row["ops"] / s / ops_per_s
    row["share"] = row["bound_ms"] / row["ms"]
    _check(row)
    return row


def uf_mosaic(dev, reps: int = 3, ops_per_s: float | None = None) -> dict:
    from qcss_tpu_torch.codes.families import rotated_surface
    from qcss_tpu_torch.decode import device_uf as duf
    from qcss_tpu_torch.decode import device_uf_cuda
    from qcss_tpu_torch.decode.device_uf import DeviceUFDecoder
    from qcss_tpu_torch.decode.uf import spacetime_graph

    ops_per_s = ops_per_s or int_ops_per_s()
    code = rotated_surface(UF_D)
    g = spacetime_graph(np.asarray(code.raw_parity_check_c2),
                        code.z_operator_matrix(), UF_D)
    B = UF_BATCH
    rng = np.random.default_rng(0)
    dets = torch.as_tensor(
        (rng.random((B, g.num_nodes)) < UF_DENSITY).astype(np.uint8),
        device=dev)
    dec = DeviceUFDecoder(g, device=dev)
    before = device_uf_cuda.launches
    ms = _fenced_ms(lambda: dec.decode_batch(dets), reps)
    launches = device_uf_cuda.launches - before
    if launches != reps + 2 or dec.fallback_shots:
        raise RuntimeError(f"uf_mosaic: K1 launched {launches} times over "
                           f"{reps + 2} decodes, {dec.fallback_shots} shots "
                           f"sent to the host")
    dg = dec._dg
    defect = duf.stencil_defect(dg, dets)
    rounds, reads, packed = k1_work(dg, defect)
    if not torch.equal(device_uf_cuda.stencil_full(dg, defect)[0], packed):
        raise RuntimeError("K1 disagrees with the walked plain version")
    k1_ms, k1_by = bound(k1_graph_bytes(dg, defect), reads, ops_per_s)
    floor = uf_floor_bytes(B, g.num_nodes)
    s = ms / 1e3
    row = {"kernel": "uf_mosaic_full", "route": "K1 (csrc/uf_stencil_full.cu)",
           "shape": f"B={B} V={g.num_nodes}", "ms": ms,
           "shots_per_sec": B / s, "k1_launches": launches,
           "hbm_floor_bytes": floor, "hbm_floor_gbps": floor / s / 1e9,
           "frac_hbm": floor / s / HBM_BYTES_PER_S,
           "k1_bound_ms": k1_ms, "bound_by": k1_by,
           "candidate_reads": reads, "k1_rounds": len(rounds),
           "share": k1_ms / ms}
    _check(row)
    return row


def card() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def run(ops_per_s: float | None = None) -> list[dict]:
    """The four rows on the card, each with the card's name and power
    limit; raises without a CUDA device, or where a share passes 1.0."""
    if not torch.cuda.is_available():
        raise RuntimeError("roofline times the card: no CUDA device")
    dev = torch.device("cuda")
    ops_per_s = ops_per_s or int_ops_per_s()
    where = card()
    rows = [bp_totals(dev), sparse_fetch(dev, ops_per_s=ops_per_s),
            osd0_device(dev), uf_mosaic(dev, ops_per_s=ops_per_s)]
    for row in rows:
        row["card"] = where
    return rows


def main() -> list[dict]:
    rows = run()
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
