#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`qcss_tpu_torch`) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from `qcss_tpu_torch/csrc` (nvcc, sm_90a, one
process per source) and drives the port's paths on the card: the
circuit-level surface-code memory with sampling and decoding fused, at
distance 11 over 11 rounds; the code-capacity Monte Carlo with the packed
GF(2) kernels; the unbounded-round streaming memory (sliding windows
on the stencil kernel, carry lanes in spilled chunks) with the staged
routes of the same decode; the stabilizer tableaus with the fused
measurement kernel K9; and the host decoders (`qcss_tpu_torch/native`,
built with g++) on the card's samples, with the parallel-window decoder on
the stencil kernel:

1. prints the toolchain and the card;
2. builds the kernels, and the host library with g++ meanwhile;
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
   W = 1, one logical row), and K6 and K8 where their instances split
   (views one word past a 16-byte boundary, ragged batches, R = 1, 60
   and 61, W = 13, LUTs of 2^14 and 2^16 rows);
   then K1 on graphs with spilled lanes (the d=11 mid-window graphs of
   the streaming decoder, phenomenological and circuit-level: packed,
   activity, every chunk plane, every lane and convergence), K3, K4 and
   K5 on the state entering growth rounds 1 to 3 of the d=11 decode, K4
   also on a trap state (act values 2 and -1, passes on edges past the
   last vertex), the two staged decodes against K1's labels, and the
   generic packed and
   unpacked decoders on the card against the CPU;
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
   main path 4: the streaming memory, `benchmarks/stream_bench.py` at
   d=11, B=8192, 800 rounds, p=q=0.004, window 8, commit 4 (round-shots/s)
   and `stream_memory_rate_dem` over 96 rounds; the card's d=5 failure
   count against the CPU's; K1 must have launched on chunk graphs. Main
   path 5: `decode_stencil_staged` and `decode_stencil_fused` at B=16384
   on the d=11 graph; K3, K4 and K5 must have launched;
   main path 6, the tableau slice: K9 against its plain version (the
   scan of `tableau_packed._measure_z`) bit for bit on outcomes, x, z and
   r, on random Clifford states at n = 7, 40, 121, 363 (B=1024) and
   n = 720 (B=1024, the form in device memory), and on the bench's ladder
   states, each measured-qubit list hitting both branches (the share of
   random outcomes printed); then, counted, the tableau bench
   (`benchmarks/tableau_bench.py`: unpacked, packed scan and K9 at
   n = 49, 121, 363, B=4096, 32 measured qubits) and
   `PackedEngine.measure_block` on the card against the plain version
   and, on 64 shots, the CPU engine; K9 must have launched. Then `z_memory_experiment` and
   `x_memory_experiment` (Steane, R=3, B=1024, seed 7) with
   engine='tableau' must equal engine='frames' bit for bit;
   main path 7, the host decoders and the parallel window: the native
   library (built with g++ beside the kernels) must have loaded;
   `memory_experiment` at d=11, R=11, engine='frames', B=16384 with
   decoder='dem' and 'device-dem' at one seed (their failure counts
   within the reference's bound, 8 at B=8192, scaled to the batch),
   'uf', and 'dem-mwpm' at B=4096 (shots/s each); `DeviceUFDecoder`
   against `UFDecoder` on the d=11 DEM detectors (agreement above the
   reference's 0.93; built without caps, no shot may go to the host); and
   `benchmarks/pw_bench.py` at d = 5, 7, 11 (B=4096, R=96, p=q=0.004,
   core d, buf int(1.5 d)): `ParallelWindowDecoder.decode_stream` on
   the card equal to the CPU's plain path on 256 shots, its shots/s and
   failure rate against `DeviceStreamingDecoder`'s; K1 must have launched
   on the parallel window's chunk graphs at every distance, counted
   around the parallel window's own calls;
9. times each kernel, its plain version and (K6, K7) the dense matmul
   form at the main paths' shapes, beside each kernel's bound, checking
   each timed output against the plain version's; K9 and K2 through
   `benchmarks/measure_sparse_bench.py` (the wrapper, and a launch in a
   CUDA graph hot and cold over data 3x the L2): K9 at n = 49, 121, 363,
   B=4096, M=32 on the ladder state (random branch) and at n = 121, 363 on
   measured-once random Clifford states (deterministic branch), each with
   its launch plan (form, shots a block, shared memory, registers); K2 at
   d=11, B=16384, d_max=48 with its plan, its defects, events, mask
   builds and sweeps a shot, and a bound from its bytes and the pair tests
   (event searches, mask builds) a walk of its plain version counts; K3,
   K4 and K5 through `benchmarks/staged_bench.py` (a launch of the bare
   entry point in a CUDA graph at B=16384 on the state entering round 2,
   the wrapper beside it, and a copy_ of as many bytes as each kernel's
   interface moves) with K3's, K4's and K5's launch plans (shots a block,
   shared memory, registers, the tables' form); prints K1's launch plan
   (shots a block, shared memory, registers) and the work its data need at
   its three shapes, the parallel window's d=11 interior window the third
   (shots running, live vertices and sweeps per round,
   counted with the plain version on the card; the bound counts those
   candidate reads); times K7 alone and through its wrapper at every
   sweep distance; times K6 and K8 through their wrappers and, as device
   time a launch from a CUDA graph, alone on one buffer and over data
   larger than the L2, at their four shapes and at B=2^10
   (`benchmarks/gf2_bench.py`), and prints their launch plans; and times
   one round's decode at the headline's shape
   in the packed form the Monte Carlo runs and in the reference's dense
   forms.

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
import threading
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
STREAM_BATCH = 1 << 13
STREAM_ROUNDS = 800
STREAM_DEM_ROUNDS = 96
STREAM_P = 0.004
WINDOW, COMMIT = 8, 4
TAB_BATCH = 4096
TAB_CHECK_BATCH = 1024
TAB_QUBITS = (49, 121, 363)
MWPM_BATCH = 4096
PW_DISTANCES = (5, 7, 11)
PW_BATCH = 4096
PW_ROUNDS = 96
PW_P = 0.004
PW_CHECK = 256
PW_REPS = 3
Z999 = 3.2905


def log(msg: str) -> None:
    print(msg, flush=True)


def run_text(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


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


def k1_work(duf, dg, defect):
    """What K1's data need, counted with its plain version on the card (the
    round loop of `device_uf._stencil_rounds`, one Jacobi sweep a call of
    `_propagate`). The plain loop is batch-wide; K1 stops each shot when
    it is quiet, so a round counts the shots still running in it: their
    number, their mean live vertices (the defects and the ends of
    saturated edges and slots), the mean and largest sweeps they take
    (the last, changeless sweep included); and the candidate reads those
    sweeps make over the live vertices, (2O + KB) a vertex and sweep,
    summed over the batch. Returns (rounds, reads, packed), packed the
    plain version's final labels."""
    import torch

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


def k1_report(label, device_uf_cuda, duf, dg, defect, int_ops_per_s):
    """K1's launch plan and the work its data need at one shape, logged;
    returns (plan, work, bound) for the kernels line. The bound counts each
    input and output byte once (defects in, labels, activity and chunk
    words out, the edge words and chunk tables) and the candidate reads of
    `k1_work` as integer operations."""
    from qcss_tpu_torch.benchmarks.profiling import bound

    st = dg.stencil
    B, V = defect.shape
    NC = len(st.chunks)
    plan = device_uf_cuda.stencil_full_config(dg)
    log(f"K1 plan at {label}: {plan['shots_per_block']} shots (warps) a "
        f"block, {plan['smem_bytes']} bytes of shared memory a block "
        f"({plan['shot_bytes']} a shot; tables "
        f"{'staged' if plan['tables_in_smem'] else 'in device memory'}), "
        f"{plan['registers']} registers, {plan['blocks_per_sm']} block(s) "
        f"an SM, {plan['form']} edge words")
    rounds, reads, packed = k1_work(duf, dg, defect)
    k_packed = device_uf_cuda.stencil_full(dg, defect)[0]
    if not bool((k_packed == packed).all()):
        raise RuntimeError(f"K1 disagrees with the walked plain version at "
                           f"{label}")
    log(f"K1 work at {label} (plain version on the card): shots running "
        f"per round " + " / ".join(str(r["shots"]) for r in rounds)
        + "; their live vertices a shot " + " / ".join(
            f"{r['live_mean']:.2f}" for r in rounds)
        + f" of {V}; sweeps a round, mean " + " / ".join(
            f"{r['sweeps_mean']:.2f}" for r in rounds)
        + ", max " + " / ".join(str(r["sweeps_max"]) for r in rounds)
        + f"; {reads} candidate reads")
    words = st.kernel_words(dg.pack_shift)[0]
    nbytes = 4 * ((3 + NC) * B * V + words.numel() + len(st.deltas)
                  + (st.kernel_chunk_tables.numel() if NC else 0))
    return plan, {"rounds": rounds, "candidate_reads": reads}, bound(
        nbytes, reads, int_ops_per_s)


def tableau_slice(dev, int_ops_per_s):
    """Main path 6: K9 against its plain version, the tableau bench and
    the block engine (counted), the tableau memory engine against the
    frames engine, and K9's times and bound. Returns (K9's entry of the
    kernels line, the bench rows, the memory results)."""
    import numpy as np
    import torch

    from qcss_tpu_torch.benchmarks import measure_sparse_bench as msb
    from qcss_tpu_torch.benchmarks import tableau_bench
    from qcss_tpu_torch.codes import families
    from qcss_tpu_torch.experiments.memory import (
        x_memory_experiment,
        z_memory_experiment,
    )
    from qcss_tpu_torch.ftqc.engines import PackedEngine
    from qcss_tpu_torch.sim import cuda_measure
    from qcss_tpu_torch.sim import tableau as tb
    from qcss_tpu_torch.sim import tableau_packed as tp
    from qcss_tpu_torch.sim.noise import NoiseModel

    def ladder(n, batch):
        """The bench's ladder state, packed, on the card."""
        return tp.run_circuit(tp.zero_state(batch, n, dev),
                              tableau_bench.ladder_circuit(n))

    def check(label, t, qs, seed):
        bits = tb.collapse_bits(torch.Generator(device=dev).manual_seed(seed),
                                t.batch, len(qs))
        tk, ok = cuda_measure.measure_many_cuda(t, qs, bits)
        tpl, op, rand, _ = msb.k9_walk(t, qs, bits)
        torch.cuda.synchronize()
        err = max(max_abs(ok, op), max_abs_words(tk.x, tpl.x),
                  max_abs_words(tk.z, tpl.z), max_abs(tk.r, tpl.r))
        share = float(rand.to(torch.float32).mean())
        if err or not 0.0 < share < 1.0:
            raise RuntimeError(f"K9 on {label}: max abs err {err} against its "
                               f"plain version, random share {share}")
        form = ("shared" if cuda_measure.in_shared_memory(t.n, t.words)
                else "device")
        log(f"K9 == plain version on {label} (B={t.batch}, M={len(qs)}, "
            f"W={t.words}, tableau in {form} memory): outcomes, x, z, r; "
            f"{share:.4f} of the outcomes random")
        return err, form

    # -- (a) K9 against its plain version, bit for bit
    k9_err = 0
    forms = set()
    for n in (7, 40, 121, 363, 720):
        t, rng = msb.random_clifford(n, TAB_CHECK_BATCH, n, dev)
        first = rng.choice(n, min(n, 24), replace=False)
        qs = np.concatenate([first, first[:8]])  # repeats: deterministic
        if n > 32:
            qs[0] = 31  # bit 31 of a word
        err, form = check(f"a random Clifford state, n={n}", t, qs, n)
        k9_err = max(k9_err, err)
        forms.add(form)
    if forms != {"shared", "device"}:
        raise RuntimeError(f"K9 ran in {forms} memory only; both forms must")
    for n in TAB_QUBITS:
        t = ladder(n, TAB_CHECK_BATCH)
        qs = tableau_bench.measured_qubits(n)
        k9_err = max(k9_err, check(f"the ladder state, n={n}", t,
                                   np.concatenate([qs, qs[:4]]), 100 + n)[0])

    # -- main path 6: the tableau bench and the block engine, counted
    cuda_measure.launches = 0
    t0 = time.perf_counter()
    bench_rows = tableau_bench.run(TAB_BATCH, TAB_QUBITS, reps=3, seed=0)
    for row in bench_rows:
        print(json.dumps(row), flush=True)
    eng = PackedEngine(121, 2, NoiseModel())
    arrays = tableau_bench.ladder_circuit(121).to_arrays()
    st = eng.zero_state(TAB_CHECK_BATCH, dev)
    for b in range(2):
        st = eng.run_block_circuit(st, arrays, b)
    bits = tb.collapse_bits(torch.Generator(device=dev).manual_seed(4),
                            TAB_CHECK_BATCH, 121)
    got = eng.measure_block(st, 1, rand_bits=bits)
    n_k9 = cuda_measure.launches
    # against the plain version on the card, and the CPU engine on the
    # first 64 shots (the CPU is slow at this size)
    want = tp.measure_many(st, eng.block_qubits(1), rand_bits=bits)
    cpu = eng.measure_block(tp.PackedTableau(st.x[:64].cpu(), st.z[:64].cpu(),
                                             st.r[:64].cpu(), st.n), 1,
                            rand_bits=bits[:64].cpu())
    pairs = [(got[1], want[1]), (got[0].x, want[0].x), (got[0].z, want[0].z),
             (got[0].r, want[0].r), (got[1][:64].cpu(), cpu[1]),
             (got[0].x[:64].cpu(), cpu[0].x), (got[0].r[:64].cpu(), cpu[0].r)]
    k9_err = max([k9_err] + [max_abs_words(a, b) for a, b in pairs])
    if k9_err:
        raise RuntimeError("PackedEngine.measure_block on the card disagrees "
                           "with the plain version or the CPU engine")
    log(f"main path 6 ({time.perf_counter() - t0:.1f} s): tableau bench at "
        f"n={TAB_QUBITS}, B={TAB_BATCH}, and PackedEngine.measure_block "
        f"(n=121, 2 blocks, B={TAB_CHECK_BATCH}) == the plain version and "
        f"the CPU engine; K9 launches {n_k9}")
    if n_k9 <= 0:
        raise RuntimeError("K9 was never launched by main path 6")

    # -- (c) the memory engines, bit for bit on the card
    memory = {}
    noise = NoiseModel(p_gate2=2e-3, p_meas=1e-2)
    for basis, fn in (("z", z_memory_experiment), ("x", x_memory_experiment)):
        res = {engine: fn(families.steane(), rounds=3, noise=noise,
                          batch=1024, seed=7, engine=engine, device="cuda")
               for engine in ("tableau", "frames")}
        a, b = res["tableau"], res["frames"]
        if (a["logical_fail"], a["residual_syndrome"]) != \
                (b["logical_fail"], b["residual_syndrome"]) \
                or a["logical_fail"] <= 0:
            raise RuntimeError(f"{basis}-basis memory: the tableau engine "
                               f"{a} disagrees with the frames engine {b}")
        memory[basis] = a
        log(f"{basis}_memory_experiment Steane R=3 B=1024 seed 7: tableau == "
            f"frames, logical_fail {a['logical_fail']:.6f}, residual "
            f"{a['residual_syndrome']:.6f}")

    # -- (d) K9's times and bounds (benchmarks/measure_sparse_bench.py):
    #    the ladder states at n = 49, 121, 363 (every outcome random) and
    #    measured-once random Clifford states at n = 121, 363 (every outcome
    #    deterministic); each row checks the kernel against its plain
    #    version first and carries the launch plan
    rows = {}
    for case in msb.k9_cases(dev):
        row = msb.k9_row(case, 20, int_ops_per_s)
        branch = "random" if row["random_share"] == 1.0 else "deterministic"
        if row["random_share"] not in (0.0, 1.0):
            raise RuntimeError(f"K9 case at n={row['n']} mixes branches")
        rows[branch, row["n"]] = row
        plan = row["plan"]
        log(f"K9 {branch} n={row['n']} B={row['B']} M={row['M']}: wrapper "
            f"{row['ms']:.4f} ms (host {row['host_ms']:.4f}), a launch in a "
            f"graph {row['hot_ms']:.4f} hot, {row['cold_ms']:.4f} cold; plain "
            f"{row['plain_ms']:.3f} ms; bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}); form {plan['form']} "
            f"({cuda_measure.FORMS[plan['form']]}), {plan['shots_per_block']} "
            f"shots a block, {plan['threads']} threads, {plan['smem_bytes']} "
            f"B shared, {plan['registers']} registers, "
            f"{plan['resident_blocks']} blocks resident")
    keep = ("ms", "host_ms", "hot_ms", "cold_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "random_share", "int_ops", "plan")

    def entry(branch, n):
        row = rows[branch, n]
        return {"shape": f"B={row['B']} n={n} W={row['W']} M={row['M']} "
                         f"({row['branch']})", **{k: row[k] for k in keep}}

    k9 = {"name": "chp_measure", "route": "cuda",
          "source": "qcss_tpu_torch/csrc/chp_measure.cu",
          "replaces": "qcss_tpu/sim/pallas_measure.py:193",
          "launches": n_k9, "max_abs_err": k9_err,
          **entry("random", 363), "n121": entry("random", 121),
          "n49": entry("random", 49),
          "deterministic": {"n121": entry("deterministic", 121),
                            "n363": entry("deterministic", 363)}}
    return k9, bench_rows, memory


def path7(dev, code, noise, graph, dets_big):
    """Main path 7: (a) the native library, (b) `memory_experiment` at d=11
    with the host decoders ('dem' against 'device-dem' at one seed, within
    the reference's bound scaled to the batch; 'uf'; 'dem-mwpm' at
    MWPM_BATCH), (c) `DeviceUFDecoder` against `UFDecoder` on the d=11 DEM
    detectors, (d) the pw_bench configuration. Returns (host decoder rows,
    parallel-window rows, K1 launches of the path, the (c) agreement)."""
    import numpy as np
    import torch

    from qcss_tpu_torch import native
    from qcss_tpu_torch.benchmarks import pw_bench
    from qcss_tpu_torch.decode import device_uf_cuda
    from qcss_tpu_torch.decode.device_uf import DeviceUFDecoder
    from qcss_tpu_torch.decode.uf import UFDecoder
    from qcss_tpu_torch.experiments.memory import memory_experiment

    device_uf_cuda.launches = device_uf_cuda.chunk_launches = 0
    # (a)
    if not native.available():
        raise RuntimeError(f"the native library did not build: "
                           f"{native.load_error}")
    built = ("already built" if native.build_seconds is None else
             f"g++ build {native.build_seconds:.2f} s")
    log(f"path 7 (a): native library {native.library_path()} loaded "
        f"({built})")
    # (b)
    host = {}
    for decoder, batch in (("dem", BATCH), ("device-dem", BATCH),
                           ("uf", BATCH), ("dem-mwpm", MWPM_BATCH)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = memory_experiment(code, rounds=ROUNDS, noise=noise,
                                decoder=decoder, engine="frames",
                                batch=batch, seed=17, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        host[decoder] = {"batch": batch,
                         "failures": round(out["logical_fail"] * batch),
                         "logical_fail": out["logical_fail"],
                         "residual_syndrome": out["residual_syndrome"],
                         "wall_s": dt, "shots_per_sec": batch / dt}
        log(f"path 7 (b): memory_experiment d={D} R={ROUNDS} frames "
            f"decoder={decoder} B={batch}: {batch / dt:.1f} shots/s "
            f"({dt:.3f} s, graph build included), "
            f"{host[decoder]['failures']} failures, residual "
            f"{out['residual_syndrome']}")
    # the reference's bound (tests/test_device_uf.py): fewer than 8
    # failures apart at B = 8192, here scaled to the batch
    allowed = 8 * BATCH / 8192
    apart = abs(host["dem"]["failures"] - host["device-dem"]["failures"])
    log(f"path 7 (b): dem against device-dem at one seed: {apart} failures "
        f"apart (allowed < {allowed:g})")
    if apart >= allowed:
        raise RuntimeError("dem and device-dem disagree past the "
                           "reference's bound")
    for row in host.values():
        if not 0.0 <= row["logical_fail"] < 0.05:
            raise RuntimeError(f"implausible failure rate {row}")
    # (c)
    before = device_uf_cuda.launches
    ddec = DeviceUFDecoder(graph, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, obs_dev = ddec.decode_batch(dets_big)
    dt_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, obs_host = UFDecoder(graph).decode_batch(dets_big.cpu().numpy(),
                                                want_corrections=False)
    dt_host = time.perf_counter() - t0
    agree = float(np.mean((obs_dev & 1) == (obs_host & 1)))
    log(f"path 7 (c): DeviceUFDecoder against UFDecoder on {len(obs_dev)} "
        f"d={D} DEM detector rows: agreement {agree:.6f} (the reference's "
        f"bound > 0.93), {ddec.fallback_shots} shots sent to the host; "
        f"device {len(obs_dev) / dt_dev:.1f} shots/s, host "
        f"{len(obs_dev) / dt_host:.1f} shots/s")
    if agree <= 0.93:
        raise RuntimeError("DeviceUFDecoder disagrees with UFDecoder past "
                           "the reference's bound")
    # built without caps, every shot converges in K1: a shot sent to the
    # host means K1 failed it
    if ddec.fallback_shots:
        raise RuntimeError(f"DeviceUFDecoder without caps sent "
                           f"{ddec.fallback_shots} shots to the host")
    if device_uf_cuda.launches == before:
        raise RuntimeError("DeviceUFDecoder did not launch K1")
    # (d)
    rows = []
    for d in PW_DISTANCES:
        row = pw_bench.run(d, PW_ROUNDS, PW_BATCH, PW_P, PW_REPS, PW_CHECK)
        rows.append(row)
        log(f"path 7 (d): pw_bench d={d} R={PW_ROUNDS} B={PW_BATCH} "
            f"p=q={PW_P} core={row['core']} buf={row['buf']}: parallel "
            f"window {row['pw_shots_per_sec']:.1f} shots/s (fail "
            f"{row['pw_fail']:.6f}), forward streaming "
            f"{row['fw_shots_per_sec']:.1f} shots/s (fail "
            f"{row['fw_fail']:.6f}), speedup {row['speedup']:.3f}, "
            f"agreement {row['pw_fw_agree']:.6f}; K1 launches a "
            f"decode_stream call {row['pw_launches']:g} "
            f"({row['pw_chunk_launches']:g} on chunk graphs); the CPU's "
            f"plain path on {PW_CHECK} shots equal: {row['check_equal']}")
        if not row["check_equal"]:
            raise RuntimeError(f"the parallel window on the card disagrees "
                               f"with the CPU at d={d}")
        # counted around the parallel window's own calls only (the
        # forward decoder's windows launch K1 on chunk graphs too)
        if row["pw_chunk_launches_total"] <= 0:
            raise RuntimeError(f"K1 was not launched on the parallel "
                               f"window's chunk graphs at d={d}")
        if not (row["pw_fail"] < 0.05 and row["fw_fail"] < 0.05):
            raise RuntimeError(f"implausible failure rates {row}")
    launches = {"all": device_uf_cuda.launches,
                "chunks": device_uf_cuda.chunk_launches,
                "pw": sum(r["pw_launches_total"] for r in rows),
                "pw_chunks": sum(r["pw_chunk_launches_total"]
                                 for r in rows)}
    log(f"main path 7 launches: stencil kernel {launches['all']}, "
        f"{launches['chunks']} of them with chunks; the parallel window's "
        f"own {launches['pw']}, {launches['pw_chunks']} with chunks")
    return host, rows, launches, agree


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

    from qcss_tpu_torch import _cuda, native
    from qcss_tpu_torch.benchmarks import (
        gf2_bench,
        measure_sparse_bench as msb,
        pw_bench,
        staged_bench,
        steane_mc,
        stream_bench,
        syndrome_sweep,
    )
    from qcss_tpu_torch.benchmarks.device_uf_bench import build_pipeline
    from qcss_tpu_torch.benchmarks.profiling import (
        bound,
        cuda_ms,
        host_ms,
        int_ops_per_s as card_int_ops_per_s,
    )
    from qcss_tpu_torch.benchmarks.device_uf_bench import run as bench_run
    from qcss_tpu_torch.codes import families
    from qcss_tpu_torch.codes.families import rotated_surface
    from qcss_tpu_torch.decode import device_sparse as dsp
    from qcss_tpu_torch.decode import device_sparse_cuda, device_uf_cuda
    from qcss_tpu_torch.decode import device_uf as duf
    from qcss_tpu_torch.decode import device_uf_staged as dstaged
    from qcss_tpu_torch.decode import montecarlo
    from qcss_tpu_torch.decode.dem import extraction_gate_list
    from qcss_tpu_torch.decode.device_streaming import (
        DeviceStreamingDecoder,
        stream_memory_rate,
        stream_memory_rate_dem,
    )
    from qcss_tpu_torch.decode.streaming import (
        _window_graph,
        sample_phenomenological_stream,
    )
    from qcss_tpu_torch.decode.montecarlo import logical_error_rate
    from qcss_tpu_torch.decode.parallel_window import ParallelWindowDecoder
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
    int_ops_per_s = card_int_ops_per_s()
    log(f"integer bound rate: SMs x 64 lanes x the top SM clock = "
        f"{int_ops_per_s:.4g} ops/s")

    # -- 2. build: the host library (g++) beside the kernels (nvcc)
    t0 = time.perf_counter()
    native_build = threading.Thread(target=native.available)
    native_build.start()
    _cuda.load()
    native_build.join()
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
    packed_k, act_k, _ = device_uf_cuda.stencil_full(dg, defect)
    packed_p, act_p, _ = duf._stencil_plain(dg, defect)
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
    # K6 and K8 where their instances split: a view one word past a
    # 16-byte boundary (the generic instance), ragged batches, R = 1, 60
    # and 61, a wide check, and K8 LUTs of 2^14 rows (64 KB, staged in
    # shared memory past 48 KB) and 2^16 (256 KB, gathered from device
    # memory)
    for W, R, B in ((1, 1, 1000003), (4, 60, 4097), (4, 61, 4097),
                    (13, 61, 1001), (1, 14, 100003), (3, 14, 4099),
                    (1, 16, 100003)):
        h = random_words(gen_w, (R, W))
        lut = random_words(gen_w, (1 << R, W)) if R <= 16 else None
        for offset in (0, 1):
            e = random_words(gen_w, (B * W + offset,))[offset:].view(B, W)
            k6, p6 = cuda_gf2.syndromes_packed_cuda(e, h), \
                cuda_gf2.syndromes_packed_plain(e, h)
            k8, p8 = (cuda_gf2.decode_residual_packed_cuda(e, h, lut),
                      cuda_gf2.decode_residual_packed_plain(e, h, lut)) \
                if lut is not None else (e, e)
            torch.cuda.synchronize()
            k6_err = max(k6_err, max_abs(k6, p6))
            k8_err = max(k8_err, max_abs_words(k8, p8))
            if k6_err or k8_err or not (torch.equal(k6, p6)
                                        and torch.equal(k8, p8)):
                raise RuntimeError(
                    f"K6/K8 disagree with their plain versions at W={W} "
                    f"R={R} B={B} offset={offset} (max abs err {k6_err}, "
                    f"{k8_err})")
            plan = cuda_gf2.launch_plan("syndromes_packed", e, h)
            log(f"K6{' and K8' if lut is not None else ''} == plain "
                f"versions at W={W} R={R} B={B}, a view {offset} word(s) "
                f"into its buffer (instance {plan['instance']})")


    # -- 5b. K1 on graphs with spilled lanes: the streaming decoder's d=11
    #    mid-window graphs, on 1024 sampled window rows each
    raw = code.raw_parity_check_c2
    lz = code.z_operator_matrix()
    gates = extraction_gate_list(code, raw)
    t0 = time.perf_counter()
    windows = {
        "phenomenological": DeviceStreamingDecoder(
            raw, lz, window=WINDOW, commit=COMMIT, p_space=STREAM_P,
            p_time=STREAM_P, device=dev),
        "circuit-level": DeviceStreamingDecoder.from_dem(
            raw, lz, gates, window=WINDOW, commit=COMMIT,
            p_gate2=noise.p_gate2, p_meas=noise.p_meas, device=dev),
    }
    log(f"built the d={D} mid-window graphs in "
        f"{time.perf_counter() - t0:.1f} s")
    win_rows = {
        "phenomenological": sample_phenomenological_stream(
            torch.Generator(device=dev).manual_seed(11), STREAM_P, STREAM_P,
            CHECK_ROWS, WINDOW, raw, lz)[0][:, :WINDOW].reshape(
                CHECK_ROWS, -1),
        "circuit-level": sample_dets(
            torch.Generator(device=dev).manual_seed(12), CHECK_ROWS,
            WINDOW)[0][:, :WINDOW * raw.shape[0]],
    }
    k1c_err = 0
    for name, dec in windows.items():
        mid = dec._mid
        NC = len(mid.stencil.chunks)
        if NC == 0:
            raise RuntimeError(f"the d={D} {name} mid-window graph must "
                               f"carry spilled lanes")
        wdef = duf.stencil_defect(mid, win_rows[name].contiguous())
        out_k = device_uf_cuda.stencil_full(mid, wdef)
        out_p = duf._stencil_plain(mid, wdef)
        torch.cuda.synchronize()
        lab_wk, conv_wk = duf._stencil_labels(mid, wdef, *out_k)
        lab_wp, conv_wp = duf._stencil_labels(mid, wdef, *out_p)
        planes = [(out_k[0], out_p[0]), (out_k[1], out_p[1]),
                  *zip(out_k[2], out_p[2]), *zip(lab_wk, lab_wp)]
        k1c_err = max([k1c_err] + [max_abs(a, b) for a, b in planes])
        if k1c_err or len(out_k[2]) != NC or len(lab_wk) != len(lab_wp) \
                or not torch.equal(conv_wk, conv_wp):
            raise RuntimeError(f"stencil kernel with chunks disagrees with "
                               f"its plain version on the {name} window "
                               f"graph (max abs err {k1c_err})")
        if not bool(conv_wk.all()):
            raise RuntimeError("a window row did not converge")
        carry_bits = sum(int((lab != 0).sum()) for lab in lab_wk[1:])
        log(f"K1 with chunks == plain version on {CHECK_ROWS} {name} window "
            f"rows: V={wdef.shape[1]} O={len(mid.stencil.deltas)} "
            f"KB={mid.stencil.bmask.shape[0]} L={mid.pack_shift} NC={NC}, "
            f"{len(lab_wk)} lanes (packed, act, chunk planes, lanes, "
            f"converged); mean {float(wdef.sum(1).float().mean()):.2f} "
            f"defects/row, {carry_bits} rows*lanes with a carry")

    # -- 5c. K3, K4, K5 on the state entering growth rounds 1-3 of the
    #    d=11 decode of the 1024 rows, and the two staged decodes
    O7 = len(st.deltas)
    k3_err = k4_err = k5_err = 0
    for rnd, state in enumerate(dstaged.round_inputs(dg, defect, 3), 1):
        packed_s, seed_s, sup_s = state["packed"], state["seed"], state["sup"]
        satm_s, satb_s = state["satm"], state["satb"]
        passes_s = state["passes"]
        got = device_uf_cuda.stencil_round(dg, packed_s, seed_s, sup_s)
        ref = duf._round_plain(dg, packed_s, seed_s, sup_s[:, :O7],
                               sup_s[:, O7:])
        ref = (ref[0], torch.cat([ref[1], ref[2]], dim=1), ref[3])
        k5_err = max([k5_err] + [max_abs(a, b) for a, b in zip(got, ref)])
        k4_err = max(k4_err, max_abs(
            device_uf_cuda.stencil_act(dg, seed_s, passes_s),
            duf._act_plain(dg, seed_s, passes_s)))
        k3 = device_uf_cuda.stencil_prop(dg, packed_s, satm_s, satb_s)
        k3_err = max(k3_err, max_abs(k3, got[0]), max_abs(
            k3, duf._prop_plain(dg, packed_s, satm_s, satb_s)))
        torch.cuda.synchronize()
        if k3_err or k4_err or k5_err:
            raise RuntimeError(
                f"a staged kernel disagrees with its plain version at round "
                f"{rnd} (max abs err K3 {k3_err}, K4 {k4_err}, K5 {k5_err})")
    # K4 on a trap state no decode hands it: act values 2 and -1 (the
    # output is 0/1), and a pass on every offset's edges past the last
    # vertex (dropped, as the plain version's shifts drop them)
    trap_act = state["seed"].clone()
    trap_act[::3, ::7] = 2
    trap_act[1::3, 3::11] = -1
    trap_pass = state["passes"].clone()
    for o, dlt in enumerate(st.deltas):
        trap_pass[:, o, defect.shape[1] - dlt:] = True
    k4_trap = device_uf_cuda.stencil_act(dg, trap_act, trap_pass)
    k4_err = max(k4_err, max_abs(k4_trap,
                                 duf._act_plain(dg, trap_act, trap_pass)))
    torch.cuda.synchronize()
    if k4_err or int(k4_trap.max()) != 1 or int(k4_trap.min()) != 0:
        raise RuntimeError(f"K4 disagrees with its plain version on the trap "
                           f"state (max abs err {k4_err})")
    log(f"K3 prop, K4 act, K5 round == plain versions on the state entering "
        f"rounds 1-3 of {CHECK_ROWS} rows; K4 also on a trap state (act "
        f"values 2 and -1, passes past the last vertex)")
    for fn in (dstaged.decode_stencil_staged, dstaged.decode_stencil_fused):
        lab_s, conv_s_ = fn(dg, dets)
        if not (torch.equal(lab_s[0], lab_k[0])
                and torch.equal(conv_s_, conv_k)):
            raise RuntimeError(f"{fn.__name__} disagrees with the stencil "
                               f"kernel's labels")
        log(f"{fn.__name__} == K1's labels and converged on {CHECK_ROWS} "
            f"rows")

    # -- 5d. the generic decoders (plain torch, as they are plain XLA in
    #    the reference): the card against the CPU, with and without per-shot
    #    weights. argmin's first-minimum tie-break decides their paths.
    g_win = _window_graph(raw, lz, WINDOW, True, STREAM_P, STREAM_P)[0]
    rng_lane = torch.Generator().manual_seed(5)
    wide = torch.randint(0, 1 << 30, (g_win.num_edges,), generator=rng_lane)
    rows256 = win_rows["phenomenological"][:256].contiguous()
    w256 = torch.randint(1, 9, (256, g_win.num_edges), generator=rng_lane,
                         dtype=torch.int32)
    for fn, dgen in ((duf._decode_packed,
                      duf.build_device_graph(g_win, stencil=False)),
                     (duf._decode_unpacked,
                      duf.build_device_graph(g_win,
                                             extra_lanes=(wide.numpy(),)))):
        for weights in (None, w256):
            lab_g, conv_g = fn(dgen.to(dev), rows256,
                               None if weights is None else weights.to(dev))
            lab_h, conv_h = fn(dgen, rows256.cpu(), weights)
            if not (all(torch.equal(a.cpu(), b) for a, b in zip(lab_g, lab_h))
                    and torch.equal(conv_g.cpu(), conv_h)
                    and bool(conv_h.all())):
                raise RuntimeError(f"{fn.__name__} on the card disagrees "
                                   f"with the CPU")
        log(f"{fn.__name__} on the card == on the CPU on 256 window rows "
            f"({len(lab_g)} lanes; with and without shot_weights)")

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


    # -- 8b. main path 4: the streaming memory, counted
    device_uf_cuda.launches = device_uf_cuda.chunk_launches = 0
    stream = stream_bench.run(D, STREAM_ROUNDS, STREAM_BATCH, STREAM_P,
                              STREAM_P, WINDOW, COMMIT, seed=0)
    t0 = time.perf_counter()
    stream_dem = stream_memory_rate_dem(
        code, noise, rounds=STREAM_DEM_ROUNDS, batch=STREAM_BATCH,
        window=WINDOW, commit=COMMIT, seed=2)
    torch.cuda.synchronize()
    stream_dem["wall_s"] = time.perf_counter() - t0
    stream_dem["round_shots_per_sec"] = (STREAM_DEM_ROUNDS * STREAM_BATCH
                                         / stream_dem["wall_s"])
    n_k1_stream = device_uf_cuda.launches
    n_k1_chunks = device_uf_cuda.chunk_launches
    log(f"stream_memory_rate d={D} B={STREAM_BATCH} R={STREAM_ROUNDS} "
        f"p=q={STREAM_P} window {WINDOW} commit {COMMIT}: "
        f"{stream['round_shots_per_sec']:.1f} round-shots/s "
        f"({stream['wall_s']:.3f} s, graph build included), logical_fail "
        f"{stream['logical_fail']:.6f}; K1 launches in the timed run "
        f"{stream['launches']}, {stream['chunk_launches']} on chunk graphs")
    log(f"stream_memory_rate_dem d={D} B={STREAM_BATCH} "
        f"R={STREAM_DEM_ROUNDS}: {stream_dem['round_shots_per_sec']:.1f} "
        f"round-shots/s ({stream_dem['wall_s']:.3f} s, graph build "
        f"included), logical_fail {stream_dem['logical_fail']:.6f}")
    log(f"main path 4 launches: stencil kernel {n_k1_stream}, "
        f"{n_k1_chunks} of them with chunks")
    want = (STREAM_ROUNDS - WINDOW) // COMMIT
    if stream["chunk_launches"] != want or n_k1_chunks <= want:
        raise RuntimeError(f"the streaming path launched the chunk kernel "
                           f"{stream['chunk_launches']} times in the timed "
                           f"run, {n_k1_chunks} in all; expected {want} and "
                           f"more")
    if not (0.0 <= stream["logical_fail"] < 0.05
            and 0.0 <= stream_dem["logical_fail"] < 0.05):
        raise RuntimeError("implausible streaming failure rates")
    hot_code = rotated_surface(5)
    fails = {}
    for where in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out = stream_memory_rate(
            hot_code.raw_parity_check_c2, hot_code.z_operator_matrix(),
            0.008, 0.008, rounds=100, batch=4096, window=WINDOW,
            commit=COMMIT, seed=3, device=where)
        fails[where] = round(out["logical_fail"] * 4096)
        log(f"stream d=5 R=100 B=4096 p=q=0.008 on {where}: "
            f"{fails[where]} failures, {time.perf_counter() - t0:.1f} s")
    ok, spread = two_sample_ok(fails["cuda"], 4096, fails["cpu"], 4096)
    log(f"d=5 stream: logical_fail on the card {fails['cuda'] / 4096:.6f}, "
        f"on the CPU {fails['cpu'] / 4096:.6f} (allowed difference "
        f"{spread:.6f})")
    if not (fails["cuda"] > 0 and ok):
        raise RuntimeError("the card's streaming failure rate disagrees "
                           "with the CPU's")

    # -- 8c. main path 5: the staged decodes at the fused memory's shape,
    #    counted and timed whole
    for k in device_uf_cuda.staged_launches:
        device_uf_cuda.staged_launches[k] = 0
    lab_full, conv_full = duf.decode_labels(dg, dets_big)
    staged_ms = {}
    for fn in (dstaged.decode_stencil_staged, dstaged.decode_stencil_fused):
        lab_s, conv_s_ = fn(dg, dets_big)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lab_s, conv_s_ = fn(dg, dets_big)
        torch.cuda.synchronize()
        staged_ms[fn.__name__] = (time.perf_counter() - t0) * 1e3
        if not (torch.equal(lab_s[0], lab_full[0])
                and torch.equal(conv_s_, conv_full)):
            raise RuntimeError(f"{fn.__name__} disagrees with K1 at "
                               f"B={BATCH}")
    n_staged = dict(device_uf_cuda.staged_launches)
    log(f"main path 5 launches (two calls of each decode): K3 "
        f"{n_staged['prop']}, K4 {n_staged['act']}, K5 {n_staged['round']}; "
        f"whole decode at B={BATCH}: staged "
        f"{staged_ms['decode_stencil_staged']:.3f} ms, fused "
        f"{staged_ms['decode_stencil_fused']:.3f} ms (== K1's labels)")
    if min(n_staged.values()) <= 0:
        raise RuntimeError("a staged kernel was never launched by its staged decode")

    # -- 8d. main path 6: the stabilizer tableaus and K9
    k9_entry, tab_rows, tab_memory = tableau_slice(dev, int_ops_per_s)

    # -- 8e. main path 7: the host decoders on the card's samples, the
    #    device union-find with its host fallback, and the parallel window
    #    (K1 on its chunk graphs), counted
    host, pw_rows, pw_launches, uf_agree = path7(
        dev, code, noise, graph, dets_big)

    # -- 9. kernel and plain-version times at the main paths' shapes
    defect_big = duf.stencil_defect(dg, dets_big)
    k1_ms = cuda_ms(lambda: device_uf_cuda.stencil_full(dg, defect_big), 20)
    k1_plain_ms = cuda_ms(lambda: duf._stencil_plain(dg, defect_big), 2)
    pk, ak, _ = device_uf_cuda.stencil_full(dg, defect_big)
    pp, ap, _ = duf._stencil_plain(dg, defect_big)
    k1_err = max(k1_err, max_abs(pk, pp), max_abs(ak, ap))
    # on all-zero detectors: the fixed cost of a row in and its labels out
    zero_big = torch.zeros_like(defect_big)
    k1_zero_ms = cuda_ms(lambda: device_uf_cuda.stencil_full(dg, zero_big),
                         20)
    k1_err = max([k1_err] + [max_abs(a, b) for a, b in zip(
        device_uf_cuda.stencil_full(dg, zero_big)[:2],
        duf._stencil_plain(dg, zero_big)[:2])])
    if k1_err:
        raise RuntimeError(f"stencil kernel disagrees at B={BATCH}")
    V1 = defect_big.shape[1]
    k1_plan, k1_need, k1_bound = k1_report(
        f"B={BATCH} V={V1} NC=0", device_uf_cuda, duf, dg, defect_big,
        int_ops_per_s)
    # K2 (benchmarks/measure_sparse_bench.py): checked against its plain
    # version, timed through its wrapper and as a launch in a CUDA graph
    # (hot, and cold over copies 3x the L2), its bound from the bytes and
    # from the pair tests (event searches, mask builds) a walk of the plain
    # version counts
    k2_row = msb.k2_row(tables_dev, dets_big, 20, int_ops_per_s)
    log(f"K1 stencil B={BATCH}: kernel {k1_ms:.4f} ms ({k1_zero_ms:.4f} ms "
        f"on all-zero detectors), plain {k1_plain_ms:.3f} ms, bound "
        f"{k1_bound[0]:.4f} ms ({k1_bound[1]})")
    k2_plan = k2_row["plan"]
    log(f"K2 sparse B={BATCH} d_max={D_MAX}: wrapper {k2_row['ms']:.4f} ms "
        f"(host {k2_row['host_ms']:.4f}), a launch in a graph "
        f"{k2_row['hot_ms']:.4f} hot, {k2_row['cold_ms']:.4f} cold; plain "
        f"{k2_row['plain_ms']:.3f} ms (compaction and distance fetch "
        f"included); bound {k2_row['bound_ms']:.4f} ms ({k2_row['bound_by']}"
        f"; {k2_row['bytes']} bytes, {k2_row['int_ops']:.4g} integer ops); "
        f"defects a shot {k2_row['defects_per_shot']}, events "
        f"{k2_row['events_per_shot']}, mask builds "
        f"{k2_row['mask_builds_per_shot']}, sweeps "
        f"{k2_row['sweeps_per_shot']}; {k2_plan['shots_per_block']} shots a "
        f"block, {k2_plan['smem_bytes']} "
        f"B shared, {k2_plan['registers']} registers, "
        f"{k2_plan['resident_blocks']} blocks resident")

    # K1 at the streaming window's shape, with chunks
    mid = windows["phenomenological"]._mid
    wdets = sample_phenomenological_stream(
        torch.Generator(device=dev).manual_seed(13), STREAM_P, STREAM_P,
        STREAM_BATCH, WINDOW, raw, lz)[0][:, :WINDOW].reshape(
            STREAM_BATCH, -1).contiguous()
    wdef = duf.stencil_defect(mid, wdets)
    k1w_ms = cuda_ms(lambda: device_uf_cuda.stencil_full(mid, wdef), 20)
    k1w_plain_ms = cuda_ms(lambda: duf._stencil_plain(mid, wdef), 2)
    wzero = torch.zeros_like(wdef)
    k1w_zero_ms = cuda_ms(lambda: device_uf_cuda.stencil_full(mid, wzero), 20)
    for x in (wdef, wzero):
        out_k = device_uf_cuda.stencil_full(mid, x)
        out_p = duf._stencil_plain(mid, x)
        k1c_err = max([k1c_err, max_abs(out_k[0], out_p[0]),
                       max_abs(out_k[1], out_p[1])]
                      + [max_abs(a, b) for a, b in zip(out_k[2], out_p[2])])
    if k1c_err:
        raise RuntimeError(f"stencil kernel with chunks disagrees at "
                           f"B={STREAM_BATCH}")
    Vw = wdef.shape[1]
    NCw = len(mid.stencil.chunks)
    k1w_plan, k1w_need, k1w_bound = k1_report(
        f"B={STREAM_BATCH} V={Vw} NC={NCw}", device_uf_cuda, duf, mid, wdef,
        int_ops_per_s)
    log(f"K1 stencil with chunks B={STREAM_BATCH} V={Vw} NC={NCw}: kernel "
        f"{k1w_ms:.4f} ms ({k1w_zero_ms:.4f} ms on all-zero detectors), "
        f"plain {k1w_plain_ms:.3f} ms, bound "
        f"{k1w_bound[0]:.4f} ms ({k1w_bound[1]})")
    # K1 at the parallel window's d=11 interior shape (core 11, buf 16: 43
    # slices, two 30-bit carry lanes a side, spilled), on the rows of the
    # interior call of path 7 (d)'s d=11 stream (the same generator seed)
    pwd = ParallelWindowDecoder(raw, lz, core=D, buf=int(1.5 * D),
                                device=dev)
    pmid = pwd._mid
    pdets, _ = sample_phenomenological_stream(
        torch.Generator(device=dev).manual_seed(D), PW_P, PW_P, PW_BATCH,
        PW_ROUNDS, raw, lz)
    stride = pwd.core + pwd.buf
    n_mid = (PW_ROUNDS + 1 + pwd.buf) // stride - 2
    pidx = torch.arange(1, n_mid + 1, device=dev)[:, None] * stride \
        - pwd.buf + torch.arange(pwd.core + 2 * pwd.buf, device=dev)[None, :]
    pdef = duf.stencil_defect(pmid, pdets[:, pidx].reshape(
        PW_BATCH * n_mid, -1).contiguous())
    k1p_ms = cuda_ms(lambda: device_uf_cuda.stencil_full(pmid, pdef), 5)
    k1p_plain_ms = cuda_ms(lambda: duf._stencil_plain(pmid, pdef), 1)
    out_k = device_uf_cuda.stencil_full(pmid, pdef)
    out_p = duf._stencil_plain(pmid, pdef)
    k1p_err = max([max_abs(out_k[0], out_p[0]), max_abs(out_k[1], out_p[1])]
                  + [max_abs(a, b) for a, b in zip(out_k[2], out_p[2])])
    if k1p_err:
        raise RuntimeError("stencil kernel disagrees at the parallel "
                           "window's interior shape")
    Vp, NCp = pdef.shape[1], len(pmid.stencil.chunks)
    k1p_label = f"B={pdef.shape[0]} V={Vp} NC={NCp}"
    k1p_plan, k1p_need, k1p_bound = k1_report(
        k1p_label, device_uf_cuda, duf, pmid, pdef, int_ops_per_s)
    log(f"K1 stencil at the parallel window's d={D} interior shape "
        f"{k1p_label}: kernel {k1p_ms:.4f} ms, plain {k1p_plain_ms:.3f} ms, "
        f"bound {k1p_bound[0]:.4f} ms ({k1p_bound[1]})")
    # an estimate from two runs, not a reading of one: K1's time here, on
    # rows sampled for this step, times the timed call's chunk launches,
    # over that call's wall time (`stream_bench --profile` reads the share
    # off one trace)
    stream["stencil_kernel_share_estimate"] = (
        k1w_ms * stream["chunk_launches"] / (stream["wall_s"] * 1e3))
    log(f"K1's share of the timed streaming call, estimated: {k1w_ms:.4f} "
        f"ms here x {stream['chunk_launches']} windows over that call's "
        f"{stream['wall_s']:.3f} s = "
        f"{stream['stencil_kernel_share_estimate']:.3f}")

    # K3, K4, K5 (`benchmarks/staged_bench.py`, which holds each against
    # its plain version first): device time a launch of the bare C entry
    # point in a CUDA graph at B=16384 on the state entering round 2 (every
    # input exceeds the L2), the wrapper back to back beside it, and the
    # bound from the bytes the function needs (int32 planes for labels and
    # supports, one byte an element for every 0/1 plane, the tables each
    # kernel reads) and, as a yardstick of the memory rate, a copy_ moving
    # as many bytes as the kernel's C interface; K3's, K4's and K5's launch
    # plans
    staged_plans = staged_bench.plans(dg)
    if sorted(staged_plans) != ["K3", "K4", "K5"]:
        raise RuntimeError(f"staged launch plans missing: {staged_plans}")
    for key, plan in staged_plans.items():
        log(f"{key} plan at V={V1}: {plan['shots_per_block']} shots (warps) "
            f"a block, {plan['smem_bytes']} B shared ({plan['shot_bytes']} a "
            f"shot; tables: {plan['form']}), {plan['registers']} registers, "
            f"{plan['blocks_per_sm']} block(s) an SM")
    staged = {}
    for row in staged_bench.kernel_rows(dg, dets_big, reps=20, rounds=2):
        if row["round"] != 2:
            continue
        key = row["kernel"]
        staged[key] = {k: row[k] for k in (
            "ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "io_bytes", "copy_ms")}
        staged[key]["plan"] = staged_plans[key]
        log(f"{key} B={BATCH} on round-2 state: a launch in a graph "
            f"{row['ms']:.4f} ms (wrapper {row['wrapper_ms']:.4f}; == plain), "
            f"plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}): {row['ms'] / row['bound_ms']:.2f}x; a "
            f"copy_ of its {row['io_bytes']} interface bytes "
            f"{row['copy_ms']:.4f} ms")

    # Integer operations counted per (shot, check row): one LOP3 per word
    # for acc ^= e & h, a popcount, and one or two to place the bit (K6:
    # & 1; K7: shift, or; K8: shift-or into the index); K8 adds one XOR
    # per word. Each input byte is read once and each output written once.
    # K6 and K8 (`gf2_bench`, which holds each against its plain version
    # first) at the headline's shapes (Steane, B = 2^22, one word), K8 on
    # Golay, K6 at d=11 and each at B=2^10 (their fixed cost): ms through
    # the wrapper, as every kernel here, and the device time a launch of
    # the bare C entry point from a CUDA graph, on one buffer (hot) and
    # over copies of the data larger than the L2 (cold)
    gf2_rows = gf2_bench.run(reps=100, ops_per_s=int_ops_per_s)
    times = {}
    for row in gf2_rows:
        log(f"{row['name']} B={row['B']} (R={row['R']}, W={row['W']}): "
            f"through the wrapper {row['ms']:.4f} ms (host "
            f"{row['host_ms']:.4f} ms a call); a launch in a graph "
            f"{row['hot_ms']:.4f} ms, over data larger than the L2 "
            f"{row['cold_ms']} ms; plain {row['plain_ms']:.4f} ms, dense "
            f"matmul form {row['library_ms']} ms; bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        if row["B"] >= SWEEP_BATCH and "uniform" not in row["name"]:
            kern = ("decode_residual_packed" if row["name"].startswith("K8")
                    else "syndromes_packed")
            e = torch.empty((1, row["W"]), dtype=torch.int32, device=dev)
            h = torch.empty((row["R"], row["W"]), dtype=torch.int32,
                            device=dev)
            log(f"{row['name']} plan: {cuda_gf2.launch_plan(kern, e, h)}")
    for key, name in (("K6", "K6 headline residual check"),
                      ("K8", "K8 Steane")):
        head = next(r for r in gf2_rows
                    if r["name"] == name and r["B"] == MC_BATCH)
        times[key] = {k: head[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "hot_ms",
            "cold_ms", "host_ms")}
        times[key]["by_shape"] = [
            r for r in gf2_rows if r["name"].startswith(key) and r is not head]
    # K7 where the sweep runs it hardest: d=11
    e_bits = (torch.rand((SWEEP_BATCH, code.n), generator=gen_w,
                         device=dev) < 0.5).to(torch.uint8)
    e11_t = packed(e_bits, dev).T.contiguous()
    h11_bits = torch.as_tensor(code.parity_check_c2, device=dev)
    R11, W11 = h11.shape
    k7 = lambda: cuda_gf2.syndromes_packed_t_cuda(e11_t, h11)
    k7_plain = lambda: cuda_gf2.syndromes_packed_t_plain(e11_t, h11)
    err = max_abs_words(k7(), k7_plain())
    if err:
        raise RuntimeError(f"K7 disagrees with its plain version at d={D} "
                           f"(max abs err {err})")
    times["K7"] = {"ms": cuda_ms(k7, 20), "plain_ms": cuda_ms(k7_plain, 3),
                   "library_ms": cuda_ms(lambda: gf2_torch.syndromes_dense(
                       e_bits, h11_bits), 20)}
    times["K7"]["bound_ms"], times["K7"]["bound_by"] = bound(
        4 * (W11 * SWEEP_BATCH + R11 * W11 + (R11 + 31) // 32 * SWEEP_BATCH),
        SWEEP_BATCH * R11 * (W11 + 3), int_ops_per_s)
    log(f"K7 at d={D} (B={SWEEP_BATCH}, R={R11}, W={W11}): kernel "
        f"{times['K7']['ms']:.4f} ms (== plain), plain "
        f"{times['K7']['plain_ms']:.4f} ms, dense matmul form "
        f"{times['K7']['library_ms']:.4f} ms, bound "
        f"{times['K7']['bound_ms']:.4f} ms ({times['K7']['bound_by']})")
    # K7 at the sweep's smaller distances, where an application is short:
    # the kernel alone (the C entry point on a preallocated output), the
    # wrapper's call (checks and allocation included), both by CUDA events
    # over back-to-back calls, and the host's time per wrapper call
    lib = _cuda.load()
    k7_by_d = {}
    for d in syndrome_sweep.DISTANCES:
        hd = packed(rotated_surface(d).parity_check_c2, dev)
        Rd, Wd = hd.shape
        e_t = random_words(gen_w, (Wd, SWEEP_BATCH))
        out = torch.empty(((Rd + 31) // 32, SWEEP_BATCH), dtype=torch.int32,
                          device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def bare(e_t=e_t, hd=hd, out=out, Rd=Rd, Wd=Wd, stream=stream):
            _cuda.check(lib.qcss_syndromes_packed_t(
                e_t.data_ptr(), hd.data_ptr(), SWEEP_BATCH, Wd, Rd,
                out.data_ptr(), stream), "qcss_syndromes_packed_t")

        bare()
        err = max_abs_words(out, cuda_gf2.syndromes_packed_t_plain(e_t, hd))
        if err:
            raise RuntimeError(f"K7 disagrees at d={d} (max abs err {err})")
        k7_err = max(k7_err, err)
        wrap = lambda e_t=e_t, hd=hd: cuda_gf2.syndromes_packed_t_cuda(e_t, hd)
        row = {"R": Rd, "W": Wd, "kernel_ms": cuda_ms(bare, 50),
               "wrapper_ms": cuda_ms(wrap, 50),
               "wrapper_host_ms": host_ms(wrap, 50)}
        row["bound_ms"], row["bound_by"] = bound(
            4 * (Wd * SWEEP_BATCH + Rd * Wd + (Rd + 31) // 32 * SWEEP_BATCH),
            SWEEP_BATCH * Rd * (Wd + 3), int_ops_per_s)
        k7_by_d[d] = row
        log(f"K7 d={d} B={SWEEP_BATCH} (R={Rd}, W={Wd}): kernel "
            f"{row['kernel_ms']:.4f} ms, through the wrapper "
            f"{row['wrapper_ms']:.4f} ms, host {row['wrapper_host_ms']:.4f} "
            f"ms a wrapper call; bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")
    times["K7"]["by_distance"] = k7_by_d

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
                      "stream": stream, "stream_dem": stream_dem,
                      "staged_decode_ms": staged_ms,
                      "tableau_bench": tab_rows,
                      "tableau_memory": tab_memory,
                      "host_decoders": host,
                      "device_uf_agreement": uf_agree,
                      "parallel_window": pw_rows,
                      "card": smi}), flush=True)
    lib_note = ("gf2_torch.syndromes_dense: one float32 torch.matmul with "
                "casts, on the unpacked [B, n] bits (another layout)")
    print(json.dumps({"kernels": [
        {"name": "uf_stencil_full", "route": "cuda",
         "source": "qcss_tpu_torch/csrc/uf_stencil_full.cu",
         "replaces": "qcss_tpu/decode/device_uf_pallas.py:367",
         "launches": n_k1, "max_abs_err": max(k1_err, k1c_err, k1p_err),
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None,
         "shape": f"B={BATCH} V={V1} NC=0 (fused memory)",
         "plan": k1_plan, "work": k1_need,
         "window": {"shape": f"B={STREAM_BATCH} V={Vw} NC={NCw} (streaming "
                             f"window)",
                    "launches": n_k1_chunks, "max_abs_err": k1c_err,
                    "ms": k1w_ms, "plain_ms": k1w_plain_ms,
                    "bound_ms": k1w_bound[0], "bound_by": k1w_bound[1],
                    "library_ms": None, "plan": k1w_plan,
                    "work": k1w_need},
         "parallel_window": {
             "shape": f"{k1p_label} (parallel window, d={D} interior)",
             "launches": pw_launches["pw"],
             "chunk_launches": pw_launches["pw_chunks"],
             "launches_by_d": {str(r["d"]): {
                 "launches": r["pw_launches_total"],
                 "chunk_launches": r["pw_chunk_launches_total"],
                 "per_decode_stream": r["pw_launches"]} for r in pw_rows},
             "max_abs_err": k1p_err, "ms": k1p_ms,
             "plain_ms": k1p_plain_ms, "bound_ms": k1p_bound[0],
             "bound_by": k1p_bound[1], "library_ms": None,
             "plan": k1p_plan, "work": k1p_need}},
        {"name": "uf_stencil_prop", "route": "cuda",
         "source": "qcss_tpu_torch/csrc/uf_stencil_staged.cu",
         "replaces": "qcss_tpu/decode/device_uf_pallas.py:74",
         "launches": n_staged["prop"], "max_abs_err": k3_err,
         **staged["K3"]},
        {"name": "uf_stencil_act", "route": "cuda",
         "source": "qcss_tpu_torch/csrc/uf_stencil_staged.cu",
         "replaces": "qcss_tpu/decode/device_uf_pallas.py:149",
         "launches": n_staged["act"], "max_abs_err": k4_err,
         **staged["K4"]},
        {"name": "uf_stencil_round", "route": "cuda",
         "source": "qcss_tpu_torch/csrc/uf_stencil_staged.cu",
         "replaces": "qcss_tpu/decode/device_uf_pallas.py:193",
         "launches": n_staged["round"], "max_abs_err": k5_err,
         **staged["K5"]},
        {"name": "sparse_growth", "route": "cuda",
         "source": "qcss_tpu_torch/csrc/sparse_growth.cu",
         "replaces": "qcss_tpu/decode/device_sparse.py:395",
         "launches": n_k2, "max_abs_err": k2_err,
         "shape": f"B={BATCH} V={dets_big.shape[1]} d_max={D_MAX} (d={D} "
                  f"R={ROUNDS} circuit-level detectors)",
         **{k: k2_row[k] for k in (
             "ms", "host_ms", "hot_ms", "cold_ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "bytes", "int_ops",
             "defects_per_shot", "events_per_shot", "sweeps_per_shot",
             "plan")}},
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
        k9_entry,
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
