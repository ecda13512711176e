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
   main path 8, the circuit-level qLDPC memory (BP+OSD in plain torch,
   no hand kernel on it): `qldpc_memory_experiment` on bb144, R=12,
   B=8192, both sectors, uniform p=2e-3, 32 BP iterations, through
   `benchmarks/bp_bench.py` (shots/s, wall seconds, word/x/z failure
   beside the reference's recorded 0.46% word failure as information,
   BP convergence, faults per sector, BP iterations, the OSD tail and its
   backend, the time split into sampler, graph build, detectors, BP and
   OSD, peak device memory); the device OSD-0 against the native host
   OSD-0 on that run's unconverged z-sector tail, bit for bit, and the
   device order-E sweep (order 2, lambda 16/10) against the host's by
   soft weight; the card's bb72 R=6 B=2048 x_fail against the CPU's by a
   two-sample 99.9% test; and `qldpc_stream_memory_rate` on bb72, R=24,
   B=4096, window 8, commit 4 (round-shots/s); one JSON line `qldpc`;
   main path 9, per-shot side-information decoding (plain torch and the
   host decoders; K1 on the static-weight arms): (a) belief-matching,
   `benchmarks/belief_bench.py` (`xz_memory_experiment(belief=32)`) at
   rotated surface d = 5, 7, R = d, B=16384, p_gate2=2e-3, p_meas=5e-3:
   independent, correlated and belief failures on the same shots, the
   time split (joint graph and DEM build, BP posteriors, the weight
   projection, host UF) and peak device memory; at d=5 the belief word
   failures may not exceed the independent ones; (b) the fused soft
   decode (`soft_device_memory_rate`, d=5, R=5, p=3e-3, sigma=0.7,
   B=8192, 4 reps; shots/s) and one batch's weighted device decode
   against the host `UFDecoder` with the same weights (agreement at
   least 0.99); (c) `erasure_phenomenological_error_rate` (d=5, p=1e-3,
   p_erase=0.01, 2^15 samples, batch 2^13, decoder='device'), heralded
   failures at most blind, K1 launched in the blind arm; (d)
   `leakage_memory_experiment` (d=5, R=10, p=1e-3, p_leak=5e-3,
   decoder='device': heralded, calibrated, blind) and
   `leakage_circuit_memory` (d=5, R=10, B=8192, p_leak=4e-3; heralded
   and blind), each leak fraction beside `expected_leak_profile`; (e)
   `MLDecoder` on the [[34,4,3]] hypergraph product of the [5,2,3] code
   at p=0.05 on 8192 syndromes, the card's flips equal to the CPU's but
   where the best two class scores tie within 1e-5 relative (counted),
   and `device_decode_fn` equal to `decode_flips` on the card; K1's
   launches over the path and per arm; one JSON line
   `side_information`;
   main path 10, lattice surgery and patch schedules (host union-find,
   K1 and K2): (a) `xx_merge_memory`, `xx_merge_split_memory` (p=q=4e-3),
   `surgery_cnot_memory`, `t_gadget_memory` and `parity_chain_memory`
   (p=q=3e-3) at d = 5, 7, B=32768, sampled on the card and decoded on
   the host (build, sample, read-back and decode seconds, peak memory),
   each d=5 count held against BASELINE.md's rate by a two-sample 99.9%
   test; (b) `schedule_memory_device` on `parity_chain_model(d)`,
   p=q=3e-3, B=16384, 4 reps: 'dense' at d = 5, 7 (K1 must launch) and
   'hybrid' at d=5 (K2 must launch), shots/s, each count against (a)'s
   host decode of the same model; (c) `xx_merge_circuit_memory` (d=5,
   uniform p=2e-3, B=8192: the frame sampler, then BP with the device
   OSD; BP convergence, rates, time split); (d) the fault distances of
   both T-gadget sectors at d = 3, 5 (every channel at d, each witness a
   closed odd cycle) and of the parity chain at d = 3, 5, 7; K1's and
   K2's launches over the path; then K1 at the chain's d=7 shape
   (V=2689, O=10; its plan and work) and K2 at d=5 (d_max=48) against
   their plain versions on the card's own detectors, timed; one JSON
   line `surgery`;
   main path 11, the compiled logical programs (`LogicalProgram`; K2 and
   the generic decoder, K1 on the two-level memory's level-2 graph): (a)
   the compiled CNOT at d=3, p=q=2e-3, B=2^15: bench.py's
   `compiled_cnot_sparse` (decoder='device-uf-sparse', 4 reps after a
   warm call with the same reps; K2 must launch) and decoder='device-uf'
   at d = 3, 5 (their graphs have 18 and 34 edge offsets, past K1's 10,
   so they decode in the generic plain decoder, as in the reference; the
   reason is printed), shots/s and failures, each against the host
   decode of the same model and the host decode against BASELINE.md's
   rate (two-sample 99.9%); (b) `run_full` (both sectors, p=q=2e-3) of
   CNOT(0,1); T(1); CNOT(1,2), standalone s, mx and the feedback program
   at d = 3, 5, every channel beside BASELINE.md's rate, each d=5 word
   failure below its d=3 one; (c) `run_circuit` at uniform p=1e-3: the
   compiled CNOT at d=3 (B=16384) and d=5 (B=8192) against BASELINE.md's
   rates, HZH and the feedback program at d=3 (the repaired init
   injection may move their X-sector rates; printed beside BASELINE.md's);
   (d) the two-level memory (d=3, k=3, rounds_l=3, p=q=4e-3),
   decoder='device-uf' (8192 x 4; K1 must launch on level 2) and 'host'
   (2048), level 2 well below level 1, and the route each level took;
   (e) `run_compiled_protocol` for the compiled CNOT at d=3 on the card's
   tableau, all four inputs: every detector zero, z0 = zc,
   z1 = zt ^ zc; (f) `logical_resource_report` on (a)'s and (b)'s
   points; the time split and peak memory of every part, K1's and K2's
   launches over (a)-(e); then K2 on 1024 of the d=5 CNOT's detector rows
   and K1 on 1024 level-2 rows against their plain versions, timed; one
   JSON line `logical`;
   main path 12, the FT transpiler (`rewrite_program` on the tableau
   engines; K9 in every block measurement and reset on 'packed'): (a) the
   deterministic programs of the JAX package's tests/test_ftqc.py and
   test_quil.py (X, Y, Z, XXX, YZ, HZH, S, feedback, superdense coding on
   all four bit pairs, GHZ4 with dedicated ancillas, repeat-until, the
   classical-op programs, ec_extractions=2, the two-entry Quil loop, X on
   the surface-3 and Shor codes) on both engines at B=1024, every outcome
   its gold and `__prep_fail__` 0; (b) the engines bit for bit (registers,
   prep_fail, frames) under the executor's own channels (p_meas = p_reset
   = p_idle = 0.01) at B=4096 on the X program, superdense coding and X
   with ec_extractions=2 and dedicated ancillas; (c) the noisy Steane X
   program (p_gate1 = p_gate2 = p_meas = 0.01) at B=16384 on both
   engines, its failures and prep_fail shots against the JAX package's
   count by two-sample 99.9% tests; (d) the flagship bench
   (benchmarks/ftqc_bench.py's X program on Steane and rotated surface
   d=5, B=16384, 2 warm and 3 timed calls, each fenced by a host read):
   shots/s and the correct fraction, 1.0; (e) K9's launches over the path
   (above 0 on 'packed', 0 on 'unpacked'), then K9 against its plain
   version bit for bit and timed on states the path measures (a block
   measurement of the packed X program: Steane, M=7, and surface-5,
   M=25, B=16384); one JSON line `ftqc`;
   main path 13, the Pauli-frame FT engine (`rewrite_program(...,
   tableau='frames')`, `FrameEngine`, parallel EC; no kernel, and K9 must
   launch 0 times): (a) the programs of (12 a) and the deterministic set
   of test_ftqc_frames.py (SSX, X then CNOT, Pauli feedback, repeat-until
   with a Pauli body) on 'frames' at B=1024, each at its gold with
   `__prep_fail__` 0 or refused with UnsupportedProgramError, the refused
   set equal to the JAX package's (`ftqc_programs.FRAMES_REFUSED`); (b)
   frames against unpacked bit for bit (registers, prep_fail, frames,
   votes) at B=16384 under gate, readout and reset noise, under idle
   noise, and with ec_extractions=2 on dedicated ancillas, with the shots
   carrying a frame counted; (c) the two-block X program under p_gate2 =
   p_idle = 3e-4 with dedicated ancillas, parallel against serial EC at
   B=16384: parallel fails less than half as often, each count against
   the JAX package's by a two-sample 99.9% test, and noiseless parallel
   EC exact; (d) `benchmarks/ftqc_bench.py` on 'frames' (Steane and
   surface d=5, B=16384, 2 warm and 3 timed calls, each fenced by a host
   read, correct fraction 1.0), its EC scaling at n_logical = 1, 2, 4
   (serial and parallel) and `benchmarks/idle_bench.py` at its defaults
   (dedicated-parallel x 2 below dedicated-serial's failures), shots/s
   beside the card's name and power limit; (e) K9's launches over the
   path (0), its seconds by part, peak memory, and frames' shots/s beside
   path 12's unpacked and packed rows; one JSON line `ftqc_frames`;
   main path 14, the rest of the FT transpiler (no kernel of its own; K9
   in the 'packed' break-even runs): (a) the unrolled engine
   (`rewrite_program(..., engine='unrolled')` over `FTProtocols`): the
   programs of (12 a) at B=1024, each at its gold with `__prep_fail__` 0
   or refused, the refused set equal to the JAX package's
   (`ftqc_programs.UNROLLED_REFUSED`); unrolled against scheduled bit for
   bit (registers, prep_fail, frames, the split count) at B=16384 on the X
   program and superdense coding under p_meas = p_reset = 0.01 and under
   p_gate1 = p_gate2 = 3e-3, the shots carrying a frame counted; under
   p_gate2 = p_idle = 3e-4 (the draws shift by design) by a two-sample
   99.9% test; on the feedback program bit for bit on the shots whose
   condition is 1 and by a two-sample test on the rest; the unrolled and
   scheduled engines' shots/s on the Steane X program (B=16384, 2 warm
   and 3 timed calls); (b) flag EC on 'frames' (`ec_mode='flag'`): the
   noiseless two-block program (test_flags.py:78's; X then CNOT where the
   code has no transversal H) at B=1024 on Steane, rotated surface d=3
   and triangular colour 3, exact; every weight-1 X and Z data error
   before one flag round in the frame, exactly where the code's LUT has
   one weight-1 error a syndrome, stabilizer-equivalent everywhere; the
   Steane X program at p = 1e-3 and 3e-3 (every channel), B=65536 each,
   failures(3e-3) > 4.5 x failures(1e-3), each count against the JAX
   package's by a two-sample 99.9% test; (c) `benchmarks/flag_bench.py`
   at its defaults (Steane, p = 1e-3 and 3e-4, 2^15 shots in chunks of
   2^13, both EC modes), flag EC's failures within two-sample 99.9% of
   Steane EC's or below them; (d) `benchmarks/fidelity.py` at its
   defaults and its noiseless encoded rate (0), `breakeven_probe.py`
   (`--shots 16384`, 'packed') and `breakeven.py` (`--ps 1e-3 3e-4
   --min-shots 65536 --chunk 32768`) on 'packed' and on 'frames', every
   rate with its Wilson interval, shots/s beside the card's name and power
   limit; (e) K9's launches by part (one a packed block measurement or
   reset in (d), 0 elsewhere), seconds by part and peak memory, then K9
   against its plain version bit for bit and timed on the last state
   breakeven 'packed' measured; one JSON line `ftqc_rest`;
   main path 15, magic states and the mesh (no kernel of its own; K8 and
   K6 in the injection's final decode, K1, K2, K6, K8 and K9 on the
   sharded pipelines' paths): (a) `distill_cascade(1e-2, 3)` (level 1
   within 20 p of 35 p^3), `benchmarks/magic_bench.py` at its defaults
   (the exact cascade; `distill_mc` at B=2^24 inside the exact map's 99.9%
   intervals; `distill_circuit` at p_clifford=1e-4, B=2^20; samples/s
   each; the factory row), every one of the 2^15 Z-injection patterns in
   one quiet `distill_circuit(inject=...)` batch, its accept / error bits
   equal to the coset membership computed on the host, and the quiet
   circuit at B=2^20 inside the exact map's intervals; (b)
   `magic_injection_experiment` on Steane at B=2^20: quiet (p_accept 1,
   eps = p_z inside p_t's interval), a certain T fault (Z̄ on every shot)
   and noisy (p=2e-3 everywhere: postselected eps below the
   unconditioned), K8 and K6 launched twice each a call (one a sector);
   `factory_report` at magic_bench's settings, equal to its factory row,
   fed into `logical_resource_report(factory=...)` for CNOT(0,1); T(1)
   priced from host-decoded failures at d = 3, 5; (c) the twelve
   pipelines of `qcss_tpu_torch.parallel` on `make_mesh()` (one card)
   and on a mesh naming the card twice (a test of the sharding logic, not
   of speed across cards), and over all cards where there are several:
   each equal to its unsharded entry point at the shard seeds, or to n
   reps of one whose rep i draws shard i's shots (counts summed, samples
   concatenated; the FT program rebuilt by `EncodedProgram.on`), the
   sparse and hybrid fused decoders also within two-sample 99.9% of
   `memory_experiment(decoder='device-dem')` on the same shots,
   `error_rate_curve(mesh=)` equal to
   `sharded_logical_error_rate`'s points, and each pipeline's launches
   of K1, K2, K6, K8 and K9 (the kernels its path runs must launch);
   then K1 and K2 on the d=7 frame memory's shard-0 detectors, K8 then
   K6 at the injection's shape and on the Monte Carlo's errors, and K9
   on the last block the sharded FT run measured, each against its plain
   version, timed; one JSON line `magic_mesh`;
   main path 16, the port's last modules and its benchmark scripts (no
   kernel of its own; K1, K2, K6 and K8 on its path): (a)
   `gf2_torch.rref_batched` at B=4096, 64x128, the card bit for bit
   against the CPU and against `ops.gf2.rref` on 64 matrices, and the
   `rref_bench` row; (b) `benchmarks/threshold.py` at its defaults
   (uniform model, d = 3..11, six p's, 2^17 shots a point, 'device-dem':
   K1), its p=4e-3 ladder against BASELINE.md's rates by two-sample 99.9%
   tests, its crossings beside BASELINE.md's; (c) `memory_bench.py`'s
   default rows and `--curve --engine frames` at surface9, p=4e-3, 2^15
   shots against BASELINE.md's 9.2e-5; (d) `error_curve.py --code
   steane` equal to `error_rate_curve` in-process, its p=0.01 point
   against the JAX package's recorded count; (e) `roofline.py`'s four
   rows, every share at most 1.0; (f) `bp_bench.py --codes bb72
   --spacetime --stream 24 --gap`; (g) `headline.py`'s JSON line on a
   line of its own; (h) `entry()`'s forward on the card equal to the
   CPU's and `dryrun_multichip(2)` on the card named twice; (i) the demo
   tour (`--target 2e-4`); seconds and launches by part; one JSON line
   `finish`;
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
QLDPC_CODE = "bb144"
QLDPC_ROUNDS = 12
QLDPC_BATCH = 8192
QLDPC_ITERS = 32
QLDPC_P = 2e-3
QLDPC_REF_WORD_FAIL = 0.0046   # BASELINE.md, bb144 R=12: information only
QLDPC_CMP = ("bb72", 6, 2048)  # code, rounds, batch: the card against the CPU
QLDPC_STREAM = ("bb72", 24, 4096)
QLDPC_OSDE_CHECK = 1024        # tail shots of (b)'s order-E comparison
SI_BELIEF_D = (5, 7)              # belief_bench's surface distances, R = d
SI_BELIEF_BATCH = 16384
SI_BELIEF_ITERS = 32
SI_BELIEF_NOISE = (2e-3, 5e-3)    # p_gate2, p_meas
SI_BELIEF_REF = {5: (0.00150, 0.00339)}  # BASELINE.md: belief, independent
SI_D = 5                          # sideinfo_bench's distance
SI_SEED = 1
SI_SOFT = (3e-3, 0.7, 8192, 4)    # p, sigma, batch, reps
SI_SOFT_AGREE = 0.99              # device against host, BASELINE.md
SI_ERASE = (1e-3, 0.01, 1 << 15, 1 << 13)  # p, p_erase, samples, batch
SI_LEAK = (1e-3, 5e-3, 10, 1 << 15, 1 << 13)  # p, p_leak, R, samples, batch
SI_LEAK_CIRCUIT = (10, 8192, 4e-3)  # R, batch, p_leak
SI_MLD = (0.05, 8192, 2048)       # p, syndromes, CPU slice
SI_MLD_TIE = 1e-5                 # relative gap of the best two class scores
SURGERY_D = (5, 7)
SURGERY_BATCH = 32768
SURGERY_SEED = 1
# (entry point, p = q, BASELINE.md's d=5 rates of the same configuration,
# 32,768 shots each: accuracy references for the two-sample tests)
SURGERY_RUNS = (
    ("xx_merge_memory", 4e-3, {"m_fail": 0.00107, "logical_fail": 0.00058}),
    ("xx_merge_split_memory", 4e-3, {"word_fail": 0.0014, "m_fail": 0.00073}),
    ("surgery_cnot_memory", 3e-3, {"word_fail": 0.0027, "zc_fail": 0.00098,
                                   "zt_fail": 0.0019}),
    ("t_gadget_memory", 3e-3, {"gadget_fail": 0.00229}),
    ("parity_chain_memory", 3e-3, {"word_fail": 0.00229}),
)
SURGERY_FUSED = (3e-3, 16384, 4)  # p = q, batch, reps
SURGERY_FUSED_RUNS = ((5, "dense"), (7, "dense"), (5, "hybrid"))
SURGERY_CIRCUIT = (5, 2e-3, 8192)  # d, uniform circuit noise, batch
SURGERY_FD_T = (3, 5)             # the T gadget's sectors
SURGERY_FD_CHAIN = (3, 5, 7)      # the parity chain
# path 11, the compiled logical programs (BASELINE.md's rates beside them)
LOGICAL_SEED = 1
LOGICAL_CNOT = (2e-3, 1 << 15, 4)    # p = q, batch, reps: bench.py's sparse run
LOGICAL_DENSE_D = (3, 5)             # decoder='device-uf', one batch each
LOGICAL_CNOT_REF = {3: 0.0234, 5: 0.00195}  # compiled CNOT word failure
# (name, patches, batch, BASELINE.md's rates at d = 3, 5), run_full, p=q=2e-3
LOGICAL_OPS_P = 2e-3
LOGICAL_OPS = (
    ("cnot01_t1_cnot12", 3, 8192, {"word_fail": (0.0592, 0.00635),
                                   "t1_m1_0_fail": (0.0100, 0.00134)}),
    ("s", 1, 32768, {"word_fail": (0.0111, 0.00079),
                     "s0_m1_0_fail": (0.0028, 0.00015),
                     "s0_out_0_fail": (0.0067, 0.00052)}),
    ("mx", 1, 32768, {"word_fail": (0.0026, 0.00028)}),
    ("feedback", 1, 32768, {"word_fail": (0.0030, 0.00021)}),
)
# (name, d, batch, BASELINE.md's word failure), uniform circuit noise p=1e-3
LOGICAL_CIRCUIT_P = 1e-3
LOGICAL_CIRCUIT = (("cnot", 3, 16384, 0.0122), ("cnot", 5, 8192, 0.00195),
                   ("hzh", 3, 16384, 3.7e-4), ("feedback", 3, 16384, 1.1e-3))
LOGICAL_TWO_LEVEL = (3, 3, 3, 4e-3)  # d, k, rounds_l, p = q
# (decoder, batch, reps, BASELINE.md's word failures l1, l2)
LOGICAL_TWO_LEVEL_RUNS = (("device-uf", 8192, 4, (0.337, 0.035)),
                          ("host", 2048, 1, (0.342, 0.047)))
LOGICAL_PROTOCOL = ((0, 0, 131), (1, 0, 133), (0, 1, 132), (1, 1, 134))
# path 12, the FT transpiler (`rewrite_program` on the tableau engines)
FTQC_ENGINES = ("unpacked", "packed")
FTQC_GOLD_BATCH = 1024
FTQC_EQ_BATCH = 4096                  # the engines bit for bit under the
FTQC_EQ_P = 0.01                      # executor's p_meas, p_reset, p_idle
FTQC_EQ_RUNS = (("x", {}), ("superdense11", {}),
                ("x", {"ec_extractions": 2, "ancillas": "dedicated"}))
FTQC_RATE_BATCH = 16384
FTQC_RATE_P = 0.01                    # p_gate1 = p_gate2 = p_meas
# The JAX package's count for the noisy Steane X program at FTQC_RATE_P on
# its unpacked engine: 287 failures (ro != 1) and 70 prep_fail shots of
# 4096, from `rewrite_program(x, steane(), noise=NoiseModel(p_gate1=0.01,
# p_gate2=0.01, p_meas=0.01)).run(4096, key=jax.random.key(2))` on the CPU
# (JAX 0.9.0), the reference's executor not being run on the card
FTQC_RATE_REF = (287, 70, 4096)
FTQC_BENCH_BATCH = 16384              # benchmarks/ftqc_bench.py's bench
FTQC_BENCH_CODES = ("steane", "surface5")
# path 13, the Pauli-frame FT engine and parallel EC
FRAMES_GOLD_BATCH = 1024
FRAMES_EQ_BATCH = 16384               # frames == unpacked, one seed
FRAMES_EQ_RUNS = (
    ("gate_meas_reset", dict(p_gate1=2e-4, p_gate2=2e-3, p_meas=2e-3,
                             p_reset=2e-3), {}),
    ("idle", dict(p_gate2=2e-3, p_meas=2e-3, p_idle=1e-3), {}),
    ("ec2_dedicated", dict(p_gate2=3e-3, p_meas=5e-3),
     dict(ec_extractions=2, ancillas="dedicated")),
)
FRAMES_PAR_BATCH = 16384
FRAMES_PAR_NOISE = (3e-4, 3e-4)       # p_gate2, p_idle
# The JAX package's failure counts (any ro != 1) for the two-block X
# program at FRAMES_PAR_NOISE, dedicated ancillas, 'frames': 143 with
# ec_schedule='parallel' and 334 with 'serial', of 4096, from
# `rewrite_program(p, steane(), noise=NoiseModel(p_gate2=3e-4,
# p_idle=3e-4), tableau="frames", ancillas="dedicated",
# ec_schedule=s).run(4096, key=jax.random.key(2))` on the CPU (JAX 0.9.0)
FRAMES_PAR_REF = (143, 334, 4096)
FRAMES_SCALING = (1, 2, 4)            # ftqc_bench --ec-scaling widths
# path 14, the rest of the FT transpiler: the unrolled engine, flag EC and
# the FT benches
ROLL_GOLD_BATCH = 1024
ROLL_EQ_BATCH = 16384                 # unrolled == scheduled, one seed
ROLL_EQ_RUNS = (
    ("readout, reset", {"p_meas": 0.01, "p_reset": 0.01}),
    ("gate", {"p_gate1": 3e-3, "p_gate2": 3e-3}),
)
ROLL_EQ_PROGRAMS = ("x", "superdense11")
ROLL_IDLE = {"p_gate2": 3e-4, "p_idle": 3e-4}  # idle_bench's defaults
ROLL_BENCH_BATCH = 16384              # unrolled against scheduled shots/s
FLAG_GOLD_BATCH = 1024
FLAG_CODES = ("steane", "surface3", "color3")
FLAG_RATE_BATCH = 1 << 16
# The JAX package's flag-EC Steane X program under NoiseModel(p_gate1=p,
# p_gate2=p, p_meas=p, p_reset=p), 'frames': 117 failures (ro != 1) of
# 65536 at p = 1e-3 and 957 at 3e-3, from `rewrite_program(x, steane(),
# noise=noise, tableau="frames", ec_mode="flag").run(65536,
# key=jax.random.key(2))` on the CPU (JAX 0.9.0), the reference's executor
# not being run on the card
FLAG_RATE_REF = {1e-3: (117, 1 << 16), 3e-3: (957, 1 << 16)}
FLAG_BENCH_ARGS = ()                  # flag_bench.py at its defaults
FIDELITY_ARGS = ()                    # fidelity.py at its defaults
BREAKEVEN_PROBE_ARGS = ("--shots", "16384", "--tableau", "packed")
BREAKEVEN_ARGS = ("--ps", "1e-3", "3e-4", "--min-shots", "65536",
                  "--chunk", "32768")
MAGIC_P_IN = 1e-2                     # magic_bench's --p-in
MAGIC_P_CLIFFORD = 1e-4               # magic_bench's --p-clifford
MAGIC_CIRCUIT_BATCH = 1 << 20         # magic_bench's --circuit-batch
MAGIC_BENCH_ARGS = ()                 # magic_bench.py at its defaults
MAGIC_NOISY_INJECTION = 2e-3          # every Clifford channel
MAGIC_REPORT_P = 2e-3                 # CNOT(0,1); T(1) priced at p = q
MAGIC_REPORT_BATCH = 8192
MESH_SEED = 15
MESH_MC = (1 << 22, 0.01)             # Steane: batch a shard, p
MESH_LER = (1 << 22, 1 << 20)         # samples, batch a shard (4 rounds)
MESH_FTQC_BATCH = 8192                # packed Steane X program, a shard
MESH_FRAME = (7, 7, 16384, 2e-3, 1e-2)  # d, rounds, batch, p_gate2, p_meas
MESH_BP = (6, 4096, 3e-3, 32)         # bb72: rounds, batch, p = q, iters
MESH_QLDPC = (3, 2048, 1e-3, 32)      # bb72: rounds, batch, p, iters
MESH_SOFT = (5, 5, 16384, 3e-3, 0.7)  # d, rounds, batch, p, sigma
MESH_PROGRAM = (1 << 15, 2e-3)        # compiled CNOT d=3: batch, p = q
MESH_TWO_LEVEL = (3, 3, 3, 4e-3, 8192)  # d, k, rounds_l, p = q, batch
MESH_MLD = (0.05, 1 << 16)            # Steane: p, batch
MESH_PW = (5, 40, 4096, 4e-3)         # d, rounds, batch, p = q
RREF_SHAPE = (4096, 64, 128)          # B, m, n: rref_bench's defaults
RREF_HOST_CHECK = 64                  # matrices held against ops.gf2.rref
# threshold.py at its defaults (d = 3..11, six p's, 2^17 shots a point)
THRESHOLD_ARGS = ()
THRESHOLD_LADDER_P = 4e-3
# BASELINE.md:23: the p=4e-3 ladder at 131,072 shots a point (failure
# rates, valid on any chip) and the pairwise crossings of its wider sweep
THRESHOLD_LADDER_REF = {3: 1.15e-3, 5: 9.3e-4, 7: 2.1e-4, 9: 3.8e-5,
                        11: 3.8e-5}
THRESHOLD_REF_SHOTS = 131072
THRESHOLD_REF_CROSSINGS = {"d5/d7": 0.0123, "d7/d9": 0.0136,
                           "d9/d11": 0.0128}
MEMORY_CURVE = ("surface9", 4e-3, 1 << 15)  # code, p_gate2, batch
MEMORY_CURVE_REF = (3, 1 << 15)       # BASELINE.md:129: 9.2e-5 at 2^15
# the JAX package's error_rate_curve(steane) at p=0.01 (its seed 2 there),
# 2^20 samples in batches of 2^18, on the CPU: word failures, samples
CURVE_REF = (1663, 1 << 20)
BP16_ARGS = ("--codes", "bb72", "--spacetime", "--stream", "24", "--gap")
# step 16's budget: d* = 7 (the default 1e-6 builds the d=13 schedule on
# the host, minutes of the reference's builders)
DEMO_ARGS = ("--target", "2e-4")
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


def k1_report(label, device_uf_cuda, dg, defect, int_ops_per_s):
    """K1's launch plan and the work its data need at one shape, logged;
    returns (plan, work, bound) for the kernels line. The bound counts each
    input and output byte once (defects in, labels, activity and chunk
    words out, the edge words and chunk tables) and the candidate reads of
    `roofline.k1_work` as integer operations."""
    from qcss_tpu_torch.benchmarks.profiling import bound
    from qcss_tpu_torch.benchmarks.roofline import k1_graph_bytes, k1_work

    V = defect.shape[1]
    plan = device_uf_cuda.stencil_full_config(dg)
    log(f"K1 plan at {label}: {plan['shots_per_block']} shots (warps) a "
        f"block, {plan['smem_bytes']} bytes of shared memory a block "
        f"({plan['shot_bytes']} a shot; tables "
        f"{'staged' if plan['tables_in_smem'] else 'in device memory'}), "
        f"{plan['registers']} registers, {plan['blocks_per_sm']} block(s) "
        f"an SM, {plan['form']} edge words")
    rounds, reads, packed = k1_work(dg, defect)
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
    return plan, {"rounds": rounds, "candidate_reads": reads}, bound(
        k1_graph_bytes(dg, defect), reads, int_ops_per_s)


def _counts_of(rates: dict, n: int, keys) -> dict:
    """Rates of ``n`` shots back to counts (every rate is a count / n)."""
    return {k: round(rates[k] * n) for k in keys}


def _summed(*dicts) -> dict:
    return {k: sum(d[k] for d in dicts) for k in dicts[0]}


def _in_interval(k: int, n: int, p: float) -> tuple[bool, float]:
    """|k/n - p| within the 99.9% normal interval of Binomial(n, p)."""
    spread = Z999 * math.sqrt(p * (1 - p) / n)
    return abs(k / n - p) <= spread, spread


def _two_sample(k1: int, k2: int, n: int) -> bool:
    """k1 / n and k2 / n within the two-sample 99.9% normal interval."""
    pooled = (k1 + k2) / (2 * n)
    return abs(k1 - k2) / n <= Z999 * math.sqrt(pooled * (1 - pooled)
                                                * 2 / n)


def path15(dev, int_ops_per_s, smi):
    """Main path 15, magic states and the mesh: (a) the distillation map
    (`ftqc.magic`): the cascade's 35 p^3 term, `benchmarks/magic_bench.py`
    at its defaults (the Monte Carlo at B=2^24 and the circuit tier at
    B=2^20 against the exact map, samples/s), every one of the 2^15
    injection patterns in one quiet `distill_circuit(inject=...)` batch
    against the coset membership, the quiet circuit at B=2^20; (b)
    injection (`experiments.injection`) on Steane at B=2^20, quiet and
    noisy, and `factory_report` at magic_bench's settings fed into
    `logical_resource_report(factory=...)`, K8 and K6 once each a sector
    decode; (c) the twelve sharded pipelines of `parallel` on
    `make_mesh()` and on a mesh naming the card twice (and, with more than
    one card, over all of them), each against its unsharded entry point
    at the shard seeds (or n reps of one whose rep i draws shard i's
    shots), sparse and hybrid also two-sample against 'device-dem', with
    their K1, K2, K6, K8 and K9 launches. Then, the
    counts read, each kernel that ran against its plain version on the
    path's own inputs, timed. Returns the `magic_mesh` JSON object and
    the kernels' path-15 entries."""
    import numpy as np
    import torch

    from qcss_tpu_torch import parallel as par
    from qcss_tpu_torch.benchmarks import magic_bench
    from qcss_tpu_torch.benchmarks import ftqc_programs as fp
    from qcss_tpu_torch.benchmarks import measure_sparse_bench as msb
    from qcss_tpu_torch.benchmarks.profiling import bound, cuda_ms
    from qcss_tpu_torch.codes import families
    from qcss_tpu_torch.decode import device_sparse as dsp
    from qcss_tpu_torch.decode import device_sparse_cuda, device_uf_cuda
    from qcss_tpu_torch.decode import device_uf as duf
    from qcss_tpu_torch.decode import montecarlo
    from qcss_tpu_torch.decode.bp import bp_phenomenological_error_rate
    from qcss_tpu_torch.decode.mld import mld_logical_error_rate
    from qcss_tpu_torch.decode.parallel_window import (
        parallel_window_memory_rate,
    )
    from qcss_tpu_torch.decode.spacetime import detector_history
    from qcss_tpu_torch.decode.sweep import error_rate_curve
    from qcss_tpu_torch.experiments import concatenated, injection, resources
    from qcss_tpu_torch.experiments.logical import LogicalProgram
    from qcss_tpu_torch.experiments.memory import memory_experiment
    from qcss_tpu_torch.experiments.memory_qldpc import (
        qldpc_memory_experiment,
    )
    from qcss_tpu_torch.experiments.patches import schedule_memory_device
    from qcss_tpu_torch.experiments.soft import soft_device_memory_rate
    from qcss_tpu_torch.ftqc import engines, magic, rewrite_program
    from qcss_tpu_torch.ops import cuda_gf2, gf2_torch
    from qcss_tpu_torch.parallel import mesh as pm
    from qcss_tpu_torch.sim import cuda_measure
    from qcss_tpu_torch.sim import tableau as tb
    from qcss_tpu_torch.sim.noise import NoiseModel

    on_card = dev.type == "cuda"
    out = {"card": smi}
    seconds = {}
    t_path = time.perf_counter()

    def kernel_counts():
        return {"K1": device_uf_cuda.launches,
                "K2": device_sparse_cuda.launches,
                "K6": cuda_gf2.launches["syndromes_packed"],
                "K8": cuda_gf2.launches["decode_residual_packed"],
                "K9": cuda_measure.launches}

    def zero_counts():
        device_uf_cuda.launches = device_uf_cuda.chunk_launches = 0
        device_sparse_cuda.launches = 0
        for k in cuda_gf2.launches:
            cuda_gf2.launches[k] = 0
        cuda_measure.launches = 0

    def since(before):
        now = kernel_counts()
        return {k: now[k] - before[k] for k in now}

    zero_counts()

    # -- (a) the distillation map
    t_part = time.perf_counter()
    p_in = MAGIC_P_IN
    cascade = magic.distill_cascade(p_in, 3)
    lead = cascade[0]["p_out"] / (35 * p_in ** 3)
    log(f"path 15 (a) distill_cascade({p_in}, 3): p_out "
        + " / ".join(f"{lv['p_out']:.6e}" for lv in cascade)
        + f", raw cost " + " / ".join(f"{lv['raw_cost']:.2f}"
                                      for lv in cascade)
        + f"; level 1 over 35 p^3 = {lead:.4f}")
    if abs(lead - 1) > 20 * p_in:
        raise RuntimeError(f"distill_cascade's first level is not 35 p^3 "
                           f"(ratio {lead})")
    exact = magic.distill_exact(p_in)
    before = kernel_counts()
    bench = {r["tier"] if r["tier"] != "exact" else f"exact{i}": r
             for i, r in enumerate(magic_bench.main(
                 ["--device", str(dev)] + list(MAGIC_BENCH_ARGS)))}
    out["magic_bench"] = bench
    out["magic_bench_launches"] = since(before)
    mc = bench["mc"]
    ok_a, spread_a = _in_interval(mc["accepted"], mc["samples"],
                                  exact["p_accept"])
    bad = round(mc["p_out"] * mc["accepted"])
    ok_o, spread_o = _in_interval(bad, mc["accepted"], exact["p_out"])
    log(f"path 15 (a) distill_mc B={mc['samples']}: p_accept "
        f"{mc['p_accept']:.6f} (exact {exact['p_accept']:.6f} +- "
        f"{spread_a:.6f}), p_out {mc['p_out']:.4e} ({bad} of "
        f"{mc['accepted']}; exact {exact['p_out']:.4e} +- {spread_o:.2e}); "
        f"{mc['samples_per_sec']:.4e} samples/s ({mc['sec']:.4f} s a call; "
        f"{smi})")
    if not (ok_a and ok_o):
        raise RuntimeError("distill_mc outside the exact map's 99.9% "
                           "intervals")
    cc = bench["circuit"]
    log(f"path 15 (a) distill_circuit at p_clifford={cc['p_clifford']} "
        f"B={cc['samples']}: p_accept {cc['p_accept']:.6f}, p_out "
        f"{cc['p_out']:.4e} ({cc['floor_over_exact']:.3f} x the exact "
        f"map's), {cc['samples_per_sec']:.4e} samples/s ({cc['sec']:.4f} s "
        f"a call; {smi})")
    if not (0 < cc["p_accept"] < 1 and math.isfinite(cc["p_out"])):
        raise RuntimeError(f"distill_circuit's noisy row is not sane: {cc}")
    rm15 = families.reed_muller_15()
    n15 = rm15.n
    idx = np.arange(1 << n15)
    pats = ((idx[:, None] >> np.arange(n15)) & 1).astype(np.uint8)
    ex = magic.distill_circuit(NoiseModel(), 0.0, len(pats), inject=pats,
                               return_samples=True, device=dev)
    h1 = np.asarray(rm15.parity_check_c1, np.int64)
    xbar = np.asarray(rm15.x_operator_matrix()[0], np.int64)
    acc_host = ~((pats.astype(np.int64) @ h1.T) & 1).any(axis=1)
    err_host = ((pats.astype(np.int64) @ xbar) & 1) == 1
    n_bad = int((ex["accept"] != acc_host).sum()
                + (ex["error"] != err_host).sum())
    log(f"path 15 (a) all 2^{n15} injection patterns, quiet: "
        f"{ex['accepted']} accepted, {int(ex['error'][ex['accept']].sum())} "
        f"of them erroneous; {n_bad} bits differ from the host's coset "
        f"membership")
    if n_bad:
        raise RuntimeError("distill_circuit(inject=...) disagrees with the "
                           "coset membership")
    t0 = time.perf_counter()
    quiet = magic.distill_circuit(NoiseModel(), p_in, MAGIC_CIRCUIT_BATCH,
                                  seed=3, device=dev)
    quiet["samples_per_sec"] = MAGIC_CIRCUIT_BATCH / (time.perf_counter()
                                                      - t0)
    ok_a, spread_a = _in_interval(quiet["accepted"], quiet["samples"],
                                  exact["p_accept"])
    bad = round(quiet["p_out"] * quiet["accepted"])
    ok_o, spread_o = _in_interval(bad, quiet["accepted"], exact["p_out"])
    log(f"path 15 (a) distill_circuit quiet B={quiet['samples']}: p_accept "
        f"{quiet['p_accept']:.6f} (+- {spread_a:.6f} of the exact map), "
        f"p_out {quiet['p_out']:.4e} ({bad} shots; +- {spread_o:.2e}); "
        f"{quiet['samples_per_sec']:.4e} samples/s (one call; {smi})")
    if not (ok_a and ok_o):
        raise RuntimeError("the quiet circuit tier is outside the exact "
                           "map's 99.9% intervals")
    out["distill"] = {"cascade": cascade, "exhaustive_accepted":
                      ex["accepted"], "quiet": quiet}
    seconds["a_magic"] = time.perf_counter() - t_part

    # -- (b) injection: K8 and K6 once each a sector decode
    t_part = time.perf_counter()
    steane = families.steane()
    inj = {}

    def injected(label, noise, p_t, **kw):
        before = kernel_counts()
        t0 = time.perf_counter()
        r = injection.magic_injection_experiment(
            steane, noise, p_t, MAGIC_CIRCUIT_BATCH, device=dev, **kw)
        r["samples_per_sec"] = MAGIC_CIRCUIT_BATCH / (time.perf_counter()
                                                      - t0)
        r["launches"] = since(before)
        inj[label] = {k: v for k, v in r.items()
                      if k not in ("accept", "log_x", "log_z")}
        log(f"path 15 (b) injection {label} B={r['samples']}: p_accept "
            f"{r['p_accept']:.6f}, p_x {r['p_x']:.3e}, p_y {r['p_y']:.3e}, "
            f"p_z {r['p_z']:.4e}, eps {r['eps']:.4e}; "
            f"{r['samples_per_sec']:.4e} samples/s (one call; {smi}); "
            f"launches {r['launches']}")
        if on_card and (r["launches"]["K8"] != 2
                        or r["launches"]["K6"] != 2):
            raise RuntimeError(f"injection {label}: K8 and K6 must launch "
                               f"once a sector decode, got {r['launches']}")
        return r

    p_t = MAGIC_P_CLIFFORD * 10
    r = injected("quiet", NoiseModel(), p_t, seed=2)
    ok, spread = _in_interval(round(r["p_z"] * r["samples"]), r["samples"],
                              p_t)
    if r["p_accept"] != 1.0 or r["p_x"] or r["p_y"] or not ok \
            or r["eps"] != r["p_z"]:
        raise RuntimeError(f"quiet injection: p_accept 1, no X or Y and "
                           f"eps = p_z within {spread:.2e} of p_t expected")
    r = injected("t_fault", NoiseModel(), 1.0, seed=3)
    if (r["p_accept"], r["p_z"], r["p_x"], r["p_y"]) != (1.0, 1.0, 0.0, 0.0):
        raise RuntimeError("a certain T fault must be Z̄ on every shot")
    p_c = MAGIC_NOISY_INJECTION
    noisy = NoiseModel(p_gate1=p_c, p_gate2=p_c, p_meas=p_c, p_reset=p_c)
    r = injected("noisy", noisy, 0.0, seed=4, return_samples=True)
    lx, lz = r["log_x"], r["log_z"]
    raw_eps = ((lx & ~lz).mean() + (lx & lz).mean()) / 2 + (lz & ~lx).mean()
    inj["noisy"]["raw_eps"] = float(raw_eps)
    log(f"path 15 (b) injection noisy (p={p_c} everywhere): postselected "
        f"eps {r['eps']:.4e} against {raw_eps:.4e} unconditioned")
    if not (r["p_accept"] < 1.0 and r["eps"] < raw_eps):
        raise RuntimeError("postselection must clean the Clifford noise")
    fac_noise = NoiseModel(p_gate1=MAGIC_P_CLIFFORD, p_gate2=MAGIC_P_CLIFFORD,
                           p_meas=MAGIC_P_CLIFFORD, p_reset=MAGIC_P_CLIFFORD)
    before = kernel_counts()
    fac = injection.factory_report(steane, fac_noise, p_t, levels=3,
                                   batch=MAGIC_CIRCUIT_BATCH, seed=7,
                                   device=dev)
    fac_launches = since(before)
    if fac["injection"]["eps"] != bench["factory"]["inject_eps"] or \
            fac["p_out"] != bench["factory"]["p_out"]:
        raise RuntimeError("factory_report differs from magic_bench's "
                           "factory row at the same seed")
    t_prog = lambda d: LogicalProgram(d, 2).cnot(0, 1).t(1)  # noqa: E731
    fails = {d: t_prog(d).run(MAGIC_REPORT_P, batch=MAGIC_REPORT_BATCH,
                              seed=1, decoder="host",
                              device=dev)["word_fail"] for d in (3, 5)}
    rep = resources.logical_resource_report(
        t_prog, MAGIC_REPORT_P, target=1.5 * fails[5], fails=fails,
        factory=fac)
    out["injection"] = inj
    out["factory"] = {"eps": fac["injection"]["eps"],
                      "p_accept": fac["injection"]["p_accept"],
                      "p_out": fac["p_out"],
                      "injections_per_state": fac["injections_per_state"],
                      "launches": fac_launches}
    out["resource_report"] = rep
    log(f"path 15 (b) factory_report (Steane, p={MAGIC_P_CLIFFORD}, p_t="
        f"{p_t}, 3 levels, B={MAGIC_CIRCUIT_BATCH}): eps "
        f"{fac['injection']['eps']:.4e}, p_out {fac['p_out']:.3e}, "
        f"{fac['injections_per_state']:.2f} injections a state; launches "
        f"{fac_launches}; logical_resource_report of CNOT(0,1); T(1) "
        f"at p=q={MAGIC_REPORT_P} (host decode, B={MAGIC_REPORT_BATCH}, "
        f"word failures {fails}): d* {rep['d_star']}, magic "
        f"{rep['magic']}")
    if rep["magic"]["t_count"] != 1:
        raise RuntimeError("the priced program has one T")
    seconds["b_injection"] = time.perf_counter() - t_part

    # -- (c) the mesh: every pipeline on one card, on the card named twice
    #    and, with more than one card, over all of them; each held against
    #    its unsharded port body at the shard seeds
    t_part = time.perf_counter()
    S = MESH_SEED
    # make_mesh() takes every card; "one card" is make_mesh(1)
    n_cards = torch.cuda.device_count() if on_card else 0
    meshes = {"one card": (par.make_mesh(1) if on_card
                           else par.make_mesh(devices=[dev]), 1),
              "card twice (sharding logic, not speed)": (
                  par.make_mesh(devices=[dev, dev]), 2)}
    if n_cards > 1:
        meshes["all cards"] = (par.make_mesh(), n_cards)
    shard_seeds = [pm.shard_seed(S, i) for i in range(
        max(n for _, n in meshes.values()))]
    sf = families.rotated_surface
    code7 = sf(MESH_FRAME[0])
    frame_noise = NoiseModel(p_gate2=MESH_FRAME[3], p_meas=MESH_FRAME[4])
    bb72 = families.bb72()
    qldpc_noise = NoiseModel(p_gate2=MESH_QLDPC[2], p_meas=MESH_QLDPC[2])
    program = LogicalProgram(3, 2).cnot(0, 1).build()
    mag_noise = NoiseModel(p_gate1=MAGIC_P_CLIFFORD,
                           p_gate2=MAGIC_P_CLIFFORD, p_meas=MAGIC_P_CLIFFORD,
                           p_reset=MAGIC_P_CLIFFORD)
    enc = rewrite_program(fp.x_program(), steane, tableau="packed",
                          noise=NoiseModel(p_meas=1e-2, p_reset=1e-2),
                          device=dev)
    sfm = {}

    def frame_memory(mesh):
        key = tuple(str(d) for d in mesh.devices)
        if key not in sfm:
            sfm[key] = par.ShardedFrameMemory(code7, frame_noise, mesh)
        return sfm[key]

    d7, r7, b7 = MESH_FRAME[:3]
    pw_d, pw_r, pw_b, pw_p = MESH_PW
    pw_kw = dict(rounds=pw_r, p=pw_p, q=pw_p, core=pw_d,
                 buf=int(1.5 * pw_d))
    f_keys = ("x_fail", "z_fail", "word_fail")
    # name: (batch a shard, sharded(mesh, batch) -> counts,
    #        unsharded(seed, batch) -> counts, kernels expected to launch);
    # an unsharded entry of None is in `by_reps`: an entry point whose rep
    # i at seed S draws shard i's shots, run for n reps
    pipelines = {
        "sharded_mc_step": (
            MESH_MC[0],
            lambda m, b: {k: int(v) for k, v in par.sharded_mc_step(
                steane, m, S, b, MESH_MC[1]).items()},
            lambda s, b: _counts_of(montecarlo.logical_error_rate(
                steane, MESH_MC[1], samples=b, batch=b, seed=s,
                device=dev), b, f_keys),
            ("K6", "K8")),
        "sharded_logical_error_rate": (
            MESH_LER[1],
            lambda m, b: _counts_of(par.sharded_logical_error_rate(
                steane, MESH_MC[1], mesh=m, samples=MESH_LER[0] // MESH_LER[1]
                * b, batch=b, seed=S), MESH_LER[0] // MESH_LER[1] * b,
                f_keys),
            None, ("K6", "K8")),
        "sharded_ftqc_run": (
            MESH_FTQC_BATCH,
            lambda m, b: {k: v.cpu().numpy() for k, v in
                          par.sharded_ftqc_run(enc, m, b, S).items()},
            lambda s, b: enc.on(dev).run(b, s), ("K9",)),
        "ShardedFrameMemory.sample": (
            b7,
            lambda m, b: dict(zip(("syns", "word"), (
                t.cpu().numpy() for t in frame_memory(m).sample(S, b, r7)))),
            lambda s, b: dict(zip(("syns", "word"), (
                t.cpu().numpy() for t in frame_memory(
                    meshes["one card"][0])._sampler(dev, s, b, r7)(
                        frame_memory(meshes["one card"][0])._extract,
                        code7.raw_parity_check_c2.shape[0])))), ()),
        "ShardedFrameMemory.error_rate": (
            b7,
            lambda m, b: _counts_of(frame_memory(m).error_rate(
                rounds=r7, batch=b, seed=S), b,
                ("logical_fail", "residual_syndrome")),
            lambda s, b: _counts_of(memory_experiment(
                code7, rounds=r7, noise=frame_noise, batch=b, seed=s,
                decoder="uf", engine="frames", device=dev), b,
                ("logical_fail", "residual_syndrome")), ()),
        **{f"ShardedFrameMemory.fused_error_rate({dec})": (
            b7,
            lambda m, b, dec=dec: _counts_of(frame_memory(m).fused_error_rate(
                rounds=r7, batch=b, seed=S, decoder=dec, d_max=D_MAX), b,
                ("logical_fail",)),
            (lambda s, b: _counts_of(memory_experiment(
                code7, rounds=r7, noise=frame_noise, batch=b, seed=s,
                decoder="device-dem", engine="frames", device=dev), b,
                ("logical_fail",))) if dec == "dense" else
            (lambda s, b, dec=dec: {"logical_fail": int(frame_memory(
                meshes["one card"][0]).fused_shard(
                    dev, s, b, r7, "dem", dec, D_MAX)[0])}),
            {"dense": ("K1",), "sparse": ("K2",), "hybrid": ("K2",)}[dec])
            for dec in ("dense", "sparse", "hybrid")},
        "sharded_bp_memory": (
            MESH_BP[1],
            lambda m, b: _counts_of(par.sharded_bp_memory(
                bb72, m, rounds=MESH_BP[0], p=MESH_BP[2], q=MESH_BP[2],
                batch=b, seed=S, iters=MESH_BP[3]), b,
                ("x_fail", "bp_unconverged")),
            lambda s, b: (lambda r: {
                "x_fail": round(r["x_fail"] * b),
                "bp_unconverged": round((1 - r["bp_converged"]) * b)})(
                bp_phenomenological_error_rate(
                    bb72, MESH_BP[0], MESH_BP[2], MESH_BP[2], batch=b,
                    seed=s, iters=MESH_BP[3], osd=False, device=dev)), ()),
        "sharded_soft_memory": (
            MESH_SOFT[2],
            lambda m, b: _counts_of(par.sharded_soft_memory(
                sf(MESH_SOFT[0]), m, rounds=MESH_SOFT[1], p=MESH_SOFT[3],
                sigma=MESH_SOFT[4], batch=b, seed=S), b, ("logical_fail",)),
            None, ()),
        "sharded_qldpc_circuit_memory": (
            MESH_QLDPC[1],
            lambda m, b: _counts_of(par.sharded_qldpc_circuit_memory(
                bb72, m, rounds=MESH_QLDPC[0], noise=qldpc_noise, batch=b,
                seed=S, iters=MESH_QLDPC[3]), b,
                ("x_fail", "bp_unconverged")),
            lambda s, b: (lambda r: {
                "x_fail": round(r["x_fail"] * b),
                "bp_unconverged": round((1 - r["bp_converged_z"]) * b)})(
                qldpc_memory_experiment(
                    bb72, rounds=MESH_QLDPC[0], noise=qldpc_noise, batch=b,
                    seed=s, iters=MESH_QLDPC[3], osd=False, sectors="z",
                    device=dev)), ()),
        "sharded_magic_factory": (
            MAGIC_CIRCUIT_BATCH,
            lambda m, b: (lambda r: {"accepted": r["accepted"],
                                     "bad": round(r["p_out"]
                                                  * r["accepted"])})(
                par.sharded_magic_factory(m, mag_noise, p_in, b, seed=S)),
            lambda s, b: (lambda r: {"accepted": r["accepted"],
                                     "bad": round(r["p_out"]
                                                  * r["accepted"])})(
                magic.distill_circuit(mag_noise, p_in, b, seed=s,
                                      device=dev)), ()),
        "sharded_logical_program": (
            MESH_PROGRAM[0],
            lambda m, b: _counts_of(par.sharded_logical_program(
                program, m, p=MESH_PROGRAM[1], batch=b, seed=S), b,
                ("word_fail", "z0_fail", "z1_fail")),
            None, ()),
        "sharded_two_level_memory": (
            MESH_TWO_LEVEL[4],
            lambda m, b: _counts_of(par.sharded_two_level_memory(
                *MESH_TWO_LEVEL[:3], m, p=MESH_TWO_LEVEL[3], batch=b,
                seed=S), b, ("word_fail_l1", "word_fail_l2")),
            None, ("K1",)),
        "sharded_mld_memory": (
            MESH_MLD[1],
            lambda m, b: _counts_of(par.sharded_mld_memory(
                steane, m, p=MESH_MLD[0], batch=b, seed=S), b,
                ("word_fail",)),
            lambda s, b: {"word_fail": round(mld_logical_error_rate(
                steane, MESH_MLD[0], batch=b, seed=s,
                device=dev)["word_fail_ml"] * b)}, ()),
        "sharded_parallel_window_memory": (
            pw_b,
            lambda m, b: _counts_of(par.sharded_parallel_window_memory(
                sf(pw_d), m, batch=b, seed=S, **pw_kw), b,
                ("logical_fail",)),
            lambda s, b: _counts_of(parallel_window_memory_rate(
                sf(pw_d).raw_parity_check_c2, sf(pw_d).z_operator_matrix(),
                pw_p, pw_p, rounds=pw_r, batch=b, core=pw_d,
                buf=int(1.5 * pw_d), seed=s, device=dev), b,
                ("logical_fail",)), ("K1",)),
    }

    by_reps = {
        "sharded_soft_memory": lambda n, b: _counts_of(
            soft_device_memory_rate(
                sf(MESH_SOFT[0]), MESH_SOFT[3], MESH_SOFT[4],
                rounds=MESH_SOFT[1], batch=b, reps=n, seed=S, device=dev),
            n * b, ("logical_fail",)),
        "sharded_logical_program": lambda n, b: (lambda r: {
            "word_fail": round(r["word_fail"] * n * b),
            "z0_fail": round(r["obs0_fail"] * n * b),
            "z1_fail": round(r["obs1_fail"] * n * b)})(
            schedule_memory_device(program, MESH_PROGRAM[1], batch=b,
                                   reps=n, seed=S, device=dev)),
        "sharded_two_level_memory": lambda n, b: _counts_of(
            concatenated._device_two_level(
                *MESH_TWO_LEVEL[:4], None, batch=b, seed=S, reps=n,
                device=dev), n * b, ("word_fail_l1", "word_fail_l2")),
    }

    def equal(a: dict, b: dict) -> bool:
        return set(a) == set(b) and all(
            np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)

    rows, launches = {}, {}
    # K9: catch a state the sharded FT run measures
    measure = engines.PackedEngine.measure_block
    seen = []

    def spy(self, tab, b, generator=None, *, rand_bits=None):
        seen[:] = [(tab, self.block_qubits(b))]
        return measure(self, tab, b, generator, rand_bits=rand_bits)

    body_cache = {}
    for name, (local, sharded, unsharded, expect) in pipelines.items():
        row = {"local_batch": local}
        launches[name] = {}
        for label, (mesh, n) in meshes.items():
            before = kernel_counts()
            t0 = time.perf_counter()
            engines.PackedEngine.measure_block = spy
            try:
                got = sharded(mesh, n * local)
            finally:
                engines.PackedEngine.measure_block = measure
            wall = time.perf_counter() - t0
            launches[name][label] = since(before)
            # the unsharded port bodies at shard_seed(S, i), i < n
            if name == "sharded_logical_error_rate":
                n_rounds = MESH_LER[0] // MESH_LER[1]
                parts = [_counts_of(montecarlo.logical_error_rate(
                    steane, MESH_MC[1], samples=local, batch=local,
                    seed=pm.shard_seed(pm.shard_seed(S, r), i), device=dev),
                    local, f_keys) for r in range(n_rounds)
                    for i in range(n)]
                want = _summed(*parts)
            elif name in by_reps:
                want = by_reps[name](n, local)
            else:
                parts = []
                for i in range(n):
                    ck = (name, shard_seeds[i])
                    if ck not in body_cache:
                        body_cache[ck] = unsharded(shard_seeds[i], local)
                    parts.append(body_cache[ck])
                if name == "sharded_ftqc_run":
                    want = {k: np.concatenate([p[k] for p in parts])
                            for k in parts[0]}
                elif name == "ShardedFrameMemory.sample":
                    want = {"syns": np.concatenate([p["syns"] for p in parts],
                                                   axis=1),
                            "word": np.concatenate([p["word"] for p in parts])}
                else:
                    want = _summed(*parts)
            same = equal(got, want)
            shown = ({k: list(v.shape) for k, v in got.items()}
                     if name in ("sharded_ftqc_run",
                                 "ShardedFrameMemory.sample") else got)
            row[label] = {"shards": n, "batch": n * local, "wall_s": wall,
                          "equal_to_unsharded": same, "result": shown,
                          "launches": launches[name][label]}
            log(f"path 15 (c) {name} on {label} ({n} shard(s) x {local}): "
                f"{shown}; == the unsharded bodies at the shard seeds: "
                f"{same}; {wall:.3f} s; launches {launches[name][label]}")
            if not same:
                raise RuntimeError(f"{name} on {label} differs from its "
                                   f"unsharded port body: {got} vs {want}")
            if on_card:
                missing = [k for k in expect
                           if launches[name][label][k] <= 0]
                if missing:
                    raise RuntimeError(f"{name} on {label}: {missing} never "
                                       f"launched")
        rows[name] = row
    # the sparse kernel's decoders have no unsharded entry point: beside
    # their shards' bodies, hold them against the dense decoder's entry
    # point (`memory_experiment(decoder='device-dem')`, the dense row's
    # unsharded runs) on the same shots, two-sample 99.9%
    dense = rows["ShardedFrameMemory.fused_error_rate(dense)"]
    for dec in ("sparse", "hybrid"):
        row = rows[f"ShardedFrameMemory.fused_error_rate({dec})"]
        for label in meshes:
            k1 = row[label]["result"]["logical_fail"]
            k2 = dense[label]["result"]["logical_fail"]
            n_shots = row[label]["batch"]
            ok = _two_sample(k1, k2, n_shots)
            row[label]["two_sample_vs_device_dem"] = {
                "failures": k1, "device_dem_failures": k2, "within": ok}
            log(f"path 15 (c) fused_error_rate({dec}) on {label}: {k1} "
                f"failures of {n_shots} against memory_experiment("
                f"decoder='device-dem')'s {k2} on the same shots: within "
                f"two-sample 99.9%: {ok}")
            if not ok:
                raise RuntimeError(f"fused_error_rate({dec}) on {label} "
                                   f"disagrees with device-dem: {k1} vs {k2}")
    curve = error_rate_curve(steane, [MESH_MC[1], 2 * MESH_MC[1]],
                             samples_per_point=MESH_LER[0],
                             batch=MESH_LER[1], seed=S,
                             mesh=meshes["one card"][0])
    want = [{"p": p, **par.sharded_logical_error_rate(
        steane, p, mesh=meshes["one card"][0], samples=MESH_LER[0],
        batch=MESH_LER[1], seed=S + i)}
        for i, p in enumerate([MESH_MC[1], 2 * MESH_MC[1]])]
    log(f"path 15 (c) error_rate_curve(mesh=one card): "
        f"{[(pt['p'], pt['word_fail']) for pt in curve]}; == "
        f"sharded_logical_error_rate's points: {curve == want}")
    if curve != want:
        raise RuntimeError("error_rate_curve(mesh=) differs from "
                           "sharded_logical_error_rate")
    out["mesh"] = rows
    out["error_rate_curve"] = curve
    seconds["c_mesh"] = time.perf_counter() - t_part
    out["launches"] = {"a_magic_bench": out.pop("magic_bench_launches"),
                       "b_injection": {k: v["launches"]
                                       for k, v in inj.items()},
                       "b_factory": fac_launches, "c_mesh": launches}
    total = kernel_counts()
    out["launches_total"] = total
    out["seconds"] = {**seconds, "path": time.perf_counter() - t_path}
    log(f"path 15 launches over the path: {total}; seconds {out['seconds']} "
        f"({smi})")
    if not on_card:
        return out, {}
    if min(total[k] for k in ("K1", "K2", "K6", "K8", "K9")) <= 0:
        raise RuntimeError(f"a kernel of path 15 never launched: {total}")

    # -- the kernels that ran, against their plain versions on the path's
    #    own inputs (these launches are not the path's)
    kernels = {}
    mesh1 = meshes["one card"][0]
    sfm1 = frame_memory(mesh1)
    syns, word = sfm1._sampler(dev, shard_seeds[0], b7, r7)(
        sfm1._extract, code7.raw_parity_check_c2.shape[0])
    raw_t = torch.as_tensor(np.asarray(code7.raw_parity_check_c2, np.uint8),
                            device=dev)
    dets = detector_history(syns, gf2_torch.syndromes_dense(word, raw_t))
    graph = sfm1._graph(r7, True)
    dg = duf.build_device_graph(graph).to(dev)
    defect = duf.stencil_defect(dg, dets)
    k1_err = k1_equal(duf, device_uf_cuda, dg, defect,
                      "on path 15's d=7 DEM rows")[0]
    Bk, Vk = defect.shape
    label = (f"B={Bk} V={Vk} O={len(dg.stencil.deltas)} NC="
             f"{len(dg.stencil.chunks)} (ShardedFrameMemory d={d7} R={r7}, "
             f"shard 0)")
    plan, need, bnd = k1_report(label, device_uf_cuda, dg, defect,
                                int_ops_per_s)
    kernels["K1"] = {
        "shape": label, "launches": total["K1"],
        "by_pipeline": {k: sum(v[m]["K1"] for m in v)
                        for k, v in launches.items()},
        "max_abs_err": k1_err,
        "ms": cuda_ms(lambda: device_uf_cuda.stencil_full(dg, defect), 20),
        "plain_ms": cuda_ms(lambda: duf._stencil_plain(dg, defect), 2),
        "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
        "plan": plan, "work": need}
    tables = dsp._tables_to(dsp.build_sparse_tables(graph), dev)
    k2 = msb.k2_row(tables, dets, 20, int_ops_per_s, d_max=D_MAX)
    kernels["K2"] = {
        "shape": f"B={Bk} V={dets.shape[1]} d_max={D_MAX} "
                 f"(ShardedFrameMemory d={d7} R={r7}, shard 0)",
        "launches": total["K2"],
        "by_pipeline": {k: sum(v[m]["K2"] for m in v)
                        for k, v in launches.items()},
        "max_abs_err": 0,
        **{k: k2[k] for k in ("ms", "host_ms", "hot_ms", "cold_ms",
                              "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "defects_per_shot", "plan")}}
    # K8 then K6: the injection's final decode at its shape (Steane,
    # B=2^20, one sector), on frames with errors at the noisy run's scale
    # and on the Monte Carlo's errors (B=2^22)
    x_sec, z_sec = injection.final_sectors(steane, dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    for key, (bits, sec, where) in {
            "injection": ((torch.rand((MAGIC_CIRCUIT_BATCH, steane.n),
                                      generator=gen, device=dev) < 0.05
                           ).to(torch.uint8), z_sec,
                          f"Steane B={MAGIC_CIRCUIT_BATCH}, Z frame"),
            "mc": (montecarlo.sample_depolarizing(
                torch.Generator(device=dev).manual_seed(shard_seeds[0]),
                MESH_MC[0], steane.n, MESH_MC[1])[0],
                montecarlo.packed_sectors(steane, dev)[0],
                f"Steane B={MESH_MC[0]}, X errors of sharded_mc_step's "
                f"shard 0")}.items():
        e = gf2_torch.words32(gf2_torch.pack_bits(bits))
        Be, We = e.shape
        R = sec.checks.shape[0]
        k8 = lambda: cuda_gf2.decode_residual_packed_cuda(e, sec.checks,
                                                         sec.lut)
        k8p = lambda: cuda_gf2.decode_residual_packed_plain(e, sec.checks,
                                                           sec.lut)
        resid = k8()
        err8 = max_abs_words(resid, k8p())
        k6 = lambda: cuda_gf2.syndromes_packed_cuda(resid, sec.logicals)
        k6p = lambda: cuda_gf2.syndromes_packed_plain(resid, sec.logicals)
        err6 = max_abs(k6(), k6p())
        if err8 or err6:
            raise RuntimeError(f"K8/K6 disagree with their plain versions "
                               f"on path 15's {where} (max abs err {err8}, "
                               f"{err6})")
        K = sec.logicals.shape[0]
        b8 = bound(4 * (2 * Be * We + R * We + sec.lut.numel()),
                   Be * (R * (We + 3) + We), int_ops_per_s)
        b6 = bound(4 * Be * We + 4 * K * We + Be * K, Be * K * (We + 2),
                   int_ops_per_s)
        for kname, fn, fp_, b_, err, launched in (
                ("K8", k8, k8p, b8, err8, total["K8"]),
                ("K6", k6, k6p, b6, err6, total["K6"])):
            entry = kernels.setdefault(kname, {
                "launches": launched,
                "by_pipeline": {k: sum(v[m][kname] for m in v)
                                for k, v in launches.items()},
                "by_part": {"a_magic_bench": out["launches"]
                            ["a_magic_bench"][kname],
                            "b_injection": sum(v[kname] for v in
                                               out["launches"]["b_injection"]
                                               .values()),
                            "b_factory": fac_launches[kname]},
                "max_abs_err": 0})
            entry[key] = {"shape": f"B={Be} W={We} R={R if kname == 'K8' else K} "
                                   f"({where})",
                          "max_abs_err": err, "ms": cuda_ms(fn, 20),
                          "plain_ms": cuda_ms(fp_, 3), "bound_ms": b_[0],
                          "bound_by": b_[1], "library_ms": None}
            log(f"{kname} at path 15's {where}: == plain; "
                f"{entry[key]['ms']:.4f} ms, plain "
                f"{entry[key]['plain_ms']:.4f} ms, bound {b_[0]:.4f} ms "
                f"({b_[1]})")
    # K9 on the last block measurement the sharded FT run made
    tab, qs = seen[0]
    bits = tb.collapse_bits(torch.Generator(device=dev).manual_seed(15),
                            tab.batch, len(qs))
    row = msb.k9_row({"t": tab, "qubits": qs, "bits": bits,
                      "branch": "path 15, sharded_ftqc_run"}, 20,
                     int_ops_per_s)
    kernels["K9"] = {
        "shape": f"B={row['B']} n={row['n']} W={row['W']} M={row['M']} "
                 f"(path 15, sharded_ftqc_run's last block measurement)",
        "launches": total["K9"],
        "by_pipeline": {k: sum(v[m]["K9"] for m in v)
                        for k, v in launches.items()},
        "max_abs_err": 0,
        **{k: row[k] for k in ("ms", "host_ms", "hot_ms", "cold_ms",
                               "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "plan")}}
    log(f"K1 {kernels['K1']['ms']:.4f} ms (plain "
        f"{kernels['K1']['plain_ms']:.3f}), K2 {k2['ms']:.4f} ms, K9 "
        f"{row['ms']:.4f} ms at path 15's shapes: each == its plain version "
        f"({smi})")
    return out, kernels


def path16(dev, int_ops_per_s, smi):
    """Main path 16, the port's last modules and its benchmark scripts: (a)
    `gf2_torch.rref_batched` at B=4096, 64x128 on the card, bit for bit
    against the CPU and against `ops.gf2.rref` on 64 matrices, and the
    `rref_bench` row; (b) `benchmarks/threshold.py` (uniform model,
    'device-dem', K1 through the fused device union-find), its p=4e-3
    ladder against BASELINE.md's rates by two-sample 99.9% tests and its
    crossings beside BASELINE.md's; (c) `memory_bench.py`'s default rows
    and one `--curve --engine frames` point (surface9, p=4e-3, 2^15 shots)
    against BASELINE.md's rate; (d) `error_curve.py --code steane` equal to
    `error_rate_curve` in-process at its seed, its p=0.01 point against the
    JAX package's recorded count; (e) `roofline.py`'s four rows, every
    share at most 1.0; (f) `bp_bench.py --codes bb72 --spacetime --stream
    24 --gap`; (g) `headline.py`'s JSON line (K6 and K8 in the Steane
    headline, K2 and K1 in the d=11 extras); (h) `entry()`'s forward on the
    card equal to the CPU's, `dryrun_multichip(2)` on the card named twice;
    (i) the demo tour on the card. Returns the `finish` JSON object and
    the kernels' path-16 entries (launches by part)."""
    import numpy as np
    import torch

    from qcss_tpu_torch.benchmarks import (
        bp_bench,
        error_curve,
        headline,
        memory_bench,
        roofline,
        rref_bench,
        threshold,
    )
    from qcss_tpu_torch.decode import device_sparse_cuda, device_uf_cuda
    from qcss_tpu_torch.decode.sweep import error_rate_curve
    from qcss_tpu_torch.entry import dryrun_multichip, entry
    from qcss_tpu_torch.examples import demo
    from qcss_tpu_torch.ops import cuda_gf2, gf2, gf2_torch
    from qcss_tpu_torch.sim import cuda_measure

    on_card = dev.type == "cuda"   # off the card: a rehearsal, no launches
    out = {"card": smi}
    seconds, launches = {}, {}
    t_path = time.perf_counter()

    def counts():
        return {"K1": device_uf_cuda.launches,
                "K2": device_sparse_cuda.launches,
                "K3": device_uf_cuda.staged_launches["prop"],
                "K4": device_uf_cuda.staged_launches["act"],
                "K5": device_uf_cuda.staged_launches["round"],
                "K6": cuda_gf2.launches["syndromes_packed"],
                "K7": cuda_gf2.launches["syndromes_packed_t"],
                "K8": cuda_gf2.launches["decode_residual_packed"],
                "K9": cuda_measure.launches}

    def zero_counts():
        device_uf_cuda.launches = device_uf_cuda.chunk_launches = 0
        for k in device_uf_cuda.staged_launches:
            device_uf_cuda.staged_launches[k] = 0
        device_sparse_cuda.launches = 0
        for k in cuda_gf2.launches:
            cuda_gf2.launches[k] = 0
        cuda_measure.launches = 0

    def part(name, fn):
        """Run one part with every launch count set to 0 just before it and
        read just after; its seconds."""
        zero_counts()
        t0 = time.perf_counter()
        result = fn()
        seconds[name] = time.perf_counter() - t0
        launches[name] = counts()
        log(f"path 16 ({name}): {seconds[name]:.1f} s, launches "
            f"{launches[name]}")
        return result

    # -- (a) batched RREF: the card against the CPU and the host rref
    def rref():
        B, m, n = RREF_SHAPE
        mats = np.random.default_rng(0).integers(0, 2, size=(B, m, n),
                                                 dtype=np.uint8)
        card = gf2_torch.rref_batched(torch.as_tensor(mats, device=dev))
        cpu = gf2_torch.rref_batched(torch.as_tensor(mats))
        if not torch.equal(card.cpu(), cpu):
            raise RuntimeError("rref_batched: the card differs from the CPU")
        host = np.stack([gf2.rref(x) for x in mats[:RREF_HOST_CHECK]])
        if not (cpu[:RREF_HOST_CHECK].numpy() == host).all():
            raise RuntimeError("rref_batched differs from ops.gf2.rref")
        row = rref_bench.run(B, (m, n), dev)
        log(f"path 16 (a): rref_batched B={B} {m}x{n}: card == CPU, == "
            f"ops.gf2.rref on {RREF_HOST_CHECK}; {json.dumps(row)}")
        return row

    out["rref"] = part("a_rref", rref)

    # -- (b) the threshold sweep
    def sweep():
        rows = threshold.main(list(THRESHOLD_ARGS) + ["--device", str(dev)])
        points, summary = rows[:-1], rows[-1]
        ladder = {}
        for r in points:
            if r["p"] != THRESHOLD_LADDER_P:
                continue
            k_ref = round(THRESHOLD_LADDER_REF[r["d"]] * THRESHOLD_REF_SHOTS)
            ok, spread = two_sample_ok(r["fails"], r["shots"], k_ref,
                                       THRESHOLD_REF_SHOTS)
            ladder[r["d"]] = {"fails": r["fails"], "shots": r["shots"],
                              "ref_fails": k_ref, "allowed": spread,
                              "ok": ok}
            log(f"path 16 (b): d={r['d']} p={r['p']}: {r['fails']} of "
                f"{r['shots']} ({r['logical_fail']:.3e}) against "
                f"BASELINE.md's {THRESHOLD_LADDER_REF[r['d']]:.2e} "
                f"({k_ref} of {THRESHOLD_REF_SHOTS}): "
                f"{'within' if ok else 'OUTSIDE'} two-sample 99.9%")
            if not ok:
                raise RuntimeError(f"threshold ladder at d={r['d']} outside "
                                   f"BASELINE.md's rate")
        if sorted(ladder) != sorted(THRESHOLD_LADDER_REF):
            raise RuntimeError(f"threshold ladder incomplete: {ladder}")
        log(f"path 16 (b): pairwise crossings {summary['pairwise_crossings']}"
            f" (p_th {summary['p_th']}); BASELINE.md's "
            f"{THRESHOLD_REF_CROSSINGS} (its sweep ran to higher p)")
        return {"args": list(THRESHOLD_ARGS), "points": points,
                "summary": summary, "ladder": ladder,
                "baseline_crossings": THRESHOLD_REF_CROSSINGS}

    out["threshold"] = part("b_threshold", sweep)
    if on_card and launches["b_threshold"]["K1"] <= 0:
        raise RuntimeError("the threshold sweep did not launch K1")

    # -- (c) the memory bench: default rows and one curve point
    def memory():
        rows = memory_bench.main(["--device", str(dev)])
        name, p, batch = MEMORY_CURVE
        curve = memory_bench.main([
            "--curve", "--codes", name, "--ps", str(p), "--batch",
            str(batch), "--engine", "frames", "--device", str(dev)])
        for r in rows + curve:
            if not 0.0 <= r["logical_fail"] <= 1.0:
                raise RuntimeError(f"memory_bench row out of range: {r}")
        k = round(curve[0]["logical_fail"] * batch)
        ok, spread = two_sample_ok(k, batch, *MEMORY_CURVE_REF)
        log(f"path 16 (c): {name} p={p}: {k} of {batch} against "
            f"BASELINE.md's {MEMORY_CURVE_REF[0]} of {MEMORY_CURVE_REF[1]} "
            f"(9.2e-5): {'within' if ok else 'OUTSIDE'} two-sample 99.9%")
        if not ok:
            raise RuntimeError("memory curve point outside BASELINE.md's rate")
        return {"rows": rows, "curve": curve, "curve_fails": k}

    out["memory_bench"] = part("c_memory_bench", memory)

    # -- (d) the error curve against error_rate_curve and the JAX package
    def curve():
        rows = error_curve.main(["--code", "steane", "--device", str(dev)])
        ps = [r["p"] for r in rows]
        again = error_rate_curve(error_curve.CODES["steane"](), ps,
                                 samples_per_point=1 << 20, batch=1 << 18,
                                 seed=0, device=dev)
        if [{k: r[k] for k in a} for r, a in zip(rows, again)] != again:
            raise RuntimeError("error_curve.py differs from error_rate_curve")
        point = next(r for r in rows if r["p"] == 0.01)
        k = round(point["word_fail"] * point["samples"])
        ok, spread = two_sample_ok(k, point["samples"], *CURVE_REF)
        log(f"path 16 (d): error_curve == error_rate_curve at seed 0; p=0.01 "
            f"word failures {k} of {point['samples']} against the JAX "
            f"package's {CURVE_REF[0]} of {CURVE_REF[1]}: "
            f"{'within' if ok else 'OUTSIDE'} two-sample 99.9%")
        if not ok:
            raise RuntimeError("error curve p=0.01 outside the JAX package's")
        return {"rows": rows, "jax_ref": CURVE_REF}

    out["error_curve"] = part("d_error_curve", curve)

    # -- (e) the roofline (raises on a share above 1.0)
    def roof():
        rows = roofline.run(int_ops_per_s)
        for r in rows:
            log(f"path 16 (e): {json.dumps(r)}")
        return rows

    out["roofline"] = part("e_roofline", roof)

    # -- (f) bp_bench's spacetime, stream and gap rows
    out["bp_bench"] = part("f_bp_bench", lambda: bp_bench.main(
        list(BP16_ARGS) + ([] if dev.type == "cuda" else ["--cpu"])))

    # -- (g) the headline line (printed here, well before the last line)
    def head():
        row = headline.run(dev)
        print(json.dumps(row), flush=True)
        return row

    out["headline"] = part("g_headline", head)
    if on_card and min(launches["g_headline"][k]
                       for k in ("K1", "K2", "K6", "K8")) <= 0:
        raise RuntimeError(f"the headline missed a kernel: "
                           f"{launches['g_headline']}")

    # -- (h) the entry points: entry()'s forward (K8 then K6 a sector), then
    #    the dry run on the card named twice
    def forward():
        fwd, args = entry(dev)
        card = {k: int(v) for k, v in fwd(*args).items()}
        fwd_c, args_c = entry("cpu")
        cpu = {k: int(v) for k, v in fwd_c(*args_c).items()}
        if card != cpu:
            raise RuntimeError(f"entry(): card {card} != CPU {cpu}")
        log(f"path 16 (h): entry() forward on the card == CPU {card}")
        return card

    out["entry"] = part("h_entry", forward)
    out["dryrun"] = part("h_dryrun", lambda: dryrun_multichip(
        2, devices=[dev, dev]))
    log(f"path 16 (h): dryrun_multichip(2) on the card named twice: "
        f"{sorted(out['dryrun'])}")
    if on_card and (min(launches["h_entry"][k] for k in ("K6", "K8")) < 2
                    or min(launches["h_dryrun"][k] for k in ("K1", "K2"))
                    <= 0):
        raise RuntimeError(f"the entry points missed a kernel: "
                           f"{launches['h_entry']}, {launches['h_dryrun']}")

    # -- (i) the demo tour
    part("i_demo", lambda: demo.main(
        list(DEMO_ARGS) + ([] if dev.type == "cuda" else ["--cpu"])))

    total = {k: sum(v[k] for v in launches.values())
             for k in launches["a_rref"]}
    if on_card and (total["K1"] <= 0 or total["K2"] <= 0):
        raise RuntimeError(f"path 16 did not launch K1 and K2: {total}")
    out["seconds"] = seconds
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t_path
    log(f"path 16 wall {out['wall_s']:.1f} s ({smi}); launches {total}")
    kernels = {k: {"launches": total[k],
                   "by_part": {p: v[k] for p, v in launches.items()}}
               for k in total}
    # K1 and K2 held against their plain versions at (e)'s shapes (the
    # walked plain K1, `measure_sparse_bench.k2_row`), timed and bounded
    for row in out["roofline"]:
        key = {"uf_mosaic_full": "K1", "sparse_fetch": "K2"}.get(
            row.get("kernel"))
        if key:
            kernels[key]["roofline"] = row
    return out, kernels


def k1_equal(duf, device_uf_cuda, dg, defect, where: str,
             converged: bool = True):
    """K1 against its plain version on one batch, bit for bit: the packed
    labels, the activity, every chunk plane, the labels of every lane and
    the converged flags. Raises, naming ``where``, when they differ or
    (with ``converged``) when a row did not converge. Returns the max abs
    difference (0) and the kernel's labels and converged flags."""
    import torch

    out_k = device_uf_cuda.stencil_full(dg, defect)
    out_p = duf._stencil_plain(dg, defect)
    lab_k, conv_k = duf._stencil_labels(dg, defect, *out_k)
    lab_p, conv_p = duf._stencil_labels(dg, defect, *out_p)
    planes = [(out_k[0], out_p[0]), (out_k[1], out_p[1]),
              *zip(out_k[2], out_p[2]), *zip(lab_k, lab_p),
              (conv_k.to(torch.int32), conv_p.to(torch.int32))]
    err = max(max_abs(a, b) for a, b in planes)
    if err or len(out_k[2]) != len(out_p[2]) or len(lab_k) != len(lab_p):
        raise RuntimeError(f"K1 disagrees with its plain version {where} "
                           f"(max abs err {err})")
    if converged and not bool(conv_k.all()):
        raise RuntimeError(f"K1 left rows unconverged {where}")
    return err, lab_k, conv_k


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


def path8(dev):
    """Main path 8, the circuit-level qLDPC memory (BP+OSD, plain torch on
    the device): (a) `qldpc_memory_experiment` at QLDPC_CODE, R =
    QLDPC_ROUNDS, B = QLDPC_BATCH, both sectors, through
    `benchmarks/bp_bench.py`; (b) the device OSD-0 against the native host
    OSD-0 on (a)'s unconverged z-sector tail, bit for bit, and the device
    order-E sweep against the host's by soft weight; (c) the card's
    x_fail against the CPU's at QLDPC_CMP by a two-sample 99.9% test;
    (d) `qldpc_stream_memory_rate` at QLDPC_STREAM. Returns the rows."""
    import numpy as np
    import torch

    from qcss_tpu_torch import native
    from qcss_tpu_torch._cuda import synchronize
    from qcss_tpu_torch.benchmarks import bp_bench
    from qcss_tpu_torch.decode.bp import _osd_tail
    from qcss_tpu_torch.experiments.memory_qldpc import qldpc_memory_experiment

    # (a)
    prof = {}
    row = bp_bench.bench_circuit(QLDPC_CODE, QLDPC_ROUNDS, QLDPC_P,
                                 QLDPC_BATCH, QLDPC_ITERS, 0, "both", dev,
                                 profile=prof)
    split = ", ".join(f"{k} {v:.3f}" for k, v in row["split_s"].items())
    log(f"path 8 (a): qldpc_memory_experiment {QLDPC_CODE} R={QLDPC_ROUNDS} "
        f"B={QLDPC_BATCH} p={QLDPC_P} iters={QLDPC_ITERS} both sectors: "
        f"{row['shots_per_sec']:.1f} shots/s ({row['wall_s']:.3f} s wall, "
        f"graph build included); word_fail {row['word_fail']:.6f} (the "
        f"reference recorded {QLDPC_REF_WORD_FAIL}, information only), "
        f"x_fail {row['x_fail']:.6f}, z_fail {row['z_fail']:.6f}, "
        f"bp_converged z {row['bp_converged_z']:.4f} x "
        f"{row['bp_converged_x']:.4f}; faults z {row['faults_z']} x "
        f"{row['faults_x']}; BP iterations z {row['bp_iters_z']} x "
        f"{row['bp_iters_x']}; OSD tail z {row['osd_tail_z']} x "
        f"{row['osd_tail_x']} on {row['osd_backend_z']} "
        f"({row['osd_host_fallback_z']} + {row['osd_host_fallback_x']} "
        f"re-solved on the host); seconds: {split}; peak memory "
        f"{row['peak_mem_gb']} GiB")
    if not (row["faults_z"] > 0 and 0.0 <= row["word_fail"] < 0.05
            and row["bp_converged_z"] > 0 and row["bp_converged_x"] > 0):
        raise RuntimeError(f"implausible qLDPC memory result {row}")
    # (b)
    tail = prof["z"].get("tail_inputs")
    if tail is None or tail["synd"].shape[0] == 0:
        raise RuntimeError("(a) left no OSD tail to check")
    h, synd, soft = tail["h"], tail["synd"], tail["soft"]
    synchronize(dev)
    t0 = time.perf_counter()
    e_dev, _, short = _osd_tail(h, synd, soft, backend="device")
    synchronize(dev)
    dev_s = time.perf_counter() - t0
    synd_np, soft_np = synd.cpu().numpy(), soft.cpu().numpy()
    t0 = time.perf_counter()
    e_host = native.osd0_batch_native(h, synd_np, soft_np)
    host_s = time.perf_counter() - t0
    if e_host is None:
        raise RuntimeError("the native OSD did not load")
    differ = int((e_dev.cpu().numpy() != e_host).any(axis=1).sum())
    m = min(synd.shape[0], QLDPC_OSDE_CHECK)
    synchronize(dev)
    t0 = time.perf_counter()
    ee_dev, _, eshort = _osd_tail(h, synd[:m], soft[:m], backend="device",
                                  sweep=(2, 16, 10))
    synchronize(dev)
    dev_e_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ee_host = native.osde_batch_native(h, synd_np[:m], soft_np[:m], 2,
                                       16, 10)
    host_e_s = time.perf_counter() - t0
    w = np.abs(soft_np[:m]).astype(np.float64)
    w_dev = (ee_dev.cpu().numpy() * w).sum(axis=1)
    w_host = (ee_host * w).sum(axis=1)
    w_gap = float(np.max(np.abs(w_dev - w_host)
                         / np.maximum(1.0, w_host), initial=0.0))
    e_differ = int((ee_dev.cpu().numpy() != ee_host).any(axis=1).sum())
    r_h, n_h = h.shape
    osd = {"tail": int(synd.shape[0]), "rank_short": short,
           "osd0_differ": differ, "osd0_dev_s": dev_s,
           "osd0_host_s": host_s, "osde_shots": m,
           "osde_rank_short": eshort, "osde_differ": e_differ,
           "osde_rel_weight_gap": w_gap, "osde_dev_s": dev_e_s,
           "osde_host_s": host_e_s}
    log(f"path 8 (b): device OSD-0 against the native host OSD-0 on (a)'s "
        f"z-sector tail of {osd['tail']} shots ([{r_h} x {n_h}]): "
        f"{differ} shots differ, {short} short of rank within the column "
        f"cap (re-solved on the host); device {dev_s:.3f} s, host "
        f"{host_s:.3f} s. OSD-E (order 2, lambda 16/10) on {m} shots: "
        f"{e_differ} solutions differ, largest relative soft-weight gap "
        f"{w_gap:.3g}, {eshort} short of rank; device {dev_e_s:.3f} s, "
        f"host {host_e_s:.3f} s")
    if differ or w_gap > 1e-4:
        raise RuntimeError("the device OSD disagrees with the host's")
    # (c)
    cname, crounds, cbatch = QLDPC_CMP
    ccode = bp_bench.CODES[cname]()
    cmp = {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        out = qldpc_memory_experiment(
            ccode, rounds=crounds, noise=bp_bench.uniform_noise(QLDPC_P),
            batch=cbatch, iters=QLDPC_ITERS, sectors="z", seed=5,
            device=where)
        cmp[label] = {"x_fail": out["x_fail"],
                           "fails": round(out["x_fail"] * cbatch),
                           "bp_converged_z": out["bp_converged_z"],
                           "wall_s": time.perf_counter() - t0}
    passed, spread = two_sample_ok(cmp["card"]["fails"], cbatch,
                                   cmp["cpu"]["fails"], cbatch)
    log(f"path 8 (c): {cname} R={crounds} B={cbatch} x_fail: card "
        f"{cmp['card']['x_fail']:.6f} ({cmp['card']['fails']} fails, "
        f"{cmp['card']['wall_s']:.2f} s), CPU {cmp['cpu']['x_fail']:.6f} "
        f"({cmp['cpu']['fails']} fails, {cmp['cpu']['wall_s']:.2f} s); "
        f"allowed difference {spread:.6f} (two-sample 99.9%)")
    if not passed:
        raise RuntimeError("the card's qLDPC x_fail disagrees with the CPU's")
    # (d)
    sname, srounds, sbatch = QLDPC_STREAM
    stream = bp_bench.bench_circuit_stream(sname, srounds, QLDPC_P, sbatch,
                                           WINDOW, COMMIT, 48, 0, dev)
    log(f"path 8 (d): qldpc_stream_memory_rate {sname} R={srounds} "
        f"B={sbatch} window {WINDOW} commit {COMMIT}: "
        f"{stream['round_shots_per_sec']:.1f} round-shots/s, x_fail "
        f"{stream['x_fail']:.6f}, all windows converged "
        f"{stream['bp_all_windows_converged']:.4f}")
    if not 0.0 <= stream["x_fail"] < 0.2:
        raise RuntimeError(f"implausible qLDPC stream result {stream}")
    return {"memory": row, "osd": osd, "card_vs_cpu": cmp, "stream": stream}


def path9(dev):
    """Main path 9, per-shot side-information decoding: (a) belief-matching
    (`belief_bench.run`: `xz_memory_experiment(belief=32)`) at rotated
    surface d = 5, 7, R = d, B = 16384 beside independent and correlated
    matching on the same shots, with the time split and the peak device
    memory; (b) the fused soft decode (`soft_device_memory_rate`) and, on
    one batch, its device decode against the host `UFDecoder` with the
    same weights; (c) `erasure_phenomenological_error_rate` with
    decoder='device', heralded and blind; (d) `leakage_memory_experiment`
    with decoder='device', heralded, calibrated and blind, and
    `leakage_circuit_memory` heralded and blind; (e) `MLDecoder` on the
    [[34,4,3]] hypergraph product, card against CPU, and its
    `device_decode_fn` against `decode_flips` on the card. K1's launches
    are counted over the path and per arm. Returns the rows."""
    import numpy as np
    import torch

    from qcss_tpu_torch.benchmarks import belief_bench
    from qcss_tpu_torch.codes import families
    from qcss_tpu_torch.decode import device_uf, device_uf_cuda
    from qcss_tpu_torch.decode.mld import MLDecoder
    from qcss_tpu_torch.decode.uf import UFDecoder
    from qcss_tpu_torch.experiments import erasure, leakage, soft
    from qcss_tpu_torch.ops import gf2_torch
    from qcss_tpu_torch.sim.noise import NoiseModel, chunk_generators

    t_path = time.perf_counter()
    device_uf_cuda.launches = device_uf_cuda.chunk_launches = 0
    out = {}
    # (a)
    rows = {}
    for d in SI_BELIEF_D:
        torch.cuda.reset_peak_memory_stats(dev)
        prof = []
        row = belief_bench.run(d, SI_BELIEF_BATCH, 1, *SI_BELIEF_NOISE,
                               SI_BELIEF_ITERS, dev, profile=prof)
        row["split_s"] = prof[0]
        row["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
        row["failures"] = {k: round(row[k] * SI_BELIEF_BATCH)
                           for k in belief_bench.RATE_KEYS}
        rows[d] = row
        fl = row["failures"]
        log(f"path 9 (a): belief-matching d={d} R={d} B={SI_BELIEF_BATCH} "
            f"p_gate2={SI_BELIEF_NOISE[0]} p_meas={SI_BELIEF_NOISE[1]} "
            f"iters={SI_BELIEF_ITERS}: word failures independent "
            f"{fl['word_fail']} ({row['word_fail']:.6f}), correlated "
            f"{fl['word_fail_corr']} ({row['word_fail_corr']:.6f}), belief "
            f"{fl['word_fail_belief']} ({row['word_fail_belief']:.6f}); x / "
            f"z failures independent {fl['x_fail']} / {fl['z_fail']}, "
            f"correlated z {fl['z_fail_corr']}, belief "
            f"{fl['x_fail_belief']} / {fl['z_fail_belief']}; wall "
            f"{row['wall_s']:.3f} s; seconds: " + ", ".join(
                f"{k} {v:.3f}" for k, v in row["split_s"].items())
            + f"; peak memory {row['peak_mem_gb']:.3f} GiB")
    ref = SI_BELIEF_REF[5]
    log(f"path 9 (a): d=5 word failure rates belief {rows[5]['word_fail_belief']:.6f} "
        f"against independent {rows[5]['word_fail']:.6f} (BASELINE.md "
        f"recorded {ref[0]} against {ref[1]} on its own shots: accuracy "
        f"reference only)")
    if rows[5]["failures"]["word_fail_belief"] > rows[5]["failures"]["word_fail"]:
        raise RuntimeError("belief-matching failed more shots than "
                           "independent matching at d=5")
    for row in rows.values():
        if not 0.0 <= row["word_fail"] < 0.05:
            raise RuntimeError(f"implausible belief-matching row {row}")
    out["belief"] = rows
    # (b)
    code = families.rotated_surface(SI_D)
    p, sigma, batch, reps = SI_SOFT
    fused = soft.soft_device_memory_rate(code, p, sigma, rounds=SI_D,
                                         batch=batch, reps=reps,
                                         seed=SI_SEED, device=dev)
    graph, w_space, base_ln = soft._fused_soft_graph(code, p, sigma, SI_D, 8)
    dg = device_uf.build_device_graph(graph, stencil=False).to(dev)
    h_t, lz_t = soft._code_tensors(code, dev)
    gen = chunk_generators(SI_SEED + 1, 1, dev)[0]
    dets, par, amp = soft._sample_soft_stream(gen, p, sigma, batch, SI_D,
                                              code.n, h_t, lz_t)
    sw = soft._soft_shot_weights(
        amp, sigma, 8, base_ln,
        torch.as_tensor(w_space.astype(np.int32), device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, conv = device_uf.decode_labels(dg, dets, shot_weights=sw)
    obs_dev = labels[0].cpu().numpy().astype(np.uint32)
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, obs_host = UFDecoder(graph).decode_batch(
        dets.cpu().numpy(), want_corrections=False,
        shot_weights=sw.cpu().numpy().astype(np.uint8))
    host_s = time.perf_counter() - t0
    agree = float(np.mean(obs_dev == obs_host))
    par_bits = par.cpu().numpy()[:, 0].astype(np.uint32)
    out["soft"] = {**fused, "agreement": agree,
                   "converged": bool(conv.all()),
                   "fails_device": int((obs_dev != par_bits).sum()),
                   "fails_host": int((obs_host != par_bits).sum()),
                   "device_decode_s": dev_s, "host_decode_s": host_s}
    log(f"path 9 (b): soft_device_memory_rate d={SI_D} R={SI_D} p={p} "
        f"sigma={sigma} B={batch} reps={reps}: "
        f"{fused['shots_per_sec']:.1f} shots/s, logical_fail "
        f"{fused['logical_fail']:.6f}; one batch's weighted decode, device "
        f"against host UFDecoder: agreement {agree:.6f} (at least "
        f"{SI_SOFT_AGREE}), failures {out['soft']['fails_device']} / "
        f"{out['soft']['fails_host']}, device {dev_s:.3f} s, host "
        f"{host_s:.3f} s")
    if agree < SI_SOFT_AGREE or not out["soft"]["converged"]:
        raise RuntimeError("the fused soft decode disagrees with the host")
    # (c)
    p, p_erase, samples, batch = SI_ERASE
    arms = {}
    for heralded in (True, False):
        before = device_uf_cuda.launches
        t0 = time.perf_counter()
        r = erasure.erasure_phenomenological_error_rate(
            code, p, p_erase, rounds=SI_D, samples=samples, batch=batch,
            seed=SI_SEED, heralded=heralded, decoder="device", device=dev)
        r["wall_s"] = time.perf_counter() - t0
        r["failures"] = round(r["logical_fail"] * r["samples"])
        r["k1_launches"] = device_uf_cuda.launches - before
        arms["heralded" if heralded else "blind"] = r
    out["erasure"] = arms
    log(f"path 9 (c): erasure_phenomenological_error_rate d={SI_D} "
        f"R={SI_D} p={p} p_erase={p_erase} samples={samples} batch={batch} "
        f"decoder='device': heralded {arms['heralded']['failures']} "
        f"failures ({arms['heralded']['logical_fail']:.6f}, "
        f"{arms['heralded']['wall_s']:.3f} s, K1 launches "
        f"{arms['heralded']['k1_launches']}: per-shot weights run the "
        f"generic decoder), blind {arms['blind']['failures']} "
        f"({arms['blind']['logical_fail']:.6f}, "
        f"{arms['blind']['wall_s']:.3f} s, K1 launches "
        f"{arms['blind']['k1_launches']})")
    if arms["heralded"]["failures"] > arms["blind"]["failures"]:
        raise RuntimeError("heralded erasure failed more shots than blind")
    if arms["blind"]["k1_launches"] <= 0:
        raise RuntimeError("the blind erasure arm did not launch K1")
    # (d)
    p, p_leak, rounds, samples, batch = SI_LEAK
    arms = {}
    for name, kw in (("heralded", {"heralded": True}),
                     ("calibrated", {"heralded": False, "calibrated": True}),
                     ("blind", {"heralded": False})):
        before = device_uf_cuda.launches
        t0 = time.perf_counter()
        r = leakage.leakage_memory_experiment(
            code, p, p_leak, rounds=rounds, samples=samples, batch=batch,
            seed=SI_SEED, decoder="device", device=dev, **kw)
        r["wall_s"] = time.perf_counter() - t0
        r["failures"] = round(r["logical_fail"] * r["samples"])
        r["k1_launches"] = device_uf_cuda.launches - before
        arms[name] = r
    expect = float(leakage.expected_leak_profile(p_leak, 0.2, rounds).mean())
    log(f"path 9 (d): leakage_memory_experiment d={SI_D} R={rounds} p={p} "
        f"p_leak={p_leak} samples={samples} decoder='device': " + ", ".join(
            f"{k} {v['failures']} failures ({v['logical_fail']:.6f}, "
            f"{v['wall_s']:.3f} s, K1 launches {v['k1_launches']})"
            for k, v in arms.items())
        + f"; leak fraction {arms['heralded']['leak_fraction']:.6f} (rounds "
        f"and the final layer) beside expected_leak_profile's mean "
        f"{expect:.6f} (rounds)")
    rounds, batch, p_leak = SI_LEAK_CIRCUIT
    nm = NoiseModel(p_gate2=1e-3, p_meas=2e-3, p_reset=1e-3)
    circ = {}
    for heralded in (True, False):
        t0 = time.perf_counter()
        r = leakage.leakage_circuit_memory(
            code, rounds=rounds, noise=nm, p_leak=p_leak, batch=batch,
            seed=SI_SEED, heralded=heralded, device=dev)
        r["wall_s"] = time.perf_counter() - t0
        circ["heralded" if heralded else "blind"] = r
    expect_c = float(leakage.expected_leak_profile(p_leak, 0.2,
                                                   rounds).mean())
    log(f"path 9 (d): leakage_circuit_memory d={SI_D} R={rounds} B={batch} "
        f"p_leak={p_leak}: word_fail heralded "
        f"{circ['heralded']['word_fail']:.6f} "
        f"({circ['heralded']['wall_s']:.3f} s), blind "
        f"{circ['blind']['word_fail']:.6f} ({circ['blind']['wall_s']:.3f} "
        f"s); leak fraction {circ['heralded']['leak_fraction']:.6f} beside "
        f"expected_leak_profile's mean {expect_c:.6f}")
    for r in list(arms.values()) + list(circ.values()):
        if not 0.0 <= r.get("logical_fail", r.get("word_fail")) < 0.05:
            raise RuntimeError(f"implausible leakage result {r}")
    out["leakage"] = {"memory": arms, "expected_leak_fraction": expect,
                      "circuit": circ,
                      "expected_leak_fraction_circuit": expect_c}
    # (e)
    p, batch, cpu_slice = SI_MLD
    h5 = np.array([[1, 1, 1, 0, 0], [0, 1, 1, 1, 0], [0, 0, 1, 1, 1]],
                  np.uint8)
    hgp = families.hypergraph_product(h5, h5, distance=3)
    gen = torch.Generator(device=dev).manual_seed(SI_SEED)
    x_err = (torch.rand((batch, hgp.n), generator=gen, device=dev) < p
             ).to(torch.uint8)
    h2 = torch.as_tensor(np.asarray(hgp.parity_check_c2, np.uint8),
                         device=dev)
    syn_t = gf2_torch.syndromes_dense(x_err, h2)
    syn = syn_t.cpu().numpy()
    truth = gf2_torch.mod2_matmul(x_err, torch.as_tensor(
        np.asarray(hgp.z_operator_matrix(), np.uint8), device=dev).T
    ).cpu().numpy()
    ml_card = MLDecoder.for_code(hgp, p=p, device=dev)
    ml_card.decode_flips(syn[:64])  # coset table to the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f_card, s_card = ml_card.decode_flips(syn, return_scores=True)
    card_s = time.perf_counter() - t0
    ml_cpu = MLDecoder.for_code(hgp, p=p, device="cpu")
    t0 = time.perf_counter()
    parts = [ml_cpu.decode_flips(syn[i:i + cpu_slice], return_scores=True)
             for i in range(0, batch, cpu_slice)]
    cpu_s = time.perf_counter() - t0
    f_cpu = np.concatenate([a for a, _ in parts])
    s_cpu = np.concatenate([b for _, b in parts], axis=1)

    def ties(scores):
        top = np.sort(scores, axis=0)
        return top[-1] - top[-2] <= SI_MLD_TIE * np.abs(top[-1])

    tie = ties(s_card) | ties(s_cpu)
    differ = (f_card != f_cpu).any(axis=1)
    llr = torch.full((batch, hgp.n), math.log(p / (1 - p)),
                     dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f_fn = ml_card.device_decode_fn()(syn_t, llr).cpu().numpy()
    fn_s = time.perf_counter() - t0
    fn_differ = int((f_fn != f_card).any(axis=1).sum())
    fail = float(((f_card ^ truth).any(axis=1)).mean())
    out["mld"] = {"code": f"[[{hgp.n},{hgp.k},3]] hypergraph product",
                  "cosets": int(ml_card._coset.shape[0]),
                  "classes": 1 << hgp.k, "p": p, "syndromes": batch,
                  "card_s": card_s, "cpu_s": cpu_s,
                  "device_decode_fn_s": fn_s, "differ": int(differ.sum()),
                  "ties": int(tie.sum()),
                  "differ_outside_ties": int((differ & ~tie).sum()),
                  "device_decode_fn_differ": fn_differ, "word_fail": fail}
    log(f"path 9 (e): MLDecoder [[{hgp.n},{hgp.k},3]] hypergraph product "
        f"({out['mld']['cosets']} cosets x {out['mld']['classes']} "
        f"classes) p={p} on {batch} syndromes: card {card_s:.3f} s, CPU "
        f"{cpu_s:.3f} s; flips differ on {out['mld']['differ']} shots, "
        f"{out['mld']['ties']} shots tie (best two class scores within "
        f"{SI_MLD_TIE:g} relative), {out['mld']['differ_outside_ties']} "
        f"differ outside the ties; device_decode_fn against decode_flips "
        f"on the card: {fn_differ} shots differ ({fn_s:.3f} s); ML word "
        f"failure {fail:.6f}")
    if out["mld"]["differ_outside_ties"] or fn_differ:
        raise RuntimeError("the ML decoder disagrees: card against CPU, or "
                           "device_decode_fn against decode_flips")
    out["k1_launches"] = device_uf_cuda.launches
    out["k1_chunk_launches"] = device_uf_cuda.chunk_launches
    out["wall_s"] = time.perf_counter() - t_path
    log(f"main path 9 launches: stencil kernel {out['k1_launches']} "
        f"({out['k1_chunk_launches']} with chunks); path 9 wall "
        f"{out['wall_s']:.1f} s")
    if out["k1_launches"] <= 0:
        raise RuntimeError("path 9 did not launch K1")
    return out


def closed_odd_cycle(graph, wit, bit: int) -> bool:
    """Every real detector of the edge list ``wit`` touched an even number
    of times, and observable ``bit``'s labels sum to 1."""
    import numpy as np

    deg = np.zeros(graph.num_nodes, np.int64)
    par = 0
    for e in wit:
        for x in graph.edges[e]:
            if x >= 0:
                deg[x] += 1
        par ^= (int(graph.edge_obs[e]) >> bit) & 1
    return bool((deg % 2 == 0).all()) and par == 1


def path10(dev, int_ops_per_s):
    """Main path 10, lattice surgery and patch schedules: (a) the bespoke
    protocols (`xx_merge_memory`, `xx_merge_split_memory`,
    `surgery_cnot_memory`, `t_gadget_memory`, `parity_chain_memory`) at
    d = 5, 7, B = 32768, sampled on the card and decoded by the host
    union-find, each d=5 count against BASELINE.md's rate; (b) the fused
    schedule pipeline (`schedule_memory_device` on the parity chain: K1 at
    d = 5, 7, K2 with K1 behind it at d=5), each count against (a)'s host
    decode of the same model; (c) the circuit-level merge
    (`xx_merge_circuit_memory`: the frame sampler, then BP with the device
    OSD); (d) fault distances with witnesses. K1's and K2's launches are
    counted over (a)-(d). Then, outside the count, K1 at the chain's d=7
    shape (V=2689, O=10) and K2 at d=5 against their plain versions on
    the card's own detectors, timed. Returns the rows and the kernels'
    entries."""
    import numpy as np
    import torch

    from qcss_tpu_torch.benchmarks import measure_sparse_bench as msb
    from qcss_tpu_torch.benchmarks.profiling import cuda_ms
    from qcss_tpu_torch.decode import device_sparse as dsp
    from qcss_tpu_torch.decode import device_sparse_cuda, device_uf_cuda
    from qcss_tpu_torch.decode import device_uf as duf
    from qcss_tpu_torch.decode import fault_distance as fdist
    from qcss_tpu_torch.decode.uf import UFDecoder
    from qcss_tpu_torch.experiments import (
        patches,
        surgery,
        surgery_circuit,
        surgery_t,
    )
    from qcss_tpu_torch.sim.noise import NoiseModel

    entry = {"xx_merge_memory": surgery.xx_merge_memory,
             "xx_merge_split_memory": surgery.xx_merge_split_memory,
             "surgery_cnot_memory": surgery.surgery_cnot_memory,
             "t_gadget_memory": surgery_t.t_gadget_memory,
             "parity_chain_memory": patches.parity_chain_memory}
    t_path = time.perf_counter()
    device_uf_cuda.launches = device_uf_cuda.chunk_launches = 0
    device_sparse_cuda.launches = 0
    out = {}
    # (a)
    B = SURGERY_BATCH
    rows = {}
    for d in SURGERY_D:
        for name, p, ref in SURGERY_RUNS:
            torch.cuda.reset_peak_memory_stats(dev)
            prof = {}
            t0 = time.perf_counter()
            r = entry[name](d, p, batch=B, seed=SURGERY_SEED, device=dev,
                            profile=prof)
            r["wall_s"] = time.perf_counter() - t0
            r["split_s"] = prof
            r["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
            fails = {k: v for k, v in r.items() if k.endswith("_fail")}
            r["failures"] = {k: round(v * B) for k, v in fails.items()}
            rows[f"{name} d={d}"] = r
            log(f"path 10 (a): {name} d={d} p=q={p} B={B}: failures "
                + ", ".join(f"{k} {r['failures'][k]} ({v:.6f})"
                            for k, v in fails.items())
                + f"; {r.get('detectors', r.get('detectors_m'))} detectors; "
                f"wall {r['wall_s']:.3f} s; seconds: "
                + ", ".join(f"{k} {v:.3f}" for k, v in prof.items())
                + f"; peak memory {r['peak_mem_gb']:.3f} GiB")
            if any(not 0.0 <= v < 0.05 for v in fails.values()):
                raise RuntimeError(f"implausible surgery row {name} d={d}")
            if d != 5:
                continue
            for key, rate in ref.items():
                k_ref = round(rate * B)
                ok, spread = two_sample_ok(r["failures"][key], B, k_ref, B)
                log(f"path 10 (a): {name} d=5 {key} {r['failures'][key]} "
                    f"against BASELINE.md's {rate} ({k_ref} of {B}): "
                    f"allowed difference {spread:.6f}")
                if not ok:
                    raise RuntimeError(f"{name} d=5 {key} disagrees with "
                                       f"BASELINE.md's rate")
    out["protocols"] = rows
    # (b)
    p, batch, reps = SURGERY_FUSED
    models = {d: patches.parity_chain_model(d) for d in SURGERY_D}
    fused = {}
    for d, kind in SURGERY_FUSED_RUNS:
        model = models[d]
        mean_d, d_max = patches._hybrid_load(model, p, p)
        t0 = time.perf_counter()
        # the first call builds the runner (device graph, sparse tables)
        patches.schedule_memory_device(model, p, batch=batch, reps=1,
                                       seed=SURGERY_SEED + 1,
                                       device_decoder=kind, device=dev)
        first_s = time.perf_counter() - t0
        k1, k2 = device_uf_cuda.launches, device_sparse_cuda.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = patches.schedule_memory_device(model, p, batch=batch, reps=reps,
                                           seed=SURGERY_SEED,
                                           device_decoder=kind, device=dev)
        r["wall_s"] = time.perf_counter() - t0
        r["first_call_s"] = first_s
        r["shots_per_sec"] = r["samples"] / r["wall_s"]
        r["k1_launches"] = device_uf_cuda.launches - k1
        r["k2_launches"] = device_sparse_cuda.launches - k2
        r["mean_defects"], r["d_max"] = mean_d, d_max
        r["failures"] = round(r["word_fail"] * r["samples"])
        host = rows[f"parity_chain_memory d={d}"]
        ok, spread = two_sample_ok(r["failures"], r["samples"],
                                   host["failures"]["word_fail"], B)
        fused[f"{kind} d={d}"] = r
        log(f"path 10 (b): schedule_memory_device(parity_chain_model({d}), "
            f"p=q={p}, batch={batch}, reps={reps}, '{kind}'): V="
            f"{r['detectors']}, mean defects {mean_d:.2f} (d_max rule "
            f"{d_max}); {r['shots_per_sec']:.1f} shots/s ({r['wall_s']:.3f} "
            f"s; first call {first_s:.3f} s with the runner's build); word "
            f"failures {r['failures']} ({r['word_fail']:.6f}) against the "
            f"host decode's {host['failures']['word_fail']} of {B} (allowed "
            f"difference {spread:.6f}); K1 launches {r['k1_launches']}, K2 "
            f"launches {r['k2_launches']}")
        if not ok:
            raise RuntimeError(f"the fused '{kind}' pipeline at d={d} "
                               f"disagrees with the host decode")
        if kind == "dense" and r["k1_launches"] < reps:
            raise RuntimeError(f"the dense pipeline at d={d} did not launch K1")
        if kind == "hybrid" and r["k2_launches"] < reps:
            raise RuntimeError(f"the hybrid pipeline at d={d} did not "
                               f"launch K2")
    out["fused"] = fused
    # (c)
    d, pc, cbatch = SURGERY_CIRCUIT
    noise = NoiseModel(p_gate1=pc, p_gate2=pc, p_meas=pc, p_reset=pc)
    prof = {}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    circ = surgery_circuit.xx_merge_circuit_memory(
        d, noise, batch=cbatch, seed=SURGERY_SEED, device=dev, profile=prof)
    circ["wall_s"] = time.perf_counter() - t0
    circ["split_s"] = prof
    circ["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["circuit"] = circ
    log(f"path 10 (c): xx_merge_circuit_memory d={d} uniform p={pc} "
        f"B={cbatch}: m_fail {circ['m_fail']:.6f}, logical_fail "
        f"{circ['logical_fail']:.6f}, word_fail {circ['word_fail']:.6f} "
        f"({round(circ['word_fail'] * cbatch)} shots), bp_converged "
        f"{circ['bp_converged']:.6f}; {circ['detectors']} detectors, "
        f"{circ['fault_vars']} fault variables; wall {circ['wall_s']:.3f} "
        f"s; seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in prof.items())
        + f"; peak memory {circ['peak_mem_gb']:.3f} GiB")
    if not 0.0 <= circ["word_fail"] < 0.05 or circ["bp_converged"] < 0.5:
        raise RuntimeError(f"implausible circuit-level surgery row {circ}")
    # (d)
    t0 = time.perf_counter()
    dists = {}
    for d in SURGERY_FD_T:
        for sector, build in (("zz_merge_split",
                               surgery_t.build_zz_merge_split),
                              ("merge_readout_sector",
                               surgery_t.build_merge_readout_sector)):
            model = build(d, d, d, d)
            for bit in range(model.obs.shape[0]):
                dist, n_min, wit = fdist.observable_fault_distance(
                    model.graph, bit, with_witness=True)
                dists[f"t_gadget {sector} d={d} obs{bit}"] = [dist, n_min]
                if dist != d or len(wit) != dist or not closed_odd_cycle(
                        model.graph, wit, bit):
                    raise RuntimeError(
                        f"T gadget {sector} d={d} obs{bit}: fault distance "
                        f"{dist}, witness of {len(wit)} edges")
    for d in SURGERY_FD_CHAIN:
        model = models.get(d) or patches.parity_chain_model(d)
        for name, (dist, n_min) in fdist.model_fault_distances(
                model).items():
            dists[f"parity_chain d={d} {name}"] = [dist, n_min]
            if dist != d:
                raise RuntimeError(f"parity chain d={d} {name}: fault "
                                   f"distance {dist}")
    out["fault_distances"] = dists
    out["fault_distance_s"] = time.perf_counter() - t0
    log(f"path 10 (d): fault distances (distance, minimal sets' base "
        f"vertices) " + ", ".join(f"{k} {v[0]} ({v[1]})"
                                 for k, v in dists.items())
        + f"; every T-gadget witness a closed odd cycle; "
        f"{out['fault_distance_s']:.3f} s")
    out["k1_launches"] = device_uf_cuda.launches
    out["k1_chunk_launches"] = device_uf_cuda.chunk_launches
    out["k2_launches"] = device_sparse_cuda.launches
    out["wall_s"] = time.perf_counter() - t_path
    log(f"main path 10 launches: stencil kernel {out['k1_launches']} "
        f"({out['k1_chunk_launches']} with chunks), sparse kernel "
        f"{out['k2_launches']}; path 10 wall {out['wall_s']:.1f} s")
    if out["k1_launches"] <= 0 or out["k2_launches"] <= 0:
        raise RuntimeError("path 10 did not launch K1 and K2")

    # the fused pipeline's decoders against the host union-find on the same
    # shots, reps batches each (information: both are union-find, and they
    # may pick other matchings)
    for d, kind in SURGERY_FUSED_RUNS:
        decode = patches._device_decoder(models[d], p, p, kind, dev)
        host_uf = UFDecoder(models[d].graph)
        gen = torch.Generator(device=dev).manual_seed(SURGERY_SEED + 3)
        n_dev = n_host = n_agree = 0
        for _ in range(reps):
            dets, ob = surgery._sample(
                gen, p, p, batch, *surgery._model_tensors(models[d], dev))
            flips = decode(dets)[0].cpu().numpy().astype(np.int64)
            _, corr = host_uf.decode_batch(dets.cpu().numpy(),
                                           want_corrections=False)
            corr = corr.astype(np.int64)
            truth = (ob.cpu().numpy().astype(np.int64)
                     << np.arange(ob.shape[1])).sum(axis=1)
            n_dev += int(((flips ^ truth) != 0).sum())
            n_host += int(((corr ^ truth) != 0).sum())
            n_agree += int((flips == corr).sum())
        fused[f"{kind} d={d}"]["same_shots"] = {
            "device_failures": n_dev, "host_failures": n_host,
            "agreement": n_agree / (batch * reps)}
        log(f"path 10 (b), outside the count: the '{kind}' decoder at d={d} "
            f"against the host UFDecoder on the same {batch * reps} shots: "
            f"word failures {n_dev} / {n_host}, observable flips agree on "
            f"{n_agree / (batch * reps):.6f}")

    # K1 at the chain's d=7 shape and K2 at d=5, on one batch of the card's
    # own detectors each: against their plain versions bit for bit, timed
    # (these launches are not the path's)
    d_hi, d_lo = max(SURGERY_D), min(SURGERY_D)
    gen = torch.Generator(device=dev).manual_seed(SURGERY_SEED + 2)
    dg = duf.build_device_graph(models[d_hi].graph).to(dev)
    dets_hi, _ = surgery._sample(gen, p, p, batch,
                                 *surgery._model_tensors(models[d_hi], dev))
    defect = duf.stencil_defect(dg, dets_hi)
    k1_err = k1_equal(duf, device_uf_cuda, dg, defect,
                      f"at the parity chain's d={d_hi} shape")[0]
    V = defect.shape[1]
    label = (f"B={batch} V={V} O={len(dg.stencil.deltas)} "
             f"KB={dg.stencil.bmask.shape[0]} NC=0")
    k1_ms = cuda_ms(lambda: device_uf_cuda.stencil_full(dg, defect), 10)
    k1_plain_ms = cuda_ms(lambda: duf._stencil_plain(dg, defect), 1)
    plan, need, bnd = k1_report(f"{label} (parity chain d={d_hi})",
                                device_uf_cuda, dg, defect,
                                int_ops_per_s)
    log(f"K1 at the parity chain's d={d_hi} shape {label}, deltas "
        f"{dg.stencil.deltas}: == plain (packed, act, obs, converged) on "
        f"the card's detectors; kernel {k1_ms:.4f} ms, plain "
        f"{k1_plain_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    k2_dmax = patches._hybrid_load(models[d_lo], p, p)[1]
    tables = dsp._tables_to(dsp.build_sparse_tables(models[d_lo].graph), dev)
    dets_lo, _ = surgery._sample(gen, p, p, batch,
                                 *surgery._model_tensors(models[d_lo], dev))
    k2 = msb.k2_row(tables, dets_lo, 20, int_ops_per_s, d_max=k2_dmax)
    k2.update(d=d_lo, rounds=d_lo)
    log(f"K2 at the parity chain's d={d_lo} shape B={batch} "
        f"V={dets_lo.shape[1]} "
        f"d_max={k2_dmax}: == plain on the card's detectors; wrapper "
        f"{k2['ms']:.4f} ms, a launch in a graph {k2['hot_ms']:.4f} hot, "
        f"{k2['cold_ms']:.4f} cold; plain {k2['plain_ms']:.3f} ms; bound "
        f"{k2['bound_ms']:.4f} ms ({k2['bound_by']}); defects a shot "
        f"{k2['defects_per_shot']}")
    out["kernels"] = {
        "K1": {"shape": f"{label} (parity chain d={d_hi}, path 10 (b))",
               "launches": out["k1_launches"],
               "by_run": {k: r["k1_launches"] for k, r in fused.items()},
               "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
               "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
               "plan": plan, "work": need},
        "K2": {"shape": f"B={batch} V={dets_lo.shape[1]} d_max="
                        f"{k2_dmax} (parity chain d={d_lo}, path 10 "
                        f"(b))",
               "launches": out["k2_launches"], "max_abs_err": 0,
               **{k: k2[k] for k in (
                   "ms", "host_ms", "hot_ms", "cold_ms", "plain_ms",
                   "bound_ms", "bound_by", "library_ms", "bytes", "int_ops",
                   "defects_per_shot", "events_per_shot", "sweeps_per_shot",
                   "plan")}}}
    return out


def _logical_program(name: str, d: int):
    """Path 11's programs, compiled on a d x d patch grid."""
    from qcss_tpu_torch.experiments.logical import LogicalProgram

    if name == "cnot":
        return LogicalProgram(d, 2).cnot(0, 1)
    if name == "cnot01_t1_cnot12":
        return LogicalProgram(d, 3).cnot(0, 1).t(1).cnot(1, 2)
    if name == "s":
        return LogicalProgram(d, 1).s(0)
    if name == "mx":
        return LogicalProgram(d, 1).mx(0)
    if name == "feedback":
        return LogicalProgram(d, 1).mx(0).h(0).x_if(0, "mx0_0")
    if name == "hzh":
        return LogicalProgram(d, 1).h(0).z(0).h(0)
    raise KeyError(name)


def _k1_route(duf, graph) -> str | None:
    """None when K1 decodes ``graph`` (a stencil graph), else why not, in
    `device_uf.stencil_refusal`'s words: such graphs decode in the generic
    plain decoder (`device_uf._decode_packed`)."""
    why = duf.stencil_refusal(graph)
    if why is None:
        return None
    return (f"the generic plain decoder: not a stencil graph (V="
            f"{graph.num_nodes}: {why})")


def path11(dev, int_ops_per_s):
    """Main path 11, the compiled logical programs (`LogicalProgram`):
    (a) the fused compiled CNOT, bench.py's `compiled_cnot_sparse`
    (d=3, p=q=2e-3, B=2^15, 4 reps after a warm call with the same reps,
    decoder='device-uf-sparse': K2 with the dense decoder behind it) and
    decoder='device-uf' at d = 3, 5 (B=2^15), each against the host
    decode of the same model; (b) the op set on the surgery tier
    (`run_full`, both sectors: CNOT(0,1); T(1); CNOT(1,2), standalone s,
    mx, the feedback program) at d = 3, 5; (c) the circuit tier
    (`run_circuit`: the frame sampler, BP and the device OSD) for the
    compiled CNOT at d = 3, 5 and HZH and the feedback program at d=3;
    (d) the two-level memory (d=3, k=3, rounds_l=3, p=q=4e-3),
    decoder='device-uf' and 'host'; (e) the protocol gold on the card's
    tableau; (f) resource reports on (a)'s and (b)'s points. K1's and
    K2's launches are counted over (a)-(e). Then, outside the count, K2
    on the sparse run's rep-0 detectors (d=3, B=2^15, the hybrid's d_max)
    and K1 on the two-level device run's rep-0 level-2 rows (B=8192)
    against their plain versions, timed. Returns the rows and the
    kernels' entries."""
    import numpy as np
    import torch

    from qcss_tpu_torch.benchmarks import measure_sparse_bench as msb
    from qcss_tpu_torch.benchmarks.profiling import cuda_ms
    from qcss_tpu_torch.decode import device_sparse as dsp
    from qcss_tpu_torch.decode import device_sparse_cuda, device_uf_cuda
    from qcss_tpu_torch.decode import device_uf as duf
    from qcss_tpu_torch.experiments import concatenated, patches, resources
    from qcss_tpu_torch.experiments.protocol import run_compiled_protocol
    from qcss_tpu_torch.sim.noise import NoiseModel, chunk_generators

    t_path = time.perf_counter()
    device_uf_cuda.launches = device_uf_cuda.chunk_launches = 0
    device_sparse_cuda.launches = 0
    out = {}

    def counts():
        return device_uf_cuda.launches, device_sparse_cuda.launches

    def timed(fn):
        """fn() with the wall seconds, peak memory (GiB) and K1 / K2
        launches it took."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        k1, k2 = counts()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        r["wall_s"] = time.perf_counter() - t0
        r["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
        r["k1_launches"] = device_uf_cuda.launches - k1
        r["k2_launches"] = device_sparse_cuda.launches - k2
        return r

    def seconds(prof):
        return ", ".join(f"{k} {v:.3f}" for k, v in prof.items())

    # (a)
    t_part = time.perf_counter()
    p, B, reps = LOGICAL_CNOT
    cnot = {d: _logical_program("cnot", d) for d in LOGICAL_DENSE_D}
    fused, host = {}, {}
    for d in LOGICAL_DENSE_D:
        prof = {}
        r = timed(lambda: cnot[d].run(p, batch=B, seed=LOGICAL_SEED + 1,
                                      device=dev, profile=prof))
        r["split_s"] = prof
        r["failures"] = round(r["word_fail"] * B)
        host[d] = r
        ok, spread = two_sample_ok(r["failures"], B,
                                   round(LOGICAL_CNOT_REF[d] * B), B)
        log(f"path 11 (a): compiled CNOT d={d} decoder='host' p=q={p} "
            f"B={B}: word failures {r['failures']} ({r['word_fail']:.6f}; "
            f"BASELINE.md {LOGICAL_CNOT_REF[d]}, allowed difference "
            f"{spread:.6f}); {r['detectors']} detectors; wall "
            f"{r['wall_s']:.3f} s ({seconds(prof)}); peak "
            f"{r['peak_mem_gb']:.3f} GiB")
        if not ok:
            raise RuntimeError(f"the compiled CNOT at d={d} disagrees with "
                               f"BASELINE.md's rate")
    runs = [("sparse", 3, "device-uf-sparse", reps)] + [
        ("dense", d, "device-uf", 1) for d in LOGICAL_DENSE_D]
    for kind, d, decoder, n in runs:
        model = cnot[d].build()
        prof = {}
        # the first call builds the model's runner; bench.py warms the
        # sparse run with the same reps
        first = timed(lambda: cnot[d].run(p, batch=B, seed=0,
                                          decoder=decoder, reps=n,
                                          device=dev, profile=prof))
        r = timed(lambda: cnot[d].run(p, batch=B, seed=LOGICAL_SEED,
                                      decoder=decoder, reps=n, device=dev))
        r["first_call_s"] = first["wall_s"]
        r["first_call_split_s"] = prof
        r["shots_per_sec"] = r["samples"] / r["wall_s"]
        r["failures"] = round(r["word_fail"] * r["samples"])
        r["k1_launches"] += first["k1_launches"]
        r["k2_launches"] += first["k2_launches"]
        r["mean_defects"], r["d_max"] = patches._hybrid_load(model, p, p)
        r["k1_route"] = _k1_route(duf, model.graph)
        fused[f"{kind} d={d}"] = r
        ok, spread = two_sample_ok(r["failures"], r["samples"],
                                   host[d]["failures"], B)
        log(f"path 11 (a): compiled CNOT d={d} decoder='{decoder}' p=q={p} "
            f"B={B} x {n}: {r['shots_per_sec']:.1f} shots/s ({r['wall_s']:.3f} "
            f"s; first call {first['wall_s']:.3f} s: {seconds(prof)}); word "
            f"failures {r['failures']} ({r['word_fail']:.6f}) against the "
            f"host decode's {host[d]['failures']} of {B} (allowed difference "
            f"{spread:.6f}); mean defects {r['mean_defects']:.2f} (d_max "
            f"rule {r['d_max']}); K1 launches {r['k1_launches']}, K2 "
            f"launches {r['k2_launches']}; peak {r['peak_mem_gb']:.3f} GiB")
        if not ok:
            raise RuntimeError(f"the fused '{decoder}' pipeline at d={d} "
                               f"disagrees with the host decode")
        if kind == "sparse" and r["k2_launches"] < 2 * n:
            raise RuntimeError("the sparse compiled CNOT did not launch K2")
        if r["k1_route"] is None and kind == "dense" \
                and r["k1_launches"] < 2 * n:
            raise RuntimeError(f"the dense compiled CNOT at d={d} did not "
                               f"launch K1")
        if r["k1_route"] is not None:
            log(f"path 11 (a): K1 is not launched by the compiled CNOT at "
                f"d={d} ({kind}): it decodes in {r['k1_route']}, as in the "
                f"reference (device_uf.py:170-186)")
    out["cnot"] = {"host": {f"d={d}": r for d, r in host.items()},
                   "fused": fused, "wall_s": time.perf_counter() - t_part}

    # (b)
    t_part = time.perf_counter()
    ops, ops_progs = {}, {}
    for name, _, batch, refs in LOGICAL_OPS:
        for d in (3, 5):
            prog = _logical_program(name, d)
            ops_progs[(name, d)] = prog
            prof = {}
            r = timed(lambda: prog.run_full(LOGICAL_OPS_P, batch=batch,
                                            seed=LOGICAL_SEED, device=dev,
                                            profile=prof))
            r["split_s"] = prof
            r["failures"] = {k: round(v * batch) for k, v in r.items()
                             if k.endswith("_fail")}
            ops[f"{name} d={d}"] = r
            log(f"path 11 (b): {name} d={d} run_full p=q={LOGICAL_OPS_P} "
                f"B={batch}: failures " + ", ".join(
                    f"{k} {n} ({r[k]:.6f}"
                    + (f"; BASELINE.md {refs[k][d == 5]}" if k in refs
                       else "") + ")" for k, n in r["failures"].items())
                + f"; detectors {r['detectors_z']} + "
                f"{r.get('detectors_x', 0)}; wall {r['wall_s']:.3f} s "
                f"({seconds(prof)}); peak {r['peak_mem_gb']:.3f} GiB")
            if not 0.0 <= r["word_fail"] < 0.2:
                raise RuntimeError(f"implausible run_full row {name} d={d}")
        if not ops[f"{name} d=5"]["word_fail"] < ops[f"{name} d=3"][
                "word_fail"]:
            raise RuntimeError(f"{name}: the d=5 word failure is not below "
                               f"the d=3 one")
    out["op_set"] = ops
    out["op_set_wall_s"] = time.perf_counter() - t_part

    # (c)
    t_part = time.perf_counter()
    pc = LOGICAL_CIRCUIT_P
    noise = NoiseModel(p_gate1=pc, p_gate2=pc, p_meas=pc, p_reset=pc)
    circ = {}
    for name, d, batch, ref in LOGICAL_CIRCUIT:
        prog = _logical_program(name, d)
        prof = {}
        r = timed(lambda: prog.run_circuit(noise, batch=batch,
                                           seed=LOGICAL_SEED, device=dev,
                                           profile=prof))
        r["split_s"] = prof
        circ[f"{name} d={d}"] = r
        moved = ("above" if r["word_fail"] > ref else "at or below")
        log(f"path 11 (c): {name} d={d} run_circuit uniform p={pc} "
            f"B={batch}: word_fail {r['word_fail']:.6f} ({moved} BASELINE.md"
            f"'s {ref}); " + ", ".join(
                f"{k} {v:.6f}" for k, v in r.items()
                if k.endswith("_fail") and k != "word_fail")
            + f"; bp_converged {r.get('bp_converged', 1.0):.6f}"
            + (f" / x {r['bp_converged_x']:.6f}" if "bp_converged_x" in r
               else "")
            + f"; detectors {r.get('detectors')} (x {r.get('detectors_x')}),"
            f" fault variables {r.get('fault_vars')} (x "
            f"{r.get('fault_vars_x')}); wall {r['wall_s']:.3f} s "
            f"({seconds(prof)}); peak {r['peak_mem_gb']:.3f} GiB")
        if not 0.0 <= r["word_fail"] < 0.05 or min(
                r.get("bp_converged", 1.0), r.get("bp_converged_x", 1.0)) < 0.5:
            raise RuntimeError(f"implausible circuit-tier row {name} d={d}")
        if name == "cnot":
            # one sector (the repaired init injection does not touch it)
            k_got, k_ref = round(r["word_fail"] * batch), round(ref * batch)
            ok, spread = two_sample_ok(k_got, batch, k_ref, batch)
            log(f"path 11 (c): cnot d={d}: {k_got} word failures against "
                f"BASELINE.md's {k_ref} of {batch} (allowed difference "
                f"{spread:.6f})")
            if not ok:
                raise RuntimeError(f"the circuit-tier CNOT at d={d} "
                                   f"disagrees with BASELINE.md's rate")
    out["circuit"] = circ
    out["circuit_wall_s"] = time.perf_counter() - t_part

    # (d)
    t_part = time.perf_counter()
    tl_d, tl_k, tl_rl, tl_p = LOGICAL_TWO_LEVEL
    _, model_l1, perm = concatenated._build_program(tl_d, tl_k, tl_rl)
    graph_l2 = concatenated.repetition_spacetime_graph(tl_k, tl_rl + 1)
    routes = {"level 1": _k1_route(duf, model_l1.graph),
              "level 2": _k1_route(duf, graph_l2)}
    two = {}
    for decoder, batch, n, (r1, r2) in LOGICAL_TWO_LEVEL_RUNS:
        r = timed(lambda: concatenated.logical_repetition_memory(
            tl_d, tl_k, tl_rl, tl_p, batch=batch, reps=n, seed=LOGICAL_SEED,
            decoder=decoder, device=dev))
        two[decoder] = r
        log(f"path 11 (d): two-level memory d={tl_d} k={tl_k} rounds_l="
            f"{tl_rl} p=q={tl_p} decoder='{decoder}' {r['samples']} shots: word_fail "
            f"l1 {r['word_fail_l1']:.6f} -> l2 {r['word_fail_l2']:.6f} "
            f"(BASELINE.md {r1} -> {r2}); wall {r['wall_s']:.3f} s; K1 "
            f"launches {r['k1_launches']}; peak {r['peak_mem_gb']:.3f} GiB")
        if not r["word_fail_l2"] < r["word_fail_l1"] / 3:
            raise RuntimeError(f"two-level '{decoder}': level 2 does not "
                               f"correct")
    for lvl, why in routes.items():
        log(f"path 11 (d): {lvl} of the device run decodes in "
            + ("K1 (a stencil graph)" if why is None else why))
    if routes["level 2"] is None and two["device-uf"]["k1_launches"] < \
            LOGICAL_TWO_LEVEL_RUNS[0][2]:
        raise RuntimeError("the two-level device run did not launch K1 on "
                           "its level-2 graph")
    two["k1_routes"] = routes
    two["wall_s"] = time.perf_counter() - t_part
    out["two_level"] = two

    # (e)
    t_part = time.perf_counter()
    prog = _logical_program("cnot", 3)
    model = prog.build(with_recipe=True)
    recipe = model.meta["recipe"]
    gold = []
    for zc, zt, seed in LOGICAL_PROTOCOL:
        flips = []   # X̄ on data patch i: its block's first column
        for i, on in ((0, zc), (1, zt)):
            r0, c0 = prog._origin((0, 2 * i))
            if on:
                flips += [(r0 + r) * prog.cols_q + c0 for r in range(3)]
        t0 = time.perf_counter()
        o = run_compiled_protocol(
            prog, model, torch.Generator(device=dev).manual_seed(seed),
            prep_x_flips=flips, device=dev).astype(np.int64)
        wall = time.perf_counter() - t0
        n_dets = int(((recipe["D"].astype(np.int64) @ o) & 1).sum())
        vals = dict(zip(model.meta["obs_names"],
                        ((recipe["obs"].astype(np.int64) @ o) & 1).tolist()))
        gold.append({"zc": zc, "zt": zt, "seed": seed, "dets_fired": n_dets,
                     **vals, "wall_s": wall})
        log(f"path 11 (e): protocol gold, compiled CNOT d=3 on the card's "
            f"tableau, zc={zc} zt={zt} (generator seed {seed}): "
            f"{n_dets} detectors fired, z0={vals['z0']} z1={vals['z1']}; "
            f"{wall:.3f} s")
        if n_dets or vals["z0"] != zc or vals["z1"] != zt ^ zc:
            raise RuntimeError(f"protocol gold fails at zc={zc} zt={zt}")
    out["protocol"] = {"runs": gold, "wall_s": time.perf_counter() - t_part}

    out["k1_launches"], out["k2_launches"] = counts()
    out["k1_chunk_launches"] = device_uf_cuda.chunk_launches
    log(f"main path 11 launches: stencil kernel {out['k1_launches']} "
        f"({out['k1_chunk_launches']} with chunks), sparse kernel "
        f"{out['k2_launches']}")
    if out["k1_launches"] <= 0 or out["k2_launches"] <= 0:
        raise RuntimeError("path 11 did not launch K1 and K2")

    # (f) resource reports on (a)'s and (b)'s points (the programs built
    # above: their models are memoized)
    reports = {}
    for label, progs, fails in (
            ("compiled CNOT", cnot,
             {d: host[d]["word_fail"] for d in LOGICAL_DENSE_D}),
            ("CNOT(0,1); T(1); CNOT(1,2)",
             {d: ops_progs[("cnot01_t1_cnot12", d)] for d in (3, 5)},
             {d: ops[f"cnot01_t1_cnot12 d={d}"]["word_fail"]
              for d in (3, 5)})):
        rep = resources.logical_resource_report(
            progs.__getitem__, LOGICAL_CNOT[0], target=1.5 * fails[5],
            fails=fails)
        rep["d_for_1e-9"] = resources.required_distance(1e-9, rep["fit"])
        reports[label] = rep
        st = rep["at_d_star"]
        log(f"path 11 (f): {label}: Lambda {rep['fit']['Lambda']:.3f} from "
            f"{fails}; d* {rep['d_star']} for a budget of "
            f"{rep['target']:.6f} ({st['grid_qubits']} grid qubits, "
            f"{st['total_rounds']} rounds, spacetime volume "
            f"{st['spacetime_volume']}, {st['fault_locations']} fault "
            f"locations, T count {st['t_count']}); extrapolated d for a "
            f"1e-9 budget {rep['d_for_1e-9']}")
    out["resources"] = reports
    out["wall_s"] = time.perf_counter() - t_path
    log(f"path 11 wall {out['wall_s']:.1f} s")

    # K2 and K1 against their plain versions bit for bit, timed, on the
    # rows of the first rep of the runs that launched them (these launches
    # are not the path's): K2 on the sparse compiled CNOT's d=3 detectors
    # at the hybrid's d_max and batch, K1 on the two-level device run's
    # level-2 rows
    model3 = cnot[3].build()
    tables = dsp.build_sparse_tables(model3.graph)
    # the hybrid's d_max, capped as `sparse_decoder_from_tables` caps it
    d_max = min(fused["sparse d=3"]["d_max"], tables.num_nodes)
    tables = dsp._tables_to(tables, dev)
    gen = chunk_generators(LOGICAL_SEED, 1, dev)[0]
    dets3, _ = patches._sample(gen, p, p, B,
                               *patches._model_tensors(model3, dev))
    k2 = msb.k2_row(tables, dets3, 20, int_ops_per_s, d_max=d_max)
    log(f"K2 at the sparse compiled CNOT's shape B={B} V={dets3.shape[1]} "
        f"d_max={d_max} (its rep 0's detectors): == plain; wrapper "
        f"{k2['ms']:.4f} ms, a launch in a graph {k2['hot_ms']:.4f} hot, "
        f"{k2['cold_ms']:.4f} cold; plain {k2['plain_ms']:.3f} ms; bound "
        f"{k2['bound_ms']:.4f} ms ({k2['bound_by']}); defects a shot "
        f"{k2['defects_per_shot']}; plan {k2['plan']}")
    batch2, n2 = LOGICAL_TWO_LEVEL_RUNS[0][1:3]
    _, level2, _ = concatenated._two_level_pipeline(
        tl_d, tl_k, tl_rl, tl_p, tl_p, batch=batch2, layout="chain",
        device=dev)
    dets2 = level2(chunk_generators(LOGICAL_SEED, n2, dev)[0])[1]
    dg2 = duf.build_device_graph(graph_l2).to(dev)
    defect = duf.stencil_defect(dg2, dets2)
    k1_err = k1_equal(duf, device_uf_cuda, dg2, defect,
                      "on the two-level memory's level-2 rows")[0]
    rows, V2 = defect.shape
    label = (f"B={rows} V={V2} O={len(dg2.stencil.deltas)} "
             f"KB={dg2.stencil.bmask.shape[0]} NC=0")
    k1_ms = cuda_ms(lambda: device_uf_cuda.stencil_full(dg2, defect), 20)
    k1_plain_ms = cuda_ms(lambda: duf._stencil_plain(dg2, defect), 2)
    plan, need, bnd = k1_report(f"{label} (two-level memory, level 2)",
                                device_uf_cuda, dg2, defect,
                                int_ops_per_s)
    log(f"K1 on the level-2 graph {label}, deltas {dg2.stencil.deltas}: == "
        f"plain (packed, act, labels, converged) on the device run's rep 0 "
        f"({int(dets2.sum())} defects over {rows} shots); kernel "
        f"{k1_ms:.4f} ms, plain {k1_plain_ms:.3f} ms, bound {bnd[0]:.4f} "
        f"ms ({bnd[1]})")
    by_run = {k: {"k1": r["k1_launches"], "k2": r["k2_launches"]}
              for k, r in fused.items()}
    by_run["two-level device-uf"] = {
        "k1": two["device-uf"]["k1_launches"],
        "k2": two["device-uf"]["k2_launches"]}
    out["kernels"] = {
        "K1": {"shape": f"{label} (two-level memory, level 2, path 11 (d))",
               "launches": out["k1_launches"],
               "by_run": {k: v["k1"] for k, v in by_run.items()},
               "not_launched": {k: r["k1_route"] for k, r in fused.items()
                                if r["k1_route"] is not None},
               "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
               "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
               "plan": plan, "work": need},
        "K2": {"shape": f"B={B} V={dets3.shape[1]} d_max={d_max} "
                        f"(sparse compiled CNOT d=3, path 11 (a))",
               "launches": out["k2_launches"],
               "by_run": {k: v["k2"] for k, v in by_run.items()},
               "max_abs_err": 0,
               **{k: k2[k] for k in (
                   "ms", "host_ms", "hot_ms", "cold_ms", "plain_ms",
                   "bound_ms", "bound_by", "library_ms", "bytes", "int_ops",
                   "defects_per_shot", "events_per_shot", "sweeps_per_shot",
                   "plan")}}}
    return out



def path12(dev, int_ops_per_s, smi):
    """Main path 12, the FT transpiler (`rewrite_program` on the
    'unpacked' and 'packed' tableau engines; the packed engine's block
    measurements and resets run K9): (a) exact outcomes, (b) the engines
    bit for bit under the executor's channels, (c) failure rates against
    the JAX package's count, (d) the flagship bench, (e) K9's launches and
    K9 on the path's own states (module docstring). Returns the `ftqc`
    JSON object and K9's path-12 entry."""
    import numpy as np
    import torch

    from qcss_tpu_torch.benchmarks import ftqc_programs as fp
    from qcss_tpu_torch.benchmarks import measure_sparse_bench as msb
    from qcss_tpu_torch.codes import families
    from qcss_tpu_torch.ftqc import rewrite_program, schedule
    from qcss_tpu_torch.sim import cuda_measure
    from qcss_tpu_torch.sim import tableau as tb
    from qcss_tpu_torch.sim.noise import NoiseModel

    out = {"card": smi}
    launches = dict.fromkeys(FTQC_ENGINES, 0)

    def counted(tableau, fn):
        n0 = cuda_measure.launches
        res = fn()
        launches[tableau] += cuda_measure.launches - n0
        return res

    cuda_measure.launches = 0
    t_path = time.perf_counter()

    # -- (a) exact outcomes on the card
    gold, gold_by_program = {}, {}
    for tableau in FTQC_ENGINES:
        t0 = time.perf_counter()
        by_program = gold_by_program[tableau] = {}
        for name, spec in fp.PROGRAMS.items():
            t1 = time.perf_counter()
            prog, code = fp.build(name)
            enc = rewrite_program(prog, code, tableau=tableau, device=dev,
                                  **spec.options)
            res = counted(tableau, lambda: enc.run(FTQC_GOLD_BATCH, 0))
            prep_fail = int(res["__prep_fail__"].sum())
            if not spec.gold(res) or prep_fail:
                raise RuntimeError(
                    f"{name} ({spec.source}) on '{tableau}': outcomes "
                    f"{np.unique(res['ro'], axis=0)} miss the gold, or "
                    f"{prep_fail} prep_fail shots")
            if name in ("ghz4", "feedback") and not \
                    0 < res["ro"][:, 0].mean() < 1:
                raise RuntimeError(f"{name}: the first measurement is not "
                                   f"random")
            by_program[name] = round(time.perf_counter() - t1, 3)
        gold[tableau] = time.perf_counter() - t0
        log(f"path 12 (a) '{tableau}': {len(fp.PROGRAMS)} programs at "
            f"B={FTQC_GOLD_BATCH}, every outcome its gold, prep_fail 0 "
            f"({gold[tableau]:.1f} s; by program {by_program})")
    out["gold_s"] = gold
    out["gold_s_by_program"] = gold_by_program

    # -- (b) the engines bit for bit under the executor's channels
    t_part = time.perf_counter()
    eq_noise = NoiseModel(p_meas=FTQC_EQ_P, p_reset=FTQC_EQ_P,
                          p_idle=FTQC_EQ_P)
    out["equal"] = {}
    for name, options in FTQC_EQ_RUNS:
        prog, code = fp.build(name)
        macro = schedule.lower(prog, code)
        states = {}
        for tableau in FTQC_ENGINES:
            ex = schedule.MacroExecutor(code, macro.n_logical, eq_noise,
                                        tableau_engine=tableau, device=dev,
                                        **options)
            states[tableau] = counted(tableau, lambda: ex.execute(
                macro, FTQC_EQ_BATCH, seed=7))
        a, b = (states[k] for k in FTQC_ENGINES)
        for field in ("memory", "prep_fail", "x_frames", "z_frames"):
            if not torch.equal(getattr(a, field), getattr(b, field)):
                raise RuntimeError(f"{name} {options}: the engines' {field} "
                                   f"differ under the executor's channels")
        key = name + "".join(f" {k}={v}" for k, v in options.items())
        out["equal"][key] = {
            "frame_bits": int(a.x_frames.sum() + a.z_frames.sum()),
            "prep_fail": int(a.prep_fail.sum())}
        if not out["equal"][key]["frame_bits"]:
            raise RuntimeError(f"{key}: the channels left no frame bit")
        log(f"path 12 (b) {key} B={FTQC_EQ_BATCH}, p_meas=p_reset=p_idle="
            f"{FTQC_EQ_P}: unpacked == packed (registers, prep_fail, frames;"
            f" {out['equal'][key]})")

    out["equal_s"] = time.perf_counter() - t_part

    # -- (c) failure rates against the JAX package's count
    steane = families.steane()
    rate_noise = NoiseModel(p_gate1=FTQC_RATE_P, p_gate2=FTQC_RATE_P,
                            p_meas=FTQC_RATE_P)
    ref_fail, ref_prep, ref_n = FTQC_RATE_REF
    out["rates"] = {}
    for tableau in FTQC_ENGINES:
        enc = rewrite_program(fp.x_program(), steane, noise=rate_noise,
                              tableau=tableau, device=dev)
        t0 = time.perf_counter()
        res = counted(tableau, lambda: enc.run(FTQC_RATE_BATCH, 3))
        dt = time.perf_counter() - t0
        fails = int((res["ro"][:, 0] != 1).sum())
        prep = int(res["__prep_fail__"].sum())
        ok_f, spread_f = two_sample_ok(fails, FTQC_RATE_BATCH, ref_fail,
                                       ref_n)
        ok_p, spread_p = two_sample_ok(prep, FTQC_RATE_BATCH, ref_prep, ref_n)
        out["rates"][tableau] = {"fail": fails, "prep_fail": prep,
                                 "batch": FTQC_RATE_BATCH, "s": dt}
        log(f"path 12 (c) '{tableau}' noisy Steane X B={FTQC_RATE_BATCH}: "
            f"{fails} failures ({fails / FTQC_RATE_BATCH:.5f}; the JAX "
            f"package {ref_fail / ref_n:.5f}, allowed difference "
            f"{spread_f:.5f}), prep_fail {prep} ({prep / FTQC_RATE_BATCH:.5f};"
            f" {ref_prep / ref_n:.5f}, {spread_p:.5f}); {dt:.2f} s")
        if not (ok_f and ok_p and fails > 0):
            raise RuntimeError(f"'{tableau}': the noisy X program's rates "
                               f"disagree with the JAX package's")

    # -- (d) the flagship bench: benchmarks/ftqc_bench.py's X program
    out["bench"] = {}
    for code_name in FTQC_BENCH_CODES:
        code = fp.CODES[code_name](families)
        for tableau in FTQC_ENGINES:
            enc = rewrite_program(fp.x_program(), code, tableau=tableau,
                                  device=dev)

            def once(seed, enc=enc, tableau=tableau):
                return int(counted(tableau, lambda: enc.run(
                    FTQC_BENCH_BATCH, seed))["ro"].sum())  # host fence

            t0 = time.perf_counter()
            once(100)
            once(101)
            warm = time.perf_counter() - t0
            t0 = time.perf_counter()
            correct = sum(once(i + 1) for i in range(3))
            dt = time.perf_counter() - t0
            row = {"shots_per_sec": 3 * FTQC_BENCH_BATCH / dt,
                   "correct_fraction": correct / (3 * FTQC_BENCH_BATCH),
                   "timed_s": dt, "warm_s": warm, "n": code.n, "t": code.t}
            out["bench"][f"{code_name} {tableau}"] = row
            log(f"path 12 (d) ftqc_bench {code_name} (n={code.n}, t={code.t})"
                f" '{tableau}' B={FTQC_BENCH_BATCH}: "
                f"{row['shots_per_sec']:.1f} shots/s, correct fraction "
                f"{row['correct_fraction']} ({dt:.3f} s for 3 calls; "
                f"{smi})")
            if row["correct_fraction"] != 1.0:
                raise RuntimeError(f"ftqc_bench {code_name} '{tableau}': "
                                   f"noiseless outcomes not all 1")

    # -- (e) K9: the states this path measures, caught at the packed X
    #    program's last block measurement (an ancilla block), then K9's
    #    launches over the path
    states = {}
    for code_name in FTQC_BENCH_CODES:
        code = fp.CODES[code_name](families)
        macro = schedule.lower(fp.x_program(), code)
        ex = schedule.MacroExecutor(code, 1, tableau_engine="packed",
                                    device=dev)
        measure = ex.engine.measure_block
        seen = []

        def spy(tab, b, generator=None, *, rand_bits=None, seen=seen,
                measure=measure):
            seen[:] = [(tab, b)]
            return measure(tab, b, generator, rand_bits=rand_bits)

        ex.engine.measure_block = spy
        counted("packed", lambda: ex.execute(macro, FTQC_BENCH_BATCH,
                                             seed=11))
        tab, b = seen[0]
        states[code_name] = (tab, ex.engine.block_qubits(b))
    out["path_s"] = time.perf_counter() - t_path
    out["k9_launches"] = dict(launches)
    log(f"path 12 launches: K9 {launches} ({out['path_s']:.1f} s)")
    if launches["packed"] <= 0 or launches["unpacked"] != 0:
        raise RuntimeError(f"K9 launches over path 12 {launches}: above 0 on "
                           f"'packed' and 0 on 'unpacked' expected")
    rows = {}
    for code_name, (tab, qs) in states.items():
        bits = tb.collapse_bits(torch.Generator(device=dev).manual_seed(12),
                                tab.batch, len(qs))
        row = msb.k9_row({"t": tab, "qubits": qs, "bits": bits,
                          "branch": f"path 12, {code_name}"}, 20,
                         int_ops_per_s)
        rows[code_name] = row
        log(f"K9 at path 12's {code_name} state (B={row['B']} n={row['n']} "
            f"W={row['W']} M={row['M']}, {row['random_share']:.3f} of the "
            f"outcomes random): == plain (outcomes, x, z, r); wrapper "
            f"{row['ms']:.4f} ms, a launch in a graph {row['hot_ms']:.4f} "
            f"hot, {row['cold_ms']:.4f} cold; plain {row['plain_ms']:.3f} "
            f"ms; bound {row['bound_ms']:.4f} ms ({row['bound_by']}); plan "
            f"{row['plan']}")
    keep = ("ms", "host_ms", "hot_ms", "cold_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "random_share", "int_ops", "plan")
    k9 = {"launches": launches["packed"], "by_engine": dict(launches),
          "max_abs_err": 0,
          **{code_name: {"shape": f"B={r['B']} n={r['n']} W={r['W']} "
                                  f"M={r['M']} (path 12, {code_name} X "
                                  f"program, an ancilla block)",
                         **{k: r[k] for k in keep}}
             for code_name, r in rows.items()}}
    return out, k9


def path13(dev, smi, ftqc12):
    """Main path 13, the Pauli-frame FT engine (`rewrite_program(...,
    tableau='frames')`, `FrameEngine`) and parallel EC, with K9 launched
    by none of it: (a) the golds on 'frames' and the refusals against the
    JAX package's set, (b) frames against unpacked bit for bit under
    noise, (c) parallel against serial EC under idle noise and against
    the JAX package's counts, (d) `ftqc_bench` and `idle_bench`, (e) K9's
    launches (0), the seconds by part, peak memory and frames' shots/s
    beside path 12's rows (module docstring). Returns the `ftqc_frames`
    JSON object."""
    import numpy as np
    import torch

    from qcss_tpu_torch.benchmarks import ftqc_bench, idle_bench
    from qcss_tpu_torch.benchmarks import ftqc_programs as fp
    from qcss_tpu_torch.circuits import Program
    from qcss_tpu_torch.codes import families
    from qcss_tpu_torch.errors import UnsupportedProgramError
    from qcss_tpu_torch.ftqc import rewrite_program, schedule
    from qcss_tpu_torch.sim import cuda_measure
    from qcss_tpu_torch.sim.noise import NoiseModel

    out = {"card": smi}
    seconds = {}
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_measure.launches = 0
    t_path = time.perf_counter()

    # -- (a) the golds on 'frames', and the programs it refuses
    t_part = time.perf_counter()
    refused, by_program = {}, {}
    for name, spec in {**fp.PROGRAMS, **fp.FRAMES_PROGRAMS}.items():
        t1 = time.perf_counter()
        prog, code = fp.build(name)
        try:
            enc = rewrite_program(prog, code, tableau="frames", device=dev,
                                  **spec.options)
            res = enc.run(FRAMES_GOLD_BATCH, 0)
        except UnsupportedProgramError as exc:
            refused[name] = str(exc)
            continue
        prep_fail = int(res["__prep_fail__"].sum())
        if not spec.gold(res) or prep_fail:
            raise RuntimeError(
                f"{name} ({spec.source}) on 'frames': outcomes "
                f"{np.unique(res['ro'], axis=0)} miss the gold, or "
                f"{prep_fail} prep_fail shots")
        by_program[name] = round(time.perf_counter() - t1, 3)
    want = fp.FRAMES_REFUSED
    log(f"path 13 (a) 'frames': {len(by_program)} programs at "
        f"B={FRAMES_GOLD_BATCH}, every outcome its gold, prep_fail 0 (by "
        f"program {by_program}); refused here {sorted(refused)}, by the JAX "
        f"package {sorted(want)}")
    if sorted(refused) != sorted(want) or any(
            want[k] not in refused[k] for k in want):
        raise RuntimeError(f"'frames' refuses {refused}; the JAX package "
                           f"refuses {want}")
    out["golds"] = {"programs": sorted(by_program), "refused": sorted(refused),
                    "refused_by_jax": sorted(want), "s_by_program": by_program}
    seconds["a_golds"] = time.perf_counter() - t_part

    # -- (b) frames against unpacked, bit for bit, on one seed
    t_part = time.perf_counter()
    steane = families.steane()
    macro = schedule.lower(fp.x_program(), steane)
    refs = schedule.reference_outcomes(macro, steane, device=dev)
    out["equal"] = {}
    for label, rates, options in FRAMES_EQ_RUNS:
        states = {}
        for tableau in ("frames", "unpacked"):
            ex = schedule.MacroExecutor(steane, 1, NoiseModel(**rates),
                                        tableau_engine=tableau, device=dev,
                                        **options)
            states[tableau] = ex.execute(
                macro, FRAMES_EQ_BATCH, seed=11,
                ref_outs=refs if tableau == "frames" else None)
        f, u = states["frames"], states["unpacked"]
        for field in ("memory", "prep_fail", "x_frames", "z_frames",
                      "votes"):
            if not torch.equal(getattr(f, field), getattr(u, field)):
                raise RuntimeError(f"path 13 (b) {label}: frames and unpacked"
                                   f" differ in {field}")
        row = {"shots_with_frame": int((f.tab.x.any(1) | f.tab.z.any(1))
                                       .sum()),
               "frame_bits": int(f.x_frames.sum() + f.z_frames.sum()),
               "failures": int((f.memory[:, 0] != 1).sum()),
               "prep_fail": int(f.prep_fail.sum())}
        out["equal"][label] = row
        log(f"path 13 (b) {label} {rates} {options} B={FRAMES_EQ_BATCH}: "
            f"frames == unpacked (registers, prep_fail, frames, votes); "
            f"{row}")
        if not row["shots_with_frame"]:
            raise RuntimeError(f"path 13 (b) {label}: no shot carries a "
                               f"fault")
    seconds["b_equal"] = time.perf_counter() - t_part

    # -- (c) parallel EC against serial under idle noise
    t_part = time.perf_counter()
    two = Program()
    ro = two.declare("ro", 2)
    two.x(0).x(1).measure(0, ro[0]).measure(1, ro[1])
    noise = NoiseModel(p_gate2=FRAMES_PAR_NOISE[0], p_idle=FRAMES_PAR_NOISE[1])
    fails = {}
    for sched in ("parallel", "serial"):
        res = rewrite_program(two, steane, noise=noise, tableau="frames",
                              ancillas="dedicated", ec_schedule=sched,
                              device=dev).run(FRAMES_PAR_BATCH, 2)
        fails[sched] = int((res["ro"] != [1, 1]).any(axis=1).sum())
    ref_p, ref_s, ref_n = FRAMES_PAR_REF
    checks = {s: two_sample_ok(fails[s], FRAMES_PAR_BATCH, r, ref_n)
              for s, r in (("parallel", ref_p), ("serial", ref_s))}
    quiet = rewrite_program(two, steane, tableau="frames",
                            ancillas="dedicated", ec_schedule="parallel",
                            device=dev).run(FRAMES_GOLD_BATCH, 3)
    out["parallel_ec"] = {"fails": fails, "batch": FRAMES_PAR_BATCH,
                          "jax": {"parallel": ref_p, "serial": ref_s,
                                  "batch": ref_n}}
    log(f"path 13 (c) two-block X, p_gate2={FRAMES_PAR_NOISE[0]} p_idle="
        f"{FRAMES_PAR_NOISE[1]}, dedicated, B={FRAMES_PAR_BATCH}: parallel "
        f"{fails['parallel']}, serial {fails['serial']} failures (the JAX "
        f"package {ref_p} / {ref_s} of {ref_n}; allowed differences "
        f"{checks['parallel'][1]:.5f} / {checks['serial'][1]:.5f}); "
        f"noiseless parallel [1, 1] on {FRAMES_GOLD_BATCH} shots: "
        f"{bool((quiet['ro'] == [1, 1]).all())}")
    if not (fails["parallel"] * 2 < fails["serial"]
            and all(ok for ok, _ in checks.values())
            and (quiet["ro"] == [1, 1]).all()):
        raise RuntimeError(f"path 13 (c): parallel EC {fails} against the "
                           f"JAX package's {FRAMES_PAR_REF}")
    seconds["c_parallel"] = time.perf_counter() - t_part

    # -- (d) the benches: ftqc_bench on 'frames', its EC scaling, idle_bench
    t_part = time.perf_counter()
    out["bench"] = {}
    for code_name in FTQC_BENCH_CODES:
        row = ftqc_bench.bench(fp.CODES[code_name](families), "frames",
                               FTQC_BENCH_BATCH, device=dev)
        out["bench"][code_name] = row
        log(f"path 13 (d) ftqc_bench {code_name} 'frames' "
            f"B={FTQC_BENCH_BATCH}: {3 * FTQC_BENCH_BATCH / row['timed_s']}"
            f" shots/s, correct fraction {row['correct_fraction']} ({smi})")
        if row["correct_fraction"] != 1.0:
            raise RuntimeError(f"ftqc_bench {code_name} 'frames': noiseless "
                               f"outcomes not all 1")
    out["ec_scaling"] = []
    for n_logical in FRAMES_SCALING:
        for sched in ("serial", "parallel"):
            row = ftqc_bench.ec_scaling(n_logical, sched, FTQC_BENCH_BATCH,
                                        device=dev)
            out["ec_scaling"].append(row)
            log(f"path 13 (d) ec_scaling {json.dumps(row)} ({smi})")
            if row["correct_fraction"] != 1.0:
                raise RuntimeError(f"ec_scaling {n_logical} {sched}: "
                                   f"noiseless outcomes not all 1")
    idle = idle_bench.run(NoiseModel(p_gate2=FRAMES_PAR_NOISE[0],
                                     p_idle=FRAMES_PAR_NOISE[1]), device=dev)
    out["idle_bench"] = idle
    for row in idle:
        log(f"path 13 (d) idle_bench {json.dumps(row)} ({smi})")
    by_cfg = {(r["ancillas"], r["ec_schedule"]): r["fails"] for r in idle}
    if not by_cfg[("dedicated", "parallel")] * 2 < \
            by_cfg[("dedicated", "serial")]:
        raise RuntimeError(f"idle_bench: dedicated-parallel {by_cfg} does "
                           f"not halve dedicated-serial's failures")
    seconds["d_benches"] = time.perf_counter() - t_part

    # -- (e) K9 launched by none of it; time split, memory, shots/s beside
    #    path 12's rows of the same bench
    out["k9_launches"] = cuda_measure.launches
    out["seconds"] = {**seconds, "path": time.perf_counter() - t_path}
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["shots_per_sec"] = {
        code_name: {"frames": 3 * FTQC_BENCH_BATCH
                    / out["bench"][code_name]["timed_s"],
                    **{t: ftqc12["bench"][f"{code_name} {t}"]["shots_per_sec"]
                       for t in FTQC_ENGINES}}
        for code_name in FTQC_BENCH_CODES}
    log(f"path 13 (e) K9 launches {out['k9_launches']}; seconds "
        f"{out['seconds']}; peak {out['peak_mem_gb']:.3f} GiB; ftqc_bench "
        f"shots/s (frames here, unpacked and packed from path 12) "
        f"{out['shots_per_sec']} ({smi})")
    if out["k9_launches"] != 0:
        raise RuntimeError(f"K9 launched {out['k9_launches']} times over "
                           f"path 13 (0 expected: frames measure no tableau)")
    return out


def path14(dev, int_ops_per_s, smi):
    """Main path 14, the rest of the FT transpiler: (a) the unrolled
    engine (`rewrite_program(..., engine='unrolled')`, `FTProtocols`):
    golds, refusals against the JAX package's set, unrolled against
    scheduled bit for bit, under idle noise and on an `if_then` program,
    and its shots/s beside the scheduled engine's; (b) flag EC on
    'frames' (`ec_mode='flag'`): noiseless golds on three codes, weight-1
    errors into the frame, the quadratic scaling and the JAX package's
    counts; (c) `flag_bench.py` at its defaults; (d) `fidelity.py`,
    `breakeven_probe.py` and `breakeven.py`, whose 'packed' runs launch
    K9; (e) K9's launches by part, seconds by part, peak memory, then K9
    against its plain version on a state (d) measures (module docstring).
    Returns the `ftqc_rest` JSON object and K9's path-14 entry."""
    import numpy as np
    import torch

    from qcss_tpu_torch.benchmarks import (
        breakeven,
        breakeven_probe,
        fidelity,
        flag_bench,
    )
    from qcss_tpu_torch.benchmarks import ftqc_programs as fp
    from qcss_tpu_torch.benchmarks import measure_sparse_bench as msb
    from qcss_tpu_torch.circuits import Program
    from qcss_tpu_torch.codes import families
    from qcss_tpu_torch.errors import UnsupportedProgramError
    from qcss_tpu_torch.ftqc import engines, rewrite_program, schedule
    from qcss_tpu_torch.ops import gf2
    from qcss_tpu_torch.sim import cuda_measure
    from qcss_tpu_torch.sim import tableau as tb
    from qcss_tpu_torch.sim.noise import NoiseModel

    out = {"card": smi}
    seconds, k9 = {}, {}
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_measure.launches = 0
    t_path = time.perf_counter()

    def part_done(name, t_part):
        seconds[name] = time.perf_counter() - t_part
        k9[name] = cuda_measure.launches - sum(k9.values())

    # -- (a) the unrolled engine: golds and refusals
    t_part = time.perf_counter()
    refused, by_program = {}, {}
    for name, spec in fp.PROGRAMS.items():
        t1 = time.perf_counter()
        prog, code = fp.build(name)
        try:
            enc = rewrite_program(prog, code, engine="unrolled", device=dev,
                                  **spec.options)
        except (ValueError, UnsupportedProgramError) as exc:
            refused[name] = f"{type(exc).__name__}: {exc}"
            continue
        res = enc.run(ROLL_GOLD_BATCH, 0)
        prep_fail = int(res["__prep_fail__"].sum())
        if not spec.gold(res) or prep_fail:
            raise RuntimeError(
                f"{name} ({spec.source}) unrolled: outcomes "
                f"{np.unique(res['ro'], axis=0)} miss the gold, or "
                f"{prep_fail} prep_fail shots")
        by_program[name] = round(time.perf_counter() - t1, 3)
    want = fp.UNROLLED_REFUSED
    log(f"path 14 (a) unrolled: {len(by_program)} programs at "
        f"B={ROLL_GOLD_BATCH}, every outcome its gold, prep_fail 0 (by "
        f"program {by_program}); refused here {sorted(refused)}, by the JAX "
        f"package {sorted(want)}")
    if sorted(refused) != sorted(want) or any(
            want[k] not in refused[k] for k in want):
        raise RuntimeError(f"the unrolled engine refuses {refused}; the JAX "
                           f"package refuses {want}")
    out["golds"] = {"programs": sorted(by_program), "refused": refused,
                    "s_by_program": by_program}

    # unrolled against scheduled on one seed
    def both(name, rates, batch, seed):
        prog, code = fp.build(name)
        noise = NoiseModel(**rates)
        enc = rewrite_program(prog, code, noise=noise, engine="unrolled",
                              device=dev)
        mem, su = enc._execute(batch, seed, None)
        macro = schedule.lower(prog, code)
        ex = schedule.MacroExecutor(code, macro.n_logical, noise, device=dev)
        ss = ex.execute(macro, batch, seed=seed)
        regs = {k: ss.memory[:, off:off + size]
                for k, (off, size) in macro.memory_layout.items()}
        return mem, su, regs, ss, (enc.protocols._splits, ex._splits)

    def failures(regs, name):
        want_bits = {"x": [1], "superdense11": [1, 1]}[name]
        return int((regs["ro"] != torch.tensor(want_bits, device=dev))
                   .any(dim=1).sum())

    out["equal"] = {}
    for label, rates in ROLL_EQ_RUNS:
        for name in ROLL_EQ_PROGRAMS:
            t1 = time.perf_counter()
            mem, su, regs, ss, splits = both(name, rates, ROLL_EQ_BATCH, 11)
            fields = {"registers": all(torch.equal(mem[k], regs[k])
                                       for k in regs),
                      **{f: torch.equal(getattr(su, f), getattr(ss, f))
                         for f in ("prep_fail", "x_frames", "z_frames")}}
            row = {"shots_with_frame": int((su.x_frames.any(2).any(1)
                                            | su.z_frames.any(2).any(1))
                                           .sum()),
                   "failures": failures(mem, name),
                   "prep_fail": int(su.prep_fail.sum()), "splits": splits[0],
                   "s": round(time.perf_counter() - t1, 3)}
            out["equal"][f"{name} {label}"] = row
            log(f"path 14 (a) {name} {rates} B={ROLL_EQ_BATCH}: unrolled == "
                f"scheduled {fields}; {row}")
            if not all(fields.values()) or splits[0] != splits[1]:
                raise RuntimeError(f"path 14 (a) {name} {label}: unrolled "
                                   f"and scheduled differ {fields}, splits "
                                   f"{splits}")
            if not row["shots_with_frame"]:
                raise RuntimeError(f"path 14 (a) {name} {label}: no shot "
                                   f"carries a frame bit")

    # idle noise: the unrolled engine charges no gate-layer idle and idles
    # a block through its own preparation, so the draws shift; rates only
    mem, su, regs, ss, splits = both("x", ROLL_IDLE, ROLL_EQ_BATCH, 12)
    fu, fs = failures(mem, "x"), failures(regs, "x")
    ok, spread = two_sample_ok(fu, ROLL_EQ_BATCH, fs, ROLL_EQ_BATCH)
    out["idle"] = {"failures": {"unrolled": fu, "scheduled": fs},
                   "splits": splits, "batch": ROLL_EQ_BATCH}
    log(f"path 14 (a) X program {ROLL_IDLE} B={ROLL_EQ_BATCH}: unrolled {fu}"
        f", scheduled {fs} failures (allowed difference {spread:.5f}); "
        f"splits {splits}")
    if not ok or not fu + fs:
        raise RuntimeError(f"path 14 (a) under idle noise: {out['idle']}")

    # if_then: the unrolled engine runs the conditional gate's EC on every
    # shot, the scheduled one where the condition holds; they agree on the
    # shots whose condition is 1, and by rate on the rest
    mem, su, regs, ss, splits = both("feedback", ROLL_EQ_RUNS[0][1],
                                     ROLL_EQ_BATCH, 13)
    c = mem["ro"][:, 0] == 1
    same = {"registers": torch.equal(mem["ro"][c], regs["ro"][c]),
            **{f: torch.equal(getattr(su, f)[c], getattr(ss, f)[c])
               for f in ("prep_fail", "x_frames", "z_frames")}}
    fu = int((mem["ro"][:, 1] != 0).sum())
    fs = int((regs["ro"][:, 1] != 0).sum())
    ok, spread = two_sample_ok(fu, ROLL_EQ_BATCH, fs, ROLL_EQ_BATCH)
    differ = int((mem["ro"][~c] != regs["ro"][~c]).any(dim=1).sum())
    out["if_then"] = {"condition_1_shots": int(c.sum()), "equal": same,
                      "failures": {"unrolled": fu, "scheduled": fs},
                      "condition_0_registers_differ": differ,
                      "splits": splits}
    log(f"path 14 (a) feedback {ROLL_EQ_RUNS[0][1]} B={ROLL_EQ_BATCH}: on the "
        f"{int(c.sum())} shots whose condition is 1 unrolled == scheduled "
        f"{same}; ro[1] failures {fu} / {fs} (allowed difference "
        f"{spread:.5f}); {differ} condition-0 shots' registers differ")
    if not all(same.values()) or not ok or splits[0] != splits[1]:
        raise RuntimeError(f"path 14 (a) if_then: {out['if_then']}")

    # shots/s: the X program noiseless on 'unpacked', unrolled against
    # scheduled, 2 warm and 3 timed calls each fenced by its host read
    out["bench"] = {}
    steane = families.steane()
    for engine in ("unrolled", "scheduled"):
        enc = rewrite_program(fp.x_program(), steane, engine=engine,
                              device=dev)

        def once(seed, enc=enc):
            return int(enc.run(ROLL_BENCH_BATCH, seed)["ro"].sum())

        once(100)
        once(101)
        t0 = time.perf_counter()
        correct = sum(once(i + 1) for i in range(3))
        dt = time.perf_counter() - t0
        out["bench"][engine] = {
            "shots_per_sec": 3 * ROLL_BENCH_BATCH / dt, "timed_s": dt,
            "correct_fraction": correct / (3 * ROLL_BENCH_BATCH)}
        log(f"path 14 (a) Steane X {engine} 'unpacked' B={ROLL_BENCH_BATCH}:"
            f" {3 * ROLL_BENCH_BATCH / dt} shots/s, correct fraction "
            f"{correct / (3 * ROLL_BENCH_BATCH)} ({smi})")
        if correct != 3 * ROLL_BENCH_BATCH:
            raise RuntimeError(f"{engine}: noiseless outcomes not all 1")
    part_done("a_unrolled", t_part)

    # -- (b) flag EC on 'frames'
    t_part = time.perf_counter()
    out["flag"] = {"golds": {}, "weight1": {}}
    for code_name in FLAG_CODES:
        code = {"steane": families.steane,
                "surface3": lambda: families.rotated_surface(
                    3, max_table_weight=1),
                "color3": lambda: families.triangular_color(3)}[code_name]()
        prog = Program()
        ro = prog.declare("ro", 2)
        if code.is_transversal("H"):   # test_flags.py:78's program
            prog.x(0).h(1).cnot(1, 0).cnot(1, 0).h(1)
            want_bits = [1, 0]
        else:                           # the rotated surface code has no
            prog.x(0).cnot(0, 1)        # transversal H
            want_bits = [1, 1]
        prog.measure(0, ro[0]).measure(1, ro[1])
        res = rewrite_program(prog, code, tableau="frames", ec_mode="flag",
                              device=dev).run(FLAG_GOLD_BATCH, 0)
        exact = bool((res["ro"] == want_bits).all()
                     and not res["__prep_fail__"].any())
        # weight-1 errors: shot q carries X on data qubit q, shot n + q Z
        ex = schedule.MacroExecutor(code, 1, tableau_engine="frames",
                                    ec_mode="flag", device=dev)
        n = code.n
        st = ex.initial_state(2 * n, 1, seed=1)
        eye = torch.eye(n, dtype=torch.uint8, device=dev)
        zero = torch.zeros_like(eye)
        xf, zf = torch.cat([eye, zero]), torch.cat([zero, eye])
        st = st._replace(tab=ex.engine.inject_block_flips(st.tab, 0, xf, zf))
        st = ex._ec_one_flag(st, 0)
        # exactly where the code's LUT has one weight-1 error a syndrome;
        # else the stabilizer-equivalent one it stores (X errors modulo
        # the rows of H1, Z errors modulo those of H2)
        got = torch.cat([st.x_frames[:, 0], st.z_frames[:, 0]], 1).cpu()
        want_e = torch.cat([xf, zf], 1).cpu()
        exact_rows = int((got == want_e).all(dim=1).sum())
        h1 = np.asarray(code.parity_check_c1, np.uint8) & 1
        h2 = np.asarray(code.parity_check_c2, np.uint8) & 1
        stab = np.block([[h1, np.zeros_like(h1)], [np.zeros_like(h2), h2]])
        equiv = all(gf2.rank(np.concatenate([stab, d[None]]))
                    == gf2.rank(stab)
                    for d in (got ^ want_e).numpy() if d.any())
        distinct = all(len({tuple(c) for c in h.T.tolist()}) == n
                       for h in (h1, h2))
        landed = {"exact": exact_rows, "shots": 2 * n, "equivalent": equiv,
                  "distinct_weight1_syndromes": distinct}
        out["flag"]["golds"][code_name] = {"program": want_bits,
                                           "exact": exact}
        out["flag"]["weight1"][code_name] = landed
        log(f"path 14 (b) flag EC on {code_name} (n={n}): the noiseless "
            f"program {want_bits} at B={FLAG_GOLD_BATCH} exact: {exact}; "
            f"weight-1 X and Z errors after one round {landed}")
        if not exact or not equiv or (distinct and exact_rows != 2 * n):
            raise RuntimeError(f"flag EC on {code_name}: exact {exact}, "
                               f"weight-1 {landed}")
    fails = {}
    for p, (ref_k, ref_n) in FLAG_RATE_REF.items():
        noise = NoiseModel(p_gate1=p, p_gate2=p, p_meas=p, p_reset=p)
        enc = rewrite_program(fp.x_program(), steane, noise=noise,
                              tableau="frames", ec_mode="flag", device=dev)
        t0 = time.perf_counter()
        res = enc.run(FLAG_RATE_BATCH, 2)
        dt = time.perf_counter() - t0
        fails[p] = int((res["ro"][:, 0] != 1).sum())
        ok, spread = two_sample_ok(fails[p], FLAG_RATE_BATCH, ref_k, ref_n)
        out["flag"][f"p={p}"] = {"fails": fails[p], "batch": FLAG_RATE_BATCH,
                                 "jax": [ref_k, ref_n], "s": dt}
        log(f"path 14 (b) flag EC Steane X p={p} B={FLAG_RATE_BATCH}: "
            f"{fails[p]} failures ({fails[p] / FLAG_RATE_BATCH:.5f}; the JAX "
            f"package {ref_k / ref_n:.5f}, allowed difference {spread:.5f});"
            f" {dt:.2f} s")
        if not ok:
            raise RuntimeError(f"flag EC p={p}: {fails[p]} failures against "
                               f"the JAX package's {ref_k} of {ref_n}")
    lo, hi = fails[1e-3], fails[3e-3]
    log(f"path 14 (b) flag EC scaling: failures(3e-3) / failures(1e-3) = "
        f"{hi / max(lo, 1):.3f} (more than 4.5 required)")
    if not (hi > 4.5 * lo and 0 < lo < 0.05 * FLAG_RATE_BATCH):
        raise RuntimeError(f"flag EC is not fault-tolerant: {fails}")
    part_done("b_flag", t_part)

    # -- (c) flag_bench.py at its defaults
    t_part = time.perf_counter()
    rows = flag_bench.main([*FLAG_BENCH_ARGS, "--device", str(dev)])
    out["flag_bench"] = rows
    for row in rows:
        log(f"path 14 (c) flag_bench {json.dumps(row)} ({smi})")
    for p in sorted({r["p"] for r in rows}):
        st_row, fl_row = (next(r for r in rows
                               if r["p"] == p and r["ec_mode"] == m)
                          for m in ("steane", "flag"))
        ok, _ = two_sample_ok(fl_row["fails"], fl_row["shots"],
                              st_row["fails"], st_row["shots"])
        if not (ok or fl_row["fails"] < st_row["fails"]):
            raise RuntimeError(f"flag_bench p={p}: flag EC fails "
                               f"{fl_row['fails']}, Steane EC "
                               f"{st_row['fails']}")
    part_done("c_flag_bench", t_part)

    # -- (d) fidelity, breakeven_probe and breakeven (the 'packed' runs
    #    launch K9); one block-measurement state of the probe is kept
    t_part = time.perf_counter()
    fid = fidelity.main([*FIDELITY_ARGS, "--device", str(dev)])
    log(f"path 14 (d) fidelity {json.dumps(fid)} ({smi})")
    quiet = fidelity.encoded_x_program_error_rate(
        ROLL_GOLD_BATCH, NoiseModel(), 3, device=dev)[0]
    out["fidelity"] = {**fid, "noiseless_encoded_rate": quiet}
    if quiet != 0.0:
        raise RuntimeError(f"fidelity: noiseless encoded rate {quiet}")
    part_done("d_fidelity", t_part)

    # every packed block measurement (a reset measures too) is counted,
    # and the last one's state kept
    measure = engines.PackedEngine.measure_block
    seen, calls = [], [0]

    def spy(self, tab, b, generator=None, *, rand_bits=None):
        seen[:] = [(tab, self.block_qubits(b))]
        calls[0] += 1
        return measure(self, tab, b, generator, rand_bits=rand_bits)

    engines.PackedEngine.measure_block = spy
    try:
        t_part = time.perf_counter()
        out["breakeven_probe"] = breakeven_probe.main(
            [*BREAKEVEN_PROBE_ARGS, "--device", str(dev)])
        for row in out["breakeven_probe"]:
            log(f"path 14 (d) breakeven_probe {json.dumps(row)} ({smi})")
        part_done("d_breakeven_probe", t_part)
        out["breakeven"] = {}
        for tableau in ("packed", "frames"):
            t_part = time.perf_counter()
            rows = breakeven.main([*BREAKEVEN_ARGS, "--tableau", tableau,
                                   "--device", str(dev)])
            out["breakeven"][tableau] = rows
            for row in rows:
                log(f"path 14 (d) breakeven '{tableau}' {json.dumps(row)} "
                    f"({smi})")
            part_done(f"d_breakeven_{tableau}", t_part)
    finally:
        engines.PackedEngine.measure_block = measure
    out["packed_block_measurements"] = calls[0]

    # -- (e) K9's launches by part, seconds, memory; K9 on a state (d)
    #    measured
    out["k9_launches"] = dict(k9)
    out["seconds"] = {**seconds, "path": time.perf_counter() - t_path}
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"path 14 (e) K9 launches by part {k9}; seconds {out['seconds']}; "
        f"peak {out['peak_mem_gb']:.3f} GiB ({smi})")
    packed_parts = ("d_breakeven_probe", "d_breakeven_packed")
    log(f"path 14 (e) packed block measurements and resets in (d): "
        f"{calls[0]}, K9 launches there {sum(k9[k] for k in packed_parts)}")
    if any(k9[k] <= 0 for k in packed_parts) or any(
            v for k, v in k9.items() if k not in packed_parts) or \
            sum(k9[k] for k in packed_parts) != calls[0]:
        raise RuntimeError(f"K9 launches over path 14 {k9}: one a packed "
                           f"block measurement ({calls[0]}) and 0 elsewhere "
                           f"expected")
    tab, qs = seen[0]
    bits = tb.collapse_bits(torch.Generator(device=dev).manual_seed(14),
                            tab.batch, len(qs))
    row = msb.k9_row({"t": tab, "qubits": qs, "bits": bits,
                      "branch": "path 14, breakeven"}, 20, int_ops_per_s)
    log(f"K9 at path 14's breakeven state (B={row['B']} n={row['n']} "
        f"W={row['W']} M={row['M']}, {row['random_share']:.3f} of the "
        f"outcomes random): == plain (outcomes, x, z, r); wrapper "
        f"{row['ms']:.4f} ms, a launch in a graph {row['hot_ms']:.4f} hot, "
        f"{row['cold_ms']:.4f} cold; plain {row['plain_ms']:.3f} ms; bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}); plan {row['plan']}")
    keep = ("ms", "host_ms", "hot_ms", "cold_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "random_share", "int_ops", "plan")
    p_last = out["breakeven"]["packed"][-2]["p"]
    k9_entry = {"launches": sum(k9.values()), "by_part": dict(k9),
                "max_abs_err": 0,
                "shape": f"B={row['B']} n={row['n']} W={row['W']} "
                         f"M={row['M']} (path 14, the last block measurement "
                         f"of breakeven 'packed', p={p_last})",
                **{k: row[k] for k in keep}}
    return out, k9_entry


def main() -> int:
    t_script = time.perf_counter()
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
    k1_err, lab_k, conv_k = k1_equal(duf, device_uf_cuda, dg, defect,
                                     f"on {CHECK_ROWS} rows")
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
        err, lab_wk, _ = k1_equal(duf, device_uf_cuda, mid, wdef,
                                  f"with chunks on the {name} window graph")
        k1c_err = max(k1c_err, err)
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

    # -- 8f. main path 8: the circuit-level qLDPC memory, BP+OSD in plain
    #    torch on the card (no hand kernel is on this path)
    qldpc = path8(dev)

    # -- 8g. main path 9: per-shot side-information decoding (belief-
    #    matching, the fused soft decode, heralded erasure, leakage, exact
    #    ML); K1 runs the erasure and leakage memories' static arms
    sideinfo = path9(dev)

    # -- 8h. main path 10: lattice surgery and patch schedules (the bespoke
    #    protocols decoded on the host, the fused schedule pipeline on K1
    #    and K2, the circuit-level merge, fault distances)
    surgery_rows = path10(dev, int_ops_per_s)

    # -- 8i. main path 11: the compiled logical programs (the fused
    #    compiled CNOT on K2 and the generic decoder, the op set on the
    #    surgery tier, the circuit tier, the two-level memory with K1 on
    #    its level-2 graph, the protocol gold on the card's tableau)
    logical_rows = path11(dev, int_ops_per_s)

    # -- 8j. main path 12: the FT transpiler on the tableau engines (K9 in
    #    every packed block measurement), exact outcomes, the engines bit
    #    for bit, rates against the JAX package's count, the flagship bench
    ftqc, k9_ftqc = path12(dev, int_ops_per_s, smi)

    # -- 8k. main path 13: the Pauli-frame FT engine and parallel EC (no
    #    kernel: K9 must launch 0 times), the golds and refusals, frames
    #    against unpacked bit for bit, parallel against serial EC, the
    #    ftqc and idle benches
    ftqc_frames = path13(dev, smi, ftqc)

    # -- 8l. main path 14: the rest of the FT transpiler (the unrolled
    #    engine, flag EC on 'frames', the flag, fidelity and breakeven
    #    benches; K9 in the 'packed' break-even runs)
    ftqc_rest, k9_rest = path14(dev, int_ops_per_s, smi)

    # -- 8m. main path 15: magic states (the distillation map, magic_bench,
    #    injection and the factory; K8 and K6 in the injection's decode) and
    #    the twelve sharded pipelines on one card and on the card named
    #    twice (K1, K2, K6, K8, K9 on their paths)
    magic_mesh, mesh_kernels = path15(dev, int_ops_per_s, smi)

    # -- 8n. main path 16: the port's last modules and benchmark scripts
    #    (batched RREF, threshold, memory bench, error curve, roofline,
    #    bp_bench's spacetime/stream/gap rows, the headline line, the entry
    #    points and the dry run, the demo); K1, K2, K6, K8 on its path
    finish, finish_kernels = path16(dev, int_ops_per_s, smi)

    # -- 9. kernel and plain-version times at the main paths' shapes
    defect_big = duf.stencil_defect(dg, dets_big)
    k1_ms = cuda_ms(lambda: device_uf_cuda.stencil_full(dg, defect_big), 20)
    k1_plain_ms = cuda_ms(lambda: duf._stencil_plain(dg, defect_big), 2)
    # and on all-zero detectors: the fixed cost of a row in and its labels
    # out
    zero_big = torch.zeros_like(defect_big)
    k1_zero_ms = cuda_ms(lambda: device_uf_cuda.stencil_full(dg, zero_big),
                         20)
    for x in (defect_big, zero_big):
        k1_err = max(k1_err, k1_equal(duf, device_uf_cuda, dg, x,
                                      f"at B={BATCH}", converged=False)[0])
    V1 = defect_big.shape[1]
    k1_plan, k1_need, k1_bound = k1_report(
        f"B={BATCH} V={V1} NC=0", device_uf_cuda, dg, defect_big,
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
        k1c_err = max(k1c_err, k1_equal(
            duf, device_uf_cuda, mid, x, f"with chunks at B={STREAM_BATCH}",
            converged=False)[0])
    Vw = wdef.shape[1]
    NCw = len(mid.stencil.chunks)
    k1w_plan, k1w_need, k1w_bound = k1_report(
        f"B={STREAM_BATCH} V={Vw} NC={NCw}", device_uf_cuda, mid, wdef,
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
    k1p_err = k1_equal(duf, device_uf_cuda, pmid, pdef,
                       "at the parallel window's interior shape",
                       converged=False)[0]
    Vp, NCp = pdef.shape[1], len(pmid.stencil.chunks)
    k1p_label = f"B={pdef.shape[0]} V={Vp} NC={NCp}"
    k1p_plan, k1p_need, k1p_bound = k1_report(
        k1p_label, device_uf_cuda, pmid, pdef, int_ops_per_s)
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
    print(json.dumps({"qldpc": qldpc}), flush=True)
    print(json.dumps({"side_information": sideinfo}), flush=True)
    surgery_kernels = surgery_rows.pop("kernels")
    print(json.dumps({"surgery": surgery_rows}), flush=True)
    logical_kernels = logical_rows.pop("kernels")
    print(json.dumps({"logical": logical_rows}), flush=True)
    print(json.dumps({"ftqc": ftqc}), flush=True)
    print(json.dumps({"ftqc_frames": ftqc_frames}), flush=True)
    print(json.dumps({"ftqc_rest": ftqc_rest}), flush=True)
    print(json.dumps({"magic_mesh": magic_mesh}), flush=True)
    print(json.dumps({"finish": finish},
                     default=lambda o: o.item() if hasattr(o, "item")
                     else str(o)), flush=True)
    k9_entry["ftqc"] = k9_ftqc
    k9_entry["ftqc_frames"] = {"launches": ftqc_frames["k9_launches"]}
    k9_entry["ftqc_rest"] = k9_rest
    k9_entry["magic_mesh"] = mesh_kernels["K9"]
    k9_entry["finish"] = finish_kernels["K9"]
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
             "plan": k1p_plan, "work": k1p_need},
         "side_information": {
             "launches": sideinfo["k1_launches"],
             "chunk_launches": sideinfo["k1_chunk_launches"],
             "by_arm": {f"{exp}_{arm}": row["k1_launches"]
                        for exp, rows in (
                            ("erasure", sideinfo["erasure"]),
                            ("leakage", sideinfo["leakage"]["memory"]))
                        for arm, row in rows.items()}},
         "surgery": surgery_kernels["K1"],
         "logical": logical_kernels["K1"],
         "magic_mesh": mesh_kernels["K1"],
         "finish": finish_kernels["K1"]},
        {"name": "uf_stencil_prop", "route": "cuda",
         "source": "qcss_tpu_torch/csrc/uf_stencil_staged.cu",
         "replaces": "qcss_tpu/decode/device_uf_pallas.py:74",
         "launches": n_staged["prop"], "max_abs_err": k3_err,
         **staged["K3"], "finish": finish_kernels["K3"]},
        {"name": "uf_stencil_act", "route": "cuda",
         "source": "qcss_tpu_torch/csrc/uf_stencil_staged.cu",
         "replaces": "qcss_tpu/decode/device_uf_pallas.py:149",
         "launches": n_staged["act"], "max_abs_err": k4_err,
         **staged["K4"], "finish": finish_kernels["K4"]},
        {"name": "uf_stencil_round", "route": "cuda",
         "source": "qcss_tpu_torch/csrc/uf_stencil_staged.cu",
         "replaces": "qcss_tpu/decode/device_uf_pallas.py:193",
         "launches": n_staged["round"], "max_abs_err": k5_err,
         **staged["K5"], "finish": finish_kernels["K5"]},
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
             "plan")},
         "surgery": surgery_kernels["K2"],
         "logical": logical_kernels["K2"],
         "magic_mesh": mesh_kernels["K2"],
         "finish": finish_kernels["K2"]},
        {"name": "syndromes_packed", "route": "cuda",
         "source": "qcss_tpu_torch/csrc/gf2_packed.cu",
         "replaces": "qcss_tpu/ops/pallas_gf2.py:51",
         "launches": n_k6, "max_abs_err": k6_err, **times["K6"],
         "library_note": lib_note, "magic_mesh": mesh_kernels["K6"],
         "finish": finish_kernels["K6"]},
        {"name": "syndromes_packed_t", "route": "cuda",
         "source": "qcss_tpu_torch/csrc/gf2_packed.cu",
         "replaces": "qcss_tpu/ops/pallas_gf2.py:107",
         "launches": n_k7, "max_abs_err": k7_err, **times["K7"],
         "library_note": lib_note, "finish": finish_kernels["K7"]},
        {"name": "decode_residual_packed", "route": "cuda",
         "source": "qcss_tpu_torch/csrc/gf2_packed.cu",
         "replaces": "qcss_tpu/ops/pallas_gf2.py:156",
         "launches": n_k8, "max_abs_err": k8_err, **times["K8"],
         "magic_mesh": mesh_kernels["K8"],
         "finish": finish_kernels["K8"]},
        k9_entry,
    ]}), flush=True)
    log(f"chip_smoke.py: {time.perf_counter() - t_script:.1f} s in all, "
        f"path 16 {finish['wall_s']:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
