"""Host decoder benchmark: union-find threshold curves, decode throughput,
exact matching against union-find, the host streaming decoder and the
host-decoded memory (PyTorch port of `benchmarks/uf_bench.py`).

Prints JSON lines:
  {"bench": "uf_threshold_curve", "curve": {d: {p: word_fail}}, ...}
  {"bench": "uf_decode_throughput", "d": 11, "shots_per_sec": ...}
  {"bench": "mwpm_vs_uf", "d": 7, ...}
  {"bench": "uf_phenomenological_threshold_curve", ...}
  {"bench": "streaming_memory", "d": ..., "round_shots_per_sec": ...}
  {"bench": "uf_spacetime_memory", "d": 5, "rounds": 5, ...}

The decoders are threaded host kernels (`native/uf_decoder.cc`,
`native/mwpm_decoder.cc`); syndromes come from the batched sampler on the
card (``--cpu``: on the CPU), so the reported shots/s is the host
decoder's throughput. The reference's correlated two-pass line
(`decode.correlated`) is not here: that module is not ported yet.

    python -m qcss_tpu_torch.benchmarks.uf_bench              # on the card
    python -m qcss_tpu_torch.benchmarks.uf_bench --cpu --dmax 5 --samples 4096
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from qcss_tpu_torch.codes import families
from qcss_tpu_torch.decode.mwpm import MWPMDecoder
from qcss_tpu_torch.decode.streaming import (
    StreamingDecoder,
    sample_phenomenological_stream,
)
from qcss_tpu_torch.decode.uf import (
    UFDecoder,
    _pack_parity,
    graph_from_checks,
    uf_logical_error_rate,
    uf_phenomenological_error_rate,
)
from qcss_tpu_torch.experiments.memory import z_memory_experiment
from qcss_tpu_torch.sim.noise import NoiseModel


def _code_capacity_shots(code, p, batch, seed=0):
    h = code.raw_parity_check_c2
    rng = np.random.default_rng(seed)
    errs = (rng.random((batch, code.n)) < p).astype(np.uint8)
    syn = ((errs.astype(np.int64) @ h.T.astype(np.int64)) & 1
           ).astype(np.uint8)
    return errs, syn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="sample on the CPU instead of the card")
    ap.add_argument("--samples", type=int, default=1 << 15)
    ap.add_argument("--dmax", type=int, default=11)
    args = ap.parse_args()
    device = "cpu" if args.cpu else "cuda"

    distances = [d for d in (3, 5, 7, 9, 11) if d <= args.dmax]
    ps = [0.06, 0.08, 0.10, 0.12, 0.14, 0.16]

    curve: dict[int, dict[float, float]] = {}
    t0 = time.perf_counter()
    for d in distances:
        code = families.rotated_surface(d)
        curve[d] = {}
        for p in ps:
            r = uf_logical_error_rate(
                code, p, samples=args.samples, batch=args.samples,
                seed=d * 100, device=device)
            curve[d][p] = r["word_fail"]
    elapsed = time.perf_counter() - t0
    # threshold bracket: largest p where the max distance still beats d=3
    dmax = distances[-1]
    below = [p for p in ps if curve[dmax][p] < curve[3][p]]
    print(json.dumps({
        "bench": "uf_threshold_curve",
        "noise": "code-capacity depolarizing",
        "samples_per_point": args.samples,
        "curve": {str(d): {str(p): v for p, v in c.items()}
                  for d, c in curve.items()},
        "crossing_below_p": max(below) if below else None,
        "elapsed_s": elapsed,
        "device": device,
    }), flush=True)

    # decode throughput (X sector), native threads
    for d in (7, 11):
        if d > args.dmax:
            continue
        code = families.rotated_surface(d)
        dec = UFDecoder(graph_from_checks(code.raw_parity_check_c2,
                                          code.z_operator_matrix()))
        B = 1 << 16
        _, syn = _code_capacity_shots(code, 0.05, B)
        dec.decode_batch(syn[:2048], want_corrections=False)  # warm/build
        t0 = time.perf_counter()
        dec.decode_batch(syn, want_corrections=False)
        dt = time.perf_counter() - t0
        print(json.dumps({
            "bench": "uf_decode_throughput", "d": d, "p": 0.05,
            "shots_per_sec": B / dt,
            "us_per_shot": dt * 1e6 / B,
            "threads": min(os.cpu_count() or 1, 16),
            "native": dec.use_native,
        }), flush=True)

    # exact MWPM (blossom + APSP, native/mwpm_decoder.cc) vs union-find:
    # accuracy and throughput on the same shots
    for d in (7,):
        if d > args.dmax:
            continue
        code = families.rotated_surface(d)
        lz = code.z_operator_matrix()
        g = graph_from_checks(code.raw_parity_check_c2, lz)
        uf, mw = UFDecoder(g), MWPMDecoder(g)
        B, p = 1 << 16, 0.06
        errs, syn = _code_capacity_shots(code, p, B)
        par = (errs @ lz[0]) % 2
        mw.decode_batch(syn[:2048], want_corrections=False)  # warm/build
        t0 = time.perf_counter()
        _, om = mw.decode_batch(syn, want_corrections=False)
        dt_mw = time.perf_counter() - t0
        _, ou = uf.decode_batch(syn, want_corrections=False)
        print(json.dumps({
            "bench": "mwpm_vs_uf", "d": d, "p": p,
            "mwpm_shots_per_sec": B / dt_mw,
            "mwpm_native": mw._native is not None,
            "mwpm_logical_fail": float(np.mean((om & 1) != par)),
            "uf_logical_fail": float(np.mean((ou & 1) != par)),
        }), flush=True)

    # phenomenological multi-round threshold (p = q, rounds = d): the
    # standard 'threshold with measurement errors' benchmark
    ph_curve: dict[int, dict[float, float]] = {}
    ph_ps = [0.01, 0.015, 0.02, 0.025, 0.03, 0.04]
    t0 = time.perf_counter()
    for d in distances:
        if d > 9:
            continue
        code = families.rotated_surface(d)
        ph_curve[d] = {}
        for p in ph_ps:
            r = uf_phenomenological_error_rate(
                code, p, rounds=d, samples=args.samples, batch=args.samples,
                seed=d * 31 + 7, device=device)
            ph_curve[d][p] = r["logical_fail"]
    below = [p for p in ph_ps
             if ph_curve[max(ph_curve)][p] < ph_curve[3][p]]
    print(json.dumps({
        "bench": "uf_phenomenological_threshold_curve",
        "noise": "p data X per round, q=p measurement flips, rounds=d",
        "samples_per_point": args.samples,
        "curve": {str(d): {str(p): v for p, v in c.items()}
                  for d, c in ph_curve.items()},
        "crossing_below_p": max(below) if below else None,
        "elapsed_s": time.perf_counter() - t0,
    }), flush=True)

    # streaming (sliding-window) decode of a 1000-round memory on the host:
    # O(window) state regardless of horizon
    for d in (3, 5, 7):
        if d > args.dmax:
            continue
        code = families.rotated_surface(d)
        h, lz = code.raw_parity_check_c2, code.z_operator_matrix()
        R, B, p = 1000, 512, 0.005
        gen = torch.Generator(device=device).manual_seed(d)
        dets, par = sample_phenomenological_stream(gen, p, p, B, R, h, lz)
        dets = dets.cpu().numpy()
        par = _pack_parity(par.cpu().numpy())
        sd = StreamingDecoder(h, lz, window=4 * d, commit=2 * d)
        t0 = time.perf_counter()
        obs = sd.decode_stream(dets)
        dt = time.perf_counter() - t0
        print(json.dumps({
            "bench": "streaming_memory", "d": d, "rounds": R, "p": p,
            "window": 4 * d, "commit": 2 * d,
            "logical_fail": float(np.mean(obs != par)),
            "round_shots_per_sec": B * R / dt,
        }), flush=True)

    # spacetime memory experiment, surface d=5, host union-find
    code = families.rotated_surface(5)
    noise = NoiseModel(p_gate2=1e-3, p_meas=5e-3)
    t0 = time.perf_counter()
    r = z_memory_experiment(code, rounds=5, noise=noise, batch=1 << 12,
                            decoder="uf", device=device)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "bench": "uf_spacetime_memory", "d": 5, "rounds": 5,
        "p_gate2": 1e-3, "p_meas": 5e-3, "engine": "tableau",
        "logical_fail": r["logical_fail"],
        "shots_per_sec": (1 << 12) / dt,
    }), flush=True)


if __name__ == "__main__":
    main()
