"""Logical-Z memory experiment benchmark: circuit-level shots/s and
logical failure rates per (code, rounds) on the card (PyTorch port of the
JAX package's benchmarks/memory_bench.py, with its codes, decoders,
engines and JSON keys).

The default rows time one `z_memory_experiment` call per (code, rounds)
after a warm call at another seed (the call reads its counts back, so it
is host-fenced); ``--curve`` sweeps p with rounds = d and p_meas = 5 p,
decoded with ``--decoder`` ('uf' or 'dem'; any other choice runs 'dem').

Usage:
    python -m qcss_tpu_torch.benchmarks.memory_bench [--batch 16384]
        [--rounds 1 3 5] [--codes steane surface5] [--engine tableau]
        [--device cuda]
    python -m qcss_tpu_torch.benchmarks.memory_bench --curve --codes
        surface9 --ps 4e-3 --batch 32768 --engine frames
"""

from __future__ import annotations

import argparse
import json
import time

from qcss_tpu_torch.codes import families
from qcss_tpu_torch.experiments import z_memory_experiment
from qcss_tpu_torch.sim.noise import NoiseModel

CODES = {
    "steane": lambda: families.steane(),
    "surface3": lambda: families.rotated_surface(3, max_table_weight=2, t=None),
    "surface5": lambda: families.rotated_surface(5, max_table_weight=3, t=None),
}


def _make_code(name: str):
    if name in CODES:
        return CODES[name]()
    if name.startswith("surface"):
        # no LUTs at d>=7: uf/dem/mwpm decoders only
        return families.rotated_surface(int(name[len("surface"):]))
    raise ValueError(f"unknown code {name!r}")


def _distance(name: str) -> int:
    if name == "steane":
        return 3
    return int(name[len("surface"):])


def main(argv=None) -> list[dict]:
    """Parse ``argv`` (the command line by default), print the JSON rows
    and return them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--rounds", type=int, nargs="+", default=[1, 3, 5])
    ap.add_argument("--codes", nargs="+", default=["steane", "surface5"])
    ap.add_argument("--p-gate", type=float, default=0.001)
    ap.add_argument("--p-meas", type=float, default=0.005)
    ap.add_argument("--decoder", default="vote",
                    choices=["vote", "difference", "stlut", "uf", "dem"])
    ap.add_argument("--curve", action="store_true",
                    help="circuit-level memory curve: p-sweep with "
                    "rounds = d and p_meas = 5*p_gate2 (surface codes); "
                    "decoded with --decoder (default dem = circuit-level "
                    "detector error model)")
    ap.add_argument("--ps", type=float, nargs="+", default=[5e-4, 1e-3, 2e-3])
    ap.add_argument("--engine", default="tableau",
                    choices=["tableau", "frames"],
                    help="'frames' = Pauli-frame sampler (sim/frame.py): "
                    "the same statistics, bit for bit at one seed")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = []

    def emit(row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    if args.curve:
        for name in args.codes:
            code = _make_code(name)
            d = _distance(name)
            for p in args.ps:
                noise = NoiseModel(p_gate2=p, p_meas=5 * p)
                t0 = time.perf_counter()
                dec = args.decoder if args.decoder in ("uf", "dem") else "dem"
                out = z_memory_experiment(code, rounds=d, noise=noise,
                                          batch=args.batch, seed=0,
                                          decoder=dec, engine=args.engine,
                                          device=args.device)
                dt = time.perf_counter() - t0
                emit({
                    "metric": "z_memory_curve",
                    "code": name,
                    "rounds": d,
                    "batch": args.batch,
                    "p_gate2": p,
                    "p_meas": 5 * p,
                    "decoder": dec,
                    "engine": args.engine,
                    "logical_fail": out["logical_fail"],
                    "elapsed_s": dt,
                })
        return rows

    noise = NoiseModel(p_gate2=args.p_gate, p_meas=args.p_meas)
    for name in args.codes:
        code = _make_code(name)
        for rounds in args.rounds:
            # a warm call at another seed, then one timed call
            z_memory_experiment(code, rounds=rounds, noise=noise,
                                batch=args.batch, seed=100,
                                decoder=args.decoder, engine=args.engine,
                                device=args.device)
            t0 = time.perf_counter()
            out = z_memory_experiment(code, rounds=rounds, noise=noise,
                                      batch=args.batch, seed=0,
                                      decoder=args.decoder,
                                      engine=args.engine,
                                      device=args.device)
            dt = time.perf_counter() - t0
            emit({
                "metric": "z_memory_experiment",
                "code": name,
                "rounds": rounds,
                "batch": args.batch,
                "p_gate2": args.p_gate,
                "p_meas": args.p_meas,
                "engine": args.engine,
                "logical_fail": out["logical_fail"],
                "value": args.batch / dt,
                "unit": "shots/sec/card",
            })
    return rows


if __name__ == "__main__":
    main()
