"""Fidelity benchmark: raw vs FT-encoded program under circuit-level noise
(PyTorch port of the JAX package's benchmarks/fidelity.py).

The replacement for the reference's fidelity harness, which runs 100,000
noisy-QVM shots of a raw X-gate program against 20 Steane-encoded shots
and prints counts and wall time without recording anything (reference:
test/test_fidelity.py:38-46). Here both pipelines run batched on the card
(or the CPU) with an explicit seeded Pauli noise model, and the comparison
is printed as JSON (logical error rates + throughput), with the JAX
package's keys. Seeds take the place of the JAX package's keys.

Usage:
    python -m qcss_tpu_torch.benchmarks.fidelity [--p 0.001] [--shots 1024]
        [--t1 --t2 --ro] [--ec-extractions 1] [--tableau unpacked]
        [--device cuda] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import time

from qcss_tpu_torch.circuits import Program
from qcss_tpu_torch.codes import families
from qcss_tpu_torch.ftqc import rewrite_program
from qcss_tpu_torch.sim import noise as noise_mod
from qcss_tpu_torch.sim import tableau as tb


def raw_x_program_error_rate(shots: int, model: noise_mod.NoiseModel,
                             seed: int, device="cuda") -> float:
    """Unencoded single-qubit X-then-measure under the same noise model;
    the gate's noise, the collapse and the readout each draw from their own
    generator (`noise.chunk_generators(seed, 3)`)."""
    g1, g2, g3 = noise_mod.chunk_generators(seed, 3, device)
    t = tb.zero_state(shots, 1, device)
    t = noise_mod.noisy_gate(t, "X", (0,), model, g1)
    t, outcome = tb.measure_z(t, 0, g2)
    if model.p_meas:
        outcome = noise_mod.flip_bits(outcome, model.p_meas, g3)
    return float(1.0 - outcome.double().mean().item())  # host fence


def encoded_x_program_error_rate(shots: int, model: noise_mod.NoiseModel,
                                 seed: int, ec_extractions: int = 1,
                                 tableau: str = "unpacked",
                                 device="cuda") -> tuple[float, float]:
    """The Steane-encoded X-then-measure program: (logical error rate,
    seconds of one timed run after a warm one; `run` returns host arrays,
    so each run is fenced by its read)."""
    prog = Program()
    ro = prog.declare("ro", 1)
    prog.x(0).measure(0, ro[0])
    enc = rewrite_program(prog, families.steane(), noise=model,
                          ec_extractions=ec_extractions, tableau=tableau,
                          device=device)
    enc.run(shots, 123)  # warm-up
    t0 = time.perf_counter()
    res = enc.run(shots, seed)
    elapsed = time.perf_counter() - t0
    return float(1.0 - res["ro"][:, 0].mean()), elapsed


def main(argv=None) -> dict:
    """Parse ``argv`` (the command line by default), print the JSON row
    and return it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--p", type=float, default=0.001, help="physical error rate")
    ap.add_argument("--shots", type=int, default=1024)
    ap.add_argument("--t1", type=float, default=None,
                    help="use a Pauli-twirled T1/T2 decoherence model "
                    "instead of uniform depolarizing (matches the "
                    "reference QVM harness: T1=T2=300e-6, ro=0.99)")
    ap.add_argument("--t2", type=float, default=None)
    ap.add_argument("--ro", type=float, default=0.99, help="readout fidelity")
    ap.add_argument("--ec-extractions", type=int, default=1,
                    help="2 = Shor-style repeated syndrome extraction")
    ap.add_argument("--tableau", default="unpacked")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="the raw run's seed; the encoded run takes seed + 1")
    args = ap.parse_args(argv)

    if args.t1 is not None:
        model = noise_mod.NoiseModel.from_decoherence(
            t1=args.t1, t2=args.t2 if args.t2 is not None else args.t1,
            ro_fidelity=args.ro,
        )
    else:
        model = noise_mod.NoiseModel(
            p_gate1=args.p, p_gate2=args.p, p_meas=args.p, p_reset=args.p
        )
    raw_rate = raw_x_program_error_rate(args.shots, model, args.seed,
                                        args.device)
    enc_rate, enc_time = encoded_x_program_error_rate(
        args.shots, model, args.seed + 1, args.ec_extractions, args.tableau,
        args.device)
    row = {
        "p_physical": args.p if args.t1 is None else None,
        "noise": "uniform-depolarizing" if args.t1 is None else {
            "t1": args.t1, "t2": args.t2 or args.t1, "ro_fidelity": args.ro,
            "pauli1": model.pauli1, "pauli2": model.pauli2,
        },
        "shots": args.shots,
        "ec_extractions": args.ec_extractions,
        "raw_logical_error_rate": raw_rate,
        "encoded_logical_error_rate": enc_rate,
        "encoded_shots_per_sec": round(args.shots / enc_time, 1),
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
