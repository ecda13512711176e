"""Flag EC vs Steane EC (PyTorch port of the JAX package's
benchmarks/flag_bench.py, ``ec_mode='flag'``).

Steane EC burns two freshly verified n-qubit encoded ancilla blocks per
extraction (the reference's only protocol — reference: css_code.py:436-470);
flag EC measures each stabilizer with a bare syndrome qubit + flag qubit
pair (Chao-Reichardt / Chamberland-Beverland), so an EC round costs 2
ancilla qubits instead of 2n — at the price of sequential data coupling
(deeper circuits, more idle exposure) and adaptive re-extraction.

This harness runs the same program under both modes at identical physics
on the 'frames' engine and prints one JSON line per configuration, with
the JAX package's keys: logical failure, throughput, and the
ancilla-qubit budget. Every call is fenced by its host read; seeds take
the place of the JAX package's keys (99 and 98 warm, 500 + i timed).

Usage:
    python -m qcss_tpu_torch.benchmarks.flag_bench [--code steane]
        [--p 1e-3 3e-4] [--p-idle-frac 0] [--shots 32768] [--chunk 8192]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

from qcss_tpu_torch.circuits import Program
from qcss_tpu_torch.codes import families
from qcss_tpu_torch.ftqc import rewrite_program
from qcss_tpu_torch.sim.noise import NoiseModel

CODES = {
    "steane": lambda: families.steane(),
    "surface3": lambda: families.rotated_surface(3, max_table_weight=1),
    "color3": lambda: families.triangular_color(3),
}


def main(argv=None) -> list[dict]:
    """Parse ``argv`` (the command line by default), print one JSON line
    per (p, EC mode) and return the rows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--code", default="steane",
                    choices=["steane", "surface3", "color3"])
    ap.add_argument("--p", type=float, nargs="+", default=[1e-3, 3e-4])
    ap.add_argument("--p-idle-frac", type=float, default=0.0,
                    help="p_idle = frac * p (0 = no idle locations)")
    ap.add_argument("--shots", type=int, default=1 << 15)
    ap.add_argument("--chunk", type=int, default=1 << 13)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    code = CODES[args.code]()
    prog = Program()
    ro = prog.declare("ro", 1)
    prog.x(0)
    prog.measure(0, ro[0])

    rows = []
    for p in args.p:
        noise = NoiseModel(p_gate1=p, p_gate2=p, p_meas=p, p_reset=p,
                           p_idle=args.p_idle_frac * p)
        for mode in ("steane", "flag"):
            enc = rewrite_program(prog, code, noise=noise, tableau="frames",
                                  ec_mode=mode, device=args.device)
            enc.run(args.chunk, 99)
            enc.run(args.chunk, 98)
            fails = 0
            t0 = time.perf_counter()
            for i in range(args.shots // args.chunk):
                res = enc.run(args.chunk, 500 + i)
                fails += int((res["ro"][:, 0] != 1).sum())
            dt = time.perf_counter() - t0
            shots = (args.shots // args.chunk) * args.chunk
            row = {
                "bench": "flag_vs_steane_ec",
                "code": args.code,
                "ec_mode": mode,
                "p": p,
                "p_idle": args.p_idle_frac * p,
                "anc_qubits_per_ec": 2 if mode == "flag" else 2 * code.n,
                "shots": shots,
                "fails": fails,
                "fail_rate": fails / shots,
                "shots_per_sec": round(shots / dt),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
