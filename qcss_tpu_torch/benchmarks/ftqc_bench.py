"""FTQC end-to-end throughput: encoded-program shots/sec at growing code
size, on each engine (PyTorch port of the JAX package's
benchmarks/ftqc_bench.py).

Runs the FT-encoded X-then-measure program (FT prep, per-gate Steane EC,
2t+1 majority-vote measurement) and reports steady-state shots/sec on the
'unpacked' and 'packed' tableau engines and the 'frames' Pauli-frame
engine; ``--ec-scaling`` instead times the EC_ALL cost against program
width, serial against parallel EC (frames engine, dedicated ancillas).
Every timed call is fenced by a host read of its registers.

Usage:
    python -m qcss_tpu_torch.benchmarks.ftqc_bench [--batch 64]
        [--codes steane surface5] [--tableaus unpacked packed frames]
        [--ec-scaling 1 2 4] [--device cuda] [--seed 0]

One JSON line per (code, engine), or per (width, schedule), with the JAX
package's keys. The shots run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time

from qcss_tpu_torch.benchmarks.ftqc_programs import x_program
from qcss_tpu_torch.circuits import Program
from qcss_tpu_torch.codes import families
from qcss_tpu_torch.ftqc import rewrite_program

CODES = {
    "steane": lambda: families.steane(),
    "surface3": lambda: families.rotated_surface(3, max_table_weight=2, t=None),
    "surface5": lambda: families.rotated_surface(5, max_table_weight=3, t=None),
}


def _timed(enc, batch: int, seed: int) -> dict:
    """2 warm calls, then 3 timed ones, each fenced by a host read."""

    def run_once(s: int) -> int:
        return int(enc.run(batch, seed + s)["ro"].sum())  # host fence

    run_once(100)
    run_once(101)
    reps = 3
    t0 = time.perf_counter()
    correct = sum(run_once(i + 1) for i in range(reps))
    dt = time.perf_counter() - t0
    return {"shots_per_sec": round(reps * batch / dt, 1),
            "correct_fraction": correct / (reps * batch), "timed_s": dt}


def bench(code, tableau: str, batch: int, *, device="cuda",
          seed: int = 0) -> dict:
    """Shots/s of the X program FT-encoded on ``code`` and engine
    ``tableau``, and the correct fraction (1.0: the run is noiseless)."""
    enc = rewrite_program(x_program(), code, tableau=tableau, device=device)
    return _timed(enc, batch, seed)


def ec_scaling(n_logical: int, schedule: str, batch: int, *, device="cuda",
               seed: int = 0) -> dict:
    """EC_ALL cost vs program width: n_logical blocks, one X per block
    (each followed by an EC round over ALL blocks), one measurement.
    Serialized EC does O(n^2) block-rounds total; the parallel schedule
    O(n) wall-layers — shots/sec ratio vs n is the scaling evidence."""
    prog = Program()
    ro = prog.declare("ro", 1)
    for q in range(n_logical):
        prog.x(q)
    prog.measure(0, ro[0])
    enc = rewrite_program(x_program() if n_logical == 0 else prog,
                          families.steane(), tableau="frames",
                          ancillas="dedicated", ec_schedule=schedule,
                          device=device)
    stats = _timed(enc, batch, seed)
    return {
        "metric": "ec_all_scaling",
        "n_logical": n_logical,
        "ec_schedule": schedule,
        "batch": batch,
        "value": stats["shots_per_sec"],
        "unit": "shots/sec/chip",
        "correct_fraction": stats["correct_fraction"],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--codes", nargs="+", default=["steane", "surface5"])
    ap.add_argument("--tableaus", nargs="+",
                    default=["unpacked", "packed", "frames"],
                    choices=["unpacked", "packed", "frames"])
    ap.add_argument("--ec-scaling", type=int, nargs="+", default=None,
                    metavar="N_LOGICAL",
                    help="instead: EC_ALL wall-time scaling across program "
                    "widths, serial vs parallel schedules (frames engine)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="added to every call's seed (100, 101, then 1-3)")
    args = ap.parse_args()

    if args.ec_scaling:
        for n_logical in args.ec_scaling:
            for schedule in ("serial", "parallel"):
                print(json.dumps(ec_scaling(n_logical, schedule, args.batch,
                                            device=args.device,
                                            seed=args.seed)), flush=True)
        return

    for name in args.codes:
        code = CODES[name]()
        for tableau in args.tableaus:
            stats = bench(code, tableau, args.batch, device=args.device,
                          seed=args.seed)
            print(json.dumps({
                "metric": "ftqc_encoded_program_throughput",
                "code": name,
                "n_physical": 3 * code.n,
                "tableau": tableau,
                "batch": args.batch,
                "value": stats["shots_per_sec"],
                "unit": "shots/sec/chip",
                "correct_fraction": stats["correct_fraction"],
            }), flush=True)


if __name__ == "__main__":
    main()
