"""Scaling probe for the FT break-even study (PyTorch port of the JAX
package's benchmarks/breakeven_probe.py): encoded-vs-raw error rate at
several physical rates, to establish the encoded pipeline's scaling
exponent and locate the pseudo-threshold bracket. JSON line per point,
with the JAX package's keys; each run is fenced by its host read, and
seeds take the place of the JAX package's keys (99 and 98 warm, 1 timed,
2 for the raw program). The default tableau is 'packed', whose block
measurements run K9 on the card.

Usage:
    python -m qcss_tpu_torch.benchmarks.breakeven_probe
        [--ps 3e-3 1e-3 3e-4] [--shots 65536] [--tableau packed]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

from qcss_tpu_torch.benchmarks.fidelity import raw_x_program_error_rate
from qcss_tpu_torch.circuits import Program
from qcss_tpu_torch.codes import families
from qcss_tpu_torch.ftqc import rewrite_program
from qcss_tpu_torch.sim import noise as noise_mod


def main(argv=None) -> list[dict]:
    """Parse ``argv`` (the command line by default), print one JSON line
    per point and return the rows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ps", type=float, nargs="+",
                    default=[3e-3, 1e-3, 3e-4])
    ap.add_argument("--shots", type=int, default=1 << 16)
    ap.add_argument("--tableau", default="packed")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    code = families.steane()
    rows = []
    for p in args.ps:
        model = noise_mod.NoiseModel(p_gate1=p, p_gate2=p, p_meas=p, p_reset=p)
        prog = Program()
        ro = prog.declare("ro", 1)
        prog.x(0).measure(0, ro[0])
        enc = rewrite_program(prog, code, noise=model, tableau=args.tableau,
                              device=args.device)
        # two warm calls, as the JAX package's probe makes
        enc.run(256, 99)
        enc.run(256, 98)
        t0 = time.perf_counter()
        res = enc.run(args.shots, 1)
        enc_fails = int((1 - res["ro"][:, 0]).sum())
        dt = time.perf_counter() - t0
        raw = raw_x_program_error_rate(args.shots, model, 2, args.device)
        row = {
            "p": p,
            "shots": args.shots,
            "raw_rate": raw,
            "enc_fails": enc_fails,
            "enc_rate": enc_fails / args.shots,
            "prep_fail": int(res["__prep_fail__"].sum()),
            "enc_shots_per_sec": round(args.shots / dt),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
