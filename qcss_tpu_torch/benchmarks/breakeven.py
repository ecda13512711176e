"""Raw-vs-encoded break-even sweep (pseudo-threshold; PyTorch port of the
JAX package's benchmarks/breakeven.py).

For each physical rate p, runs the unencoded X-then-measure program and the
FT-encoded one under the same uniform circuit-level noise
(p_gate1 = p_gate2 = p_meas = p_reset = p) and reports both logical error
rates. The pseudo-threshold p* is the largest swept p with encoded < raw.

The reference never demonstrates break-even — its own harness measures the
encoded pipeline WORSE than raw and attributes part of that to the shared
-ancilla compromise (reference: ftqc.py:153-160, test/test_fidelity.py).
Two framework changes make the crossing measurable here: the
verification-ordering fix in ftqc/schedule.py::_encode_ft (the reference's
detect-X-then-Z order leaks a first-order weight-2 error path), and enough
throughput to resolve sub-1e-4 rates.

Prints one JSON line per point, with the JAX package's keys, then a
summary line; shots are chunked to bound device memory, and every chunk
is fenced by its host read. Seeds take the place of the JAX package's
keys (99 and 98 warm, 1000 + i timed, 2 for the raw program). The default
tableau is 'packed', whose block measurements run K9 on the card.

Usage:
    python -m qcss_tpu_torch.benchmarks.breakeven [--ps 1e-3 3e-4 1e-4 3e-5]
        [--min-shots 131072] [--chunk 65536] [--tableau packed]
        [--ancillas shared] [--ec-extractions 1] [--idle-frac 0]
        [--ec-schedule serial] [--code steane] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import time

from qcss_tpu_torch.benchmarks.fidelity import raw_x_program_error_rate
from qcss_tpu_torch.circuits import Program
from qcss_tpu_torch.codes import families
from qcss_tpu_torch.ftqc import rewrite_program
from qcss_tpu_torch.sim.noise import NoiseModel


def wilson(k: int, n: int, z: float = 1.96) -> tuple[float, float]:
    """Wilson score interval for a binomial proportion (95% default)."""
    if n == 0:
        return (0.0, 1.0)
    ph = k / n
    den = 1 + z * z / n
    mid = (ph + z * z / (2 * n)) / den
    half = z * math.sqrt(ph * (1 - ph) / n + z * z / (4 * n * n)) / den
    return (max(mid - half, 0.0), min(mid + half, 1.0))


def main(argv=None) -> list[dict]:
    """Parse ``argv`` (the command line by default), print one JSON line a
    point and the summary line, and return every row, the summary last."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ps", type=float, nargs="+",
                    default=[1e-3, 3e-4, 1e-4, 3e-5])
    ap.add_argument("--min-shots", type=int, default=1 << 17)
    ap.add_argument("--chunk", type=int, default=1 << 16)
    ap.add_argument("--tableau", default="packed")
    ap.add_argument("--ancillas", default="shared")
    ap.add_argument("--ec-extractions", type=int, default=1,
                    help="2 = Shor-style repeated extraction per EC sector")
    ap.add_argument("--idle-frac", type=float, default=0.0,
                    help="p_idle = idle_frac * p (0 = no idle locations)")
    ap.add_argument("--ec-schedule", default="serial",
                    choices=["serial", "parallel"])
    ap.add_argument("--code", default="steane",
                    choices=["steane", "golay", "color5"],
                    help="encoded code: steane [[7,1,3]], golay [[23,1,7]] "
                    "(transversal-S distance 7), color5 [[19,1,5]]")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    code = {
        "steane": families.steane,
        "golay": families.golay,
        "color5": lambda: families.triangular_color(5),
    }[args.code]()
    results = []
    for p in args.ps:
        # enough shots to expect >= ~40 raw failures (raw rate ~ 1.7p)
        shots = max(args.min_shots, int(40 / (1.7 * p)))
        shots = ((shots + args.chunk - 1) // args.chunk) * args.chunk
        model = NoiseModel(p_gate1=p, p_gate2=p, p_meas=p, p_reset=p,
                           p_idle=args.idle_frac * p)
        prog = Program()
        ro = prog.declare("ro", 1)
        prog.x(0).measure(0, ro[0])
        enc = rewrite_program(prog, code, noise=model, tableau=args.tableau,
                              ancillas=args.ancillas,
                              ec_extractions=args.ec_extractions,
                              ec_schedule=args.ec_schedule,
                              device=args.device)
        # warm at the chunk size, twice, as the JAX package's bench does
        enc.run(args.chunk, 99)
        enc.run(args.chunk, 98)
        fails = prep_fails = 0
        t0 = time.perf_counter()
        for i in range(shots // args.chunk):
            res = enc.run(args.chunk, 1000 + i)
            fails += int((1 - res["ro"][:, 0]).sum())
            prep_fails += int(res["__prep_fail__"].sum())
        dt = time.perf_counter() - t0
        raw = raw_x_program_error_rate(shots, model, 2, args.device)
        raw_k = int(round(raw * shots))
        row = {
            "bench": "breakeven",
            "code": args.code,
            "idle_frac": args.idle_frac,
            "p": p,
            "shots": shots,
            "raw_rate": raw,
            "raw_ci": wilson(raw_k, shots),
            "enc_fails": fails,
            "enc_rate": fails / shots,
            "enc_ci": wilson(fails, shots),
            "prep_fail_frac": prep_fails / shots,
            "enc_shots_per_sec": round(shots / dt),
            "encoded_wins": fails / shots < raw,
            # CI-resolved verdicts: encoded wins/loses beyond statistics
            "encoded_wins_ci": wilson(fails, shots)[1] < wilson(raw_k, shots)[0],
            "encoded_loses_ci": wilson(fails, shots)[0] > wilson(raw_k, shots)[1],
        }
        results.append(row)
        print(json.dumps(row), flush=True)

    wins = [r["p"] for r in results if r["encoded_wins"]]
    # resolve the crossing: the bracketing (largest CI-certain win,
    # smallest CI-certain loss) plus a log-log interpolation of the
    # encoded/raw ratio through 1
    ci_wins = sorted(r["p"] for r in results if r["encoded_wins_ci"])
    ci_loses = sorted(r["p"] for r in results if r["encoded_loses_ci"])
    p_star = None
    lo = max(ci_wins) if ci_wins else None
    hi = min(ci_loses) if ci_loses else None
    if lo is not None and hi is not None and lo < hi:
        pts = sorted((r["p"], r["enc_rate"] / max(r["raw_rate"], 1e-12))
                     for r in results
                     if lo <= r["p"] <= hi and r["enc_rate"] > 0)
        for (p0, r0), (p1, r1) in zip(pts, pts[1:]):
            if r0 < 1 <= r1:
                f = (0 - math.log(r0)) / (math.log(r1) - math.log(r0))
                p_star = math.exp(
                    math.log(p0) + f * (math.log(p1) - math.log(p0)))
                break
    summary = {
        "bench": "breakeven_summary",
        "pseudo_threshold_lower_bound": max(wins) if wins else None,
        "p_star_ci_bracket": [lo, hi],
        "p_star_interpolated": p_star,
        "ancillas": args.ancillas,
        "ec_extractions": args.ec_extractions,
    }
    print(json.dumps(summary), flush=True)
    return results + [summary]


if __name__ == "__main__":
    main()
