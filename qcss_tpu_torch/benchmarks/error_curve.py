"""Logical-error-rate curve CLI (PyTorch port of the JAX package's
benchmarks/error_curve.py; BASELINE config 3).

Sweeps the physical depolarizing rate and prints one JSON line per point;
with --checkpoint the sweep is resumable. Shards over `make_mesh()` (every
card) when more than one card is visible; otherwise runs on ``--device``.

Usage:
    python -m qcss_tpu_torch.benchmarks.error_curve --code steane \\
        --samples 1048576 --ps 0.001 0.003 0.01 0.03 0.1 \\
        [--checkpoint curve.jsonl] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import torch

from qcss_tpu_torch.codes import families
from qcss_tpu_torch.decode import error_rate_curve

CODES = {
    "steane": lambda: families.steane(),
    "shor": lambda: families.shor(),
    "rm15": lambda: families.reed_muller_15(),
    "surface3": lambda: families.rotated_surface(3, max_table_weight=2, t=None),
    "surface5": lambda: families.rotated_surface(5, max_table_weight=3, t=None),
}


def main(argv=None) -> list[dict]:
    """Parse ``argv`` (the command line by default), print one JSON line
    per point and return the rows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--code", choices=sorted(CODES), default="steane")
    ap.add_argument("--ps", type=float, nargs="+",
                    default=[0.001, 0.003, 0.01, 0.03, 0.1])
    ap.add_argument("--samples", type=int, default=1 << 20)
    ap.add_argument("--batch", type=int, default=1 << 18)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mesh = None
    if torch.device(args.device).type == "cuda" \
            and torch.cuda.device_count() > 1:
        from qcss_tpu_torch.parallel import make_mesh

        mesh = make_mesh()

    points = error_rate_curve(
        CODES[args.code](), args.ps,
        samples_per_point=args.samples, batch=args.batch,
        checkpoint_path=args.checkpoint, mesh=mesh, device=args.device,
    )
    rows = [{"code": args.code, **pt} for pt in points]
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
