"""Circuit-level threshold of the rotated surface code under the
DEM-weighted union-find device pipeline (PyTorch port of the JAX
package's benchmarks/threshold.py).

Protocol: Z-basis memory, real extraction circuits sampled on the frame
engine, uniform circuit noise (p_gate2 = p_meas = p_reset = p on every
location), rounds = d, decoded on the exact single-fault circuit-level
DEM with the fused device union-find (`memory_experiment(
decoder='device-dem', engine='frames')`; on the card its decode is the
stencil kernel K1 through `DeviceUFDecoder`'s fused form). For each
adjacent distance pair the crossing of the logical-failure curves is found
by log-linear interpolation; the quoted p_th is the mean of the pairwise
crossings with their spread. ``--decoder dem`` decodes the same DEM on the
host; ``--decoder belief`` runs the two-sector belief-matching tier
(`xz_memory_experiment(belief=iters)`, Z sector quoted).

The seeds are the reference's integers (point rep r at ``seed * 1000 +
r``); the draws are torch's, so rates, not shots, match the reference.

Usage:
  python -m qcss_tpu_torch.benchmarks.threshold              # full sweep
  python -m qcss_tpu_torch.benchmarks.threshold --quick      # 1/8 shots
  python -m qcss_tpu_torch.benchmarks.threshold --device cpu --distances 3
      --ps 0.006 --shots 4096                                # a rehearsal
Prints one JSON line per (d, p) point, then a summary line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from qcss_tpu_torch.codes.families import rotated_surface
from qcss_tpu_torch.experiments.memory import memory_experiment
from qcss_tpu_torch.sim.noise import NoiseModel


def wilson(k: int, n: int, z: float = 1.96):
    if n == 0:
        return (0.0, 1.0)
    ph = k / n
    den = 1 + z * z / n
    c = (ph + z * z / (2 * n)) / den
    hw = z * np.sqrt(ph * (1 - ph) / n + z * z / (4 * n * n)) / den
    return (max(c - hw, 0.0), min(c + hw, 1.0))


def make_noise(p: float, model: str) -> NoiseModel:
    """Noise conventions. 'uniform': p on every 1q/2q gate, measurement
    and reset — the round-4 headline model (NOT directly comparable to
    published numbers). 'si1000': the superconducting-inspired
    convention (Gidney et al.) mapped onto this framework's location
    types — 2q depolarizing p, 1q depolarizing p/10, measurement flip
    5p, reset X error 2p — the apples-to-apples convention against
    published ~0.5%-of-p2 circuit-level thresholds."""
    if model == "uniform":
        return NoiseModel(p_gate2=p, p_gate1=p, p_meas=p, p_reset=p)
    if model == "si1000":
        return NoiseModel(p_gate2=p, p_gate1=p / 10, p_meas=5 * p,
                          p_reset=2 * p)
    raise ValueError(f"unknown noise model {model!r}")


def run_point(d: int, p: float, shots: int, seed: int,
              decoder: str, batch: int, model: str = "uniform",
              iters: int = 32, device="cuda") -> dict:
    """One (d, p) point: ``max(1, shots // batch)`` reps of ``batch``
    shots, rep r at seed ``seed * 1000 + r``, failures summed."""
    code = rotated_surface(d)
    noise = make_noise(p, model)
    fails = 0
    total = 0
    extra_fails: dict[str, int] = {}
    reps = max(1, shots // batch)
    for rep in range(reps):
        if decoder == "belief":
            # belief-matching tier (decode/belief.py): joint-graph BP
            # posteriors -> per-shot UF weights. The two-sector sampler is
            # a harsher convention than the Z-memory harness, so its
            # crossings are not comparable to the memory_experiment rows;
            # the three decoder tiers (independent / correlated / belief)
            # are recorded from the same shots instead
            from qcss_tpu_torch.experiments.memory_xz import (
                xz_memory_experiment,
            )

            out = xz_memory_experiment(code, rounds=d, noise=noise,
                                       batch=batch,
                                       seed=seed * 1000 + rep,
                                       belief=iters, device=device)
            fails += round(out["z_fail_belief"] * batch)
            extra_fails["independent"] = extra_fails.get(
                "independent", 0) + round(out["z_fail"] * batch)
            extra_fails["correlated"] = extra_fails.get(
                "correlated", 0) + round(out["z_fail_corr"] * batch)
        else:
            out = memory_experiment(code, rounds=d, noise=noise,
                                    batch=batch,
                                    seed=seed * 1000 + rep,
                                    decoder=decoder, engine="frames",
                                    device=device)
            fails += round(out["logical_fail"] * batch)
        total += batch
    lo, hi = wilson(fails, total)
    row = {"d": d, "p": p, "shots": total, "fails": fails,
           "logical_fail": fails / total, "ci_lo": lo, "ci_hi": hi}
    for k, v in extra_fails.items():
        row[f"logical_fail_{k}"] = v / total
    return row


def crossings(rows: list[dict]) -> list[float]:
    """Pairwise curve crossings by log-linear interpolation in p."""
    by_d: dict[int, list[dict]] = {}
    for r in rows:
        by_d.setdefault(r["d"], []).append(r)
    for v in by_d.values():
        v.sort(key=lambda r: r["p"])
    ds = sorted(by_d)
    out = []
    for d1, d2 in zip(ds, ds[1:]):
        ps = [r["p"] for r in by_d[d1]]
        f1 = np.array([max(r["logical_fail"], 1e-9) for r in by_d[d1]])
        f2 = np.array([max(r["logical_fail"], 1e-9) for r in by_d[d2]])
        diff = np.log(f2) - np.log(f1)   # <0 below threshold, >0 above
        for i in range(len(ps) - 1):
            if diff[i] < 0 <= diff[i + 1]:
                # linear in log p between the bracketing points
                t = -diff[i] / (diff[i + 1] - diff[i])
                lp = np.log(ps[i]) + t * (np.log(ps[i + 1]) - np.log(ps[i]))
                out.append(float(np.exp(lp)))
                break
    return out


def main(argv=None) -> list[dict]:
    """Parse ``argv`` (the command line by default), print the point rows
    and the summary line, and return them all (the summary last)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--distances", default="3,5,7,9,11")
    ap.add_argument("--ps", default="0.004,0.005,0.006,0.007,0.008,0.009")
    ap.add_argument("--shots", type=int, default=1 << 17)
    ap.add_argument("--batch", type=int, default=1 << 15)
    ap.add_argument("--decoder", default="device-dem",
                    help="device-dem | dem | belief (belief-matching "
                    "tier, Z sector quoted)")
    ap.add_argument("--model", default="uniform",
                    choices=["uniform", "si1000"])
    ap.add_argument("--iters", type=int, default=32,
                    help="BP iterations for --decoder belief")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    shots = args.shots // 8 if args.quick else args.shots
    batch = min(args.batch, shots)
    rows = []
    for d in (int(x) for x in args.distances.split(",")):
        for p in (float(x) for x in args.ps.split(",")):
            t0 = time.perf_counter()
            row = run_point(d, p, shots, args.seed, args.decoder, batch,
                            model=args.model, iters=args.iters,
                            device=args.device)
            row["bench"] = "circuit_threshold"
            row["model"] = args.model
            row["wall_sec"] = time.perf_counter() - t0
            rows.append(row)
            print(json.dumps(row), flush=True)
    xs = crossings(rows)
    summary = {"bench": "circuit_threshold_summary",
               "decoder": args.decoder, "model": args.model,
               "pairwise_crossings": [round(x, 5) for x in xs],
               "p_th": round(float(np.mean(xs)), 5) if xs else None,
               "p_th_spread": round(float(np.std(xs)), 5) if xs else None}
    print(json.dumps(summary), flush=True)
    return rows + [summary]


if __name__ == "__main__":
    main()
