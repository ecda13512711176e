"""Per-shot side-information decoding benchmark: soft readout, heralded
erasure, leakage heralds, biased-noise DEMs — PyTorch port of
`benchmarks/sideinfo_bench.py`, with the same flags, defaults and JSON
keys. Every experiment decodes the SAME shots with and without the side
channel (or with the exact vs mis-specified model), so each JSON line
prices one information source:

  {"bench": "soft_phenomenological", "d": 5, "fail_soft": .., "fail_hard": ..}
  {"bench": "soft_device_fused", "d": 5, "shots_per_sec": .., ...}
  {"bench": "erasure", ...}
  {"bench": "leakage", "fail_heralded": .., "fail_calibrated": ..,
   "fail_blind": ..}
  {"bench": "leakage_circuit", ...}
  {"bench": "biased_dem", "fail_biased": .., "fail_uniform": ..}

Sampling runs on the card (``--cpu``: on the CPU), and so does the fused
soft decode; the other decodes run on the host, as in the reference.

    python -m qcss_tpu_torch.benchmarks.sideinfo_bench [--d 5]
        [--samples 32768] [--seed 1] [--bench all|soft|soft-device|erasure|
        leakage|leakage-circuit|biased] [--cpu]
"""

from __future__ import annotations

import argparse
import json

import torch

from qcss_tpu_torch.codes import families
from qcss_tpu_torch.sim.noise import NoiseModel


def soft_rows(code, d, samples, seed, device):
    from qcss_tpu_torch.experiments import soft

    kw = dict(rounds=d, samples=samples, batch=min(samples, 1 << 13),
              seed=seed, device=device)
    rs = soft.soft_phenomenological_error_rate(code, 3e-3, 0.7, soft=True,
                                               **kw)
    rh = soft.soft_phenomenological_error_rate(code, 3e-3, 0.7, soft=False,
                                               **kw)
    return {"bench": "soft_phenomenological", "d": d, "p": 3e-3,
            "sigma": 0.7, "q_eff": rs["q_eff"], "samples": rs["samples"],
            "fail_soft": rs["logical_fail"],
            "fail_hard": rh["logical_fail"]}


def soft_device_row(code, d, samples, seed, device):
    from qcss_tpu_torch.experiments import soft

    out = soft.soft_device_memory_rate(
        code, 3e-3, 0.7, rounds=d, batch=min(samples, 1 << 13), reps=4,
        seed=seed, device=device)
    out["bench"] = "soft_device_fused"
    out["d"] = d
    return out


def erasure_row(code, d, samples, seed, device):
    from qcss_tpu_torch.experiments.erasure import (
        erasure_phenomenological_error_rate,
    )

    kw = dict(rounds=d, samples=samples, batch=min(samples, 1 << 13),
              seed=seed, device=device)
    rh = erasure_phenomenological_error_rate(code, 1e-3, 0.01,
                                             heralded=True, **kw)
    rb = erasure_phenomenological_error_rate(code, 1e-3, 0.01,
                                             heralded=False, **kw)
    return {"bench": "erasure", "d": d, "p": 1e-3, "p_erase": 0.01,
            "samples": rh["samples"], "fail_heralded": rh["logical_fail"],
            "fail_blind": rb["logical_fail"]}


def leakage_row(code, d, samples, seed, device):
    from qcss_tpu_torch.experiments import leakage

    kw = dict(rounds=2 * d, samples=samples, batch=min(samples, 1 << 13),
              seed=seed, device=device)
    rh = leakage.leakage_memory_experiment(code, 1e-3, 5e-3, heralded=True,
                                           **kw)
    rc = leakage.leakage_memory_experiment(code, 1e-3, 5e-3, heralded=False,
                                           calibrated=True, **kw)
    rb = leakage.leakage_memory_experiment(code, 1e-3, 5e-3,
                                           heralded=False, **kw)
    return {"bench": "leakage", "d": d, "p": 1e-3, "p_leak": 5e-3,
            "samples": rh["samples"], "leak_fraction": rh["leak_fraction"],
            "fail_heralded": rh["logical_fail"],
            "fail_calibrated": rc["logical_fail"],
            "fail_blind": rb["logical_fail"]}


def leakage_circuit_row(code, d, samples, seed, device):
    from qcss_tpu_torch.experiments import leakage

    nm = NoiseModel(p_gate2=1e-3, p_meas=2e-3, p_reset=1e-3)
    kw = dict(rounds=2 * d, noise=nm, p_leak=4e-3,
              batch=min(samples, 1 << 13), seed=seed, device=device)
    rh = leakage.leakage_circuit_memory(code, heralded=True, **kw)
    rb = leakage.leakage_circuit_memory(code, heralded=False, **kw)
    return {"bench": "leakage_circuit", "d": d, "p_leak": 4e-3,
            "samples": rh["samples"], "fail_heralded": rh["word_fail"],
            "fail_calibrated_blind": rb["word_fail"]}


def biased_row(code, d, samples, seed, device):
    from qcss_tpu_torch.experiments.memory_xz import xz_memory_experiment

    biased = NoiseModel(p_gate2=4e-3, pauli2=(2.5e-4, 2.5e-4, 3.5e-3),
                        p_meas=6e-3, p_reset=2e-3)
    out_b = xz_memory_experiment(code, rounds=d, noise=biased,
                                 batch=min(samples, 1 << 13), seed=seed,
                                 device=device)
    return {"bench": "biased_dem", "d": d, "samples": out_b["samples"],
            "word_fail_biased_model": out_b["word_fail"],
            "word_fail_corr": out_b["word_fail_corr"]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=5)
    ap.add_argument("--samples", type=int, default=1 << 15)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--bench", default="all",
                    choices=["all", "soft", "soft-device", "erasure",
                             "leakage", "leakage-circuit", "biased"])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args()
    device = torch.device("cpu" if args.cpu else "cuda")
    code = families.rotated_surface(args.d)
    common = (code, args.d, args.samples, args.seed, device)
    rows = (("soft", soft_rows), ("soft-device", soft_device_row),
            ("erasure", erasure_row), ("leakage", leakage_row),
            ("leakage-circuit", leakage_circuit_row), ("biased", biased_row))
    for name, fn in rows:
        if args.bench in ("all", name):
            print(json.dumps(fn(*common)), flush=True)


if __name__ == "__main__":
    main()
