"""Lattice-surgery benchmark: merge, cycle, logical CNOT, and T gadget —
PyTorch port of `benchmarks/surgery_bench.py`, with the same experiments,
flags, defaults and JSON keys.

Sweeps distance (and optionally p) for the surgery experiments
(`experiments.surgery`, `experiments.surgery_t`) and the compiled
logical programs (`experiments.logical`) and prints one JSON line per
point — failure rates of the joint measurement and the preserved/output
logicals, plus model sizes and wall time. Sampling runs on the card
(``--cpu``: on the CPU); the bespoke and compiled memories decode on the
host union-find, `compiled-cnot-device` keeps sampling, decoding and
counting on the card, and the circuit tier decodes with BP and the
device OSD.

    python -m qcss_tpu_torch.benchmarks.surgery_bench
        [--experiments merge,cycle,cnot] [--distances 3,5,7] [--p 3e-3]
        [--q Q] [--batch 32768] [--weighted] [--seed 0] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from qcss_tpu_torch.experiments.patches import parity_chain_memory
from qcss_tpu_torch.experiments.surgery import (
    surgery_cnot_memory,
    xx_merge_memory,
    xx_merge_split_memory,
)
from qcss_tpu_torch.experiments.surgery_t import t_gadget_memory


def _compiled_cnot(d, p, q=None, *, batch=1 << 13, seed=0, weighted=False,
                   device="cuda"):
    from qcss_tpu_torch.experiments.logical import LogicalProgram

    return LogicalProgram(d, 2).cnot(0, 1).run(
        p, q, batch=batch, seed=seed, weighted=weighted, device=device)


def _compiled_cnot_device(d, p, q=None, *, batch=1 << 13, seed=0,
                          weighted=False, device="cuda"):
    """The fused on-device form: sample + UF decode + count on the card,
    4 timed reps after a warm-up rep (host-fenced: the counts are read
    back once a call)."""
    from qcss_tpu_torch.experiments.logical import LogicalProgram

    prog = LogicalProgram(d, 2).cnot(0, 1)
    prog.run(p, q, batch=batch, seed=seed, weighted=weighted,
             decoder="device-uf", reps=1, device=device)  # build + warm
    t0 = time.perf_counter()
    out = prog.run(p, q, batch=batch, seed=seed + 1, weighted=weighted,
                   decoder="device-uf", reps=4, device=device)
    dt = time.perf_counter() - t0
    out["shots_per_sec"] = round(out["samples"] / dt)
    return out


def _compiled_program(d, p, q=None, *, batch=1 << 13, seed=0,
                      weighted=False, device="cuda"):
    """A 3-qubit logical program: CNOT(0,1); T(1); CNOT(1,2) — every op
    the compiler supports, routed over one grid."""
    from qcss_tpu_torch.experiments.logical import LogicalProgram

    return LogicalProgram(d, 3).cnot(0, 1).t(1).cnot(1, 2).run(
        p, q, batch=batch, seed=seed, weighted=weighted, device=device)


def _circuit_cnot(d, p, q=None, *, batch=1 << 12, seed=0,
                  weighted=False, device="cuda"):
    """Compiled CNOT at CIRCUIT-LEVEL noise: real two-sector extraction
    circuits, BP(+OSD) on the circuit fault Tanner graph (q ignored —
    uniform p on gate/meas/reset locations)."""
    from qcss_tpu_torch.experiments.logical import LogicalProgram
    from qcss_tpu_torch.sim.noise import NoiseModel

    noise = NoiseModel(p_gate1=p, p_gate2=p, p_meas=p, p_reset=p)
    return LogicalProgram(d, 2).cnot(0, 1).run_circuit(
        noise, batch=batch, seed=seed, device=device)


def _circuit_program(d, p, q=None, *, batch=1 << 12, seed=0,
                     weighted=False, device="cuda"):
    """CNOT(0,1); T(1); CNOT(1,2) at circuit-level noise."""
    from qcss_tpu_torch.experiments.logical import LogicalProgram
    from qcss_tpu_torch.sim.noise import NoiseModel

    noise = NoiseModel(p_gate1=p, p_gate2=p, p_meas=p, p_reset=p)
    return LogicalProgram(d, 3).cnot(0, 1).t(1).cnot(1, 2).run_circuit(
        noise, batch=batch, seed=seed, device=device)


EXPERIMENTS = {
    "merge": xx_merge_memory,
    "cycle": xx_merge_split_memory,
    "cnot": surgery_cnot_memory,
    "tgadget": t_gadget_memory,
    "chain": parity_chain_memory,
    "compiled-cnot": _compiled_cnot,
    "compiled-cnot-device": _compiled_cnot_device,
    "compiled-program": _compiled_program,
    "circuit-cnot": _circuit_cnot,
    "circuit-program": _circuit_program,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--experiments", default="merge,cycle,cnot")
    ap.add_argument("--distances", default="3,5,7")
    ap.add_argument("--p", type=float, default=3e-3)
    ap.add_argument("--q", type=float, default=None)
    ap.add_argument("--batch", type=int, default=1 << 15)
    ap.add_argument("--weighted", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch versions)")
    args = ap.parse_args()
    device = torch.device("cpu" if args.cpu else "cuda")
    for name in args.experiments.split(","):
        fn = EXPERIMENTS[name]
        for d in (int(x) for x in args.distances.split(",")):
            t0 = time.perf_counter()
            out = fn(d, args.p, args.q, batch=args.batch, seed=args.seed,
                     weighted=args.weighted, device=device)
            out.update({"bench": f"surgery_{name}",
                        "wall_sec": round(time.perf_counter() - t0, 2)})
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
