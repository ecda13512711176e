"""Stabilizer-tableau measurement throughput: the unpacked tableau (a byte
per bit), the packed tableau's scan and the fused measurement kernel K9,
at surface-code scale (the counterpart of `benchmarks/tableau_bench.py`).

Batched measurement is the dominant cost of FT protocols (every EC round
measures whole ancilla blocks). Each engine measures 32 qubits, evenly
spaced, of the ladder state (H on every qubit, then a CNOT ladder: every
row dense) at each qubit count, on ``device`` (the card by default):

* ``unpacked``: `sim.tableau.measure_many`, plain torch;
* ``packed``: `sim.tableau_packed.measure_many`, the scan (plain torch);
* ``packed-fused``: `sim.cuda_measure.measure_many_fused`, which launches
  K9 for a tableau on the card (on the CPU it runs the scan).

Each call draws its collapse bits from a seeded generator; a call's time
is the host clock around it, fenced by reading the outcomes' sum back, as
the reference fences its reps. Prints one JSON line per (n, engine), each
naming the device it ran on.

Usage: python -m qcss_tpu_torch.benchmarks.tableau_bench
           [--batch 4096] [--qubits 49 121 363] [--reps 3]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.circuits.ir import Circuit
from qcss_tpu_torch.sim import cuda_measure
from qcss_tpu_torch.sim import tableau as tb
from qcss_tpu_torch.sim import tableau_packed as tp

ENGINES = ("unpacked", "packed", "packed-fused")
N_MEASURE = 32


def ladder_circuit(n: int) -> Circuit:
    """H layer + CNOT ladder: entangles everything (worst case for
    measurement, every row dense)."""
    circ = Circuit()
    for q in range(n):
        circ.h(q)
    for q in range(n - 1):
        circ.cnot(q, q + 1)
    return circ


def measured_qubits(n: int, n_measure: int = N_MEASURE) -> np.ndarray:
    return np.arange(n_measure) * (n // n_measure)


def run(batch: int = 4096, qubits=(49, 121, 363), reps: int = 3,
        seed: int = 0, device="cuda") -> list[dict]:
    """One row per (n, engine): measurements x samples per second, the
    seconds of one call and the device's name."""
    device = resolve_device(device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    measure = {"unpacked": tb.measure_many, "packed": tp.measure_many,
               "packed-fused": cuda_measure.measure_many_fused}
    rows = []
    for n in qubits:
        circ = ladder_circuit(n)
        packed = tp.run_circuit(tp.zero_state(batch, n, device), circ)
        state = {"unpacked": tb.run_circuit(tb.zero_state(batch, n, device),
                                            circ),
                 "packed": packed, "packed-fused": packed}
        qs = measured_qubits(n)
        for name in ENGINES:
            gen = torch.Generator(device=device).manual_seed(seed)
            int(measure[name](state[name], qs, gen)[1].sum())  # warm-up
            t0 = time.perf_counter()
            for _ in range(reps):
                int(measure[name](state[name], qs, gen)[1].sum())
            secs = (time.perf_counter() - t0) / reps
            rows.append({
                "metric": "tableau_measure_throughput",
                "engine": name,
                "n_qubits": n,
                "batch": batch,
                "measured": len(qs),
                "value": batch * len(qs) / secs,
                "unit": "measurements*samples/sec",
                "seconds_per_call": secs,
                "device": where,
            })
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--qubits", type=int, nargs="+", default=[49, 121, 363])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    for row in run(args.batch, args.qubits, args.reps):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
