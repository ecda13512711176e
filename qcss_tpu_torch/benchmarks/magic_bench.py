"""Magic-state distillation benchmark (PyTorch port of the JAX package's
benchmarks/magic_bench.py).

The reference's universal-gate path is an explicit stub (`_apply_universal`
returns None, reference: css_code.py:433-434): it supports NO non-Clifford
gate and hence no universal computation. This harness measures the
framework's universality layer (`ftqc/magic.py`):

  * exact one-level 15-to-1 map and its cascade (coset weight enumeration,
    2^{r_2} exact — the 35 p^3 law and raw-state factory costs),
  * batched device Monte-Carlo throughput of the protocol-level map,
  * circuit-level distillation on the Pauli-frame engine (noisy Cliffords:
    encoded |+̄> prep + injected twirled T inputs + real X extraction) —
    the Clifford-noise floor a factory designer needs,
  * the end-to-end factory (`experiments.injection.factory_report`).

Prints one JSON line per measurement, with the JAX package's keys. Seeds
take the place of its keys: the warm-up calls draw from ``--seed``, rep r
from ``--seed + r + 1`` and the factory from ``--seed + 7`` (the JAX
package's seeds at the default 0). Every timed call ends in a host read
of its counts.

Usage:
    python -m qcss_tpu_torch.benchmarks.magic_bench [--p-in 1e-2]
        [--levels 3] [--mc-batch 16777216] [--circuit-batch 1048576]
        [--p-clifford 1e-4] [--extractions 1] [--reps 3] [--device cuda]
        [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import time

from qcss_tpu_torch.codes import families
from qcss_tpu_torch.experiments.injection import factory_report
from qcss_tpu_torch.ftqc import magic
from qcss_tpu_torch.sim.noise import NoiseModel


def main(argv=None) -> list[dict]:
    """Parse ``argv`` (the command line by default), print the JSON rows
    and return them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--p-in", type=float, default=1e-2)
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--mc-batch", type=int, default=1 << 24)
    ap.add_argument("--circuit-batch", type=int, default=1 << 20)
    ap.add_argument("--p-clifford", type=float, default=1e-4)
    ap.add_argument("--extractions", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev, s = args.device, args.seed
    rows = []

    def emit(row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    for lv in magic.distill_cascade(args.p_in, args.levels):
        emit({"tier": "exact", **{k: float(v) for k, v in lv.items()}})

    # Protocol-level Monte-Carlo throughput (warm up, then host-fence reps).
    magic.distill_mc(args.p_in, args.mc_batch, seed=s, device=dev)
    t0 = time.perf_counter()
    for rep in range(args.reps):
        mc = magic.distill_mc(args.p_in, args.mc_batch, seed=s + rep + 1,
                              device=dev)
    dt = (time.perf_counter() - t0) / args.reps
    emit({"tier": "mc", **mc, "sec": dt,
          "samples_per_sec": args.mc_batch / dt})

    noise = NoiseModel(p_gate1=args.p_clifford, p_gate2=args.p_clifford,
                       p_meas=args.p_clifford, p_reset=args.p_clifford)
    magic.distill_circuit(noise, args.p_in, args.circuit_batch,
                          extractions=args.extractions, seed=s, device=dev)
    t0 = time.perf_counter()
    for rep in range(args.reps):
        cc = magic.distill_circuit(noise, args.p_in, args.circuit_batch,
                                   extractions=args.extractions,
                                   seed=s + rep + 1, device=dev)
    dt = (time.perf_counter() - t0) / args.reps
    exact = magic.distill_exact(args.p_in)
    emit({"tier": "circuit", "p_clifford": args.p_clifford, **cc, "sec": dt,
          "samples_per_sec": args.circuit_batch / dt,
          "floor_over_exact": cc["p_out"] / exact["p_out"]})

    # End-to-end factory: measured injection eps on the Steane code feeds
    # the exact cascade (physical T error -> final magic-state fidelity).
    rep = factory_report(families.steane(), noise, args.p_clifford * 10,
                         levels=args.levels, batch=args.circuit_batch,
                         seed=s + 7, device=dev)
    emit({"tier": "factory", "p_clifford": args.p_clifford,
          "p_t": args.p_clifford * 10,
          "inject_eps": rep["injection"]["eps"],
          "inject_accept": rep["injection"]["p_accept"],
          "p_out": rep["p_out"],
          "injections_per_state": rep["injections_per_state"]})
    return rows


if __name__ == "__main__":
    main()
