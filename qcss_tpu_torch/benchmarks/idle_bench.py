"""Idle-noise ancilla-schedule comparison (PyTorch port of the JAX
package's benchmarks/idle_bench.py).

The reference protocol warns that its shared EC ancillas "limit
parallelism, which significantly reduces fault tolerance" (reference:
ftqc.py:156-160) but cannot measure the cost — its noise model has no
idle locations. This harness measures it: the same multi-block program
under idle noise, on the 'frames' engine, run with

  * ancillas='shared'                      (the reference's layout)
  * ancillas='dedicated'                   (own pair per block, EC still
                                            serialized block-by-block)
  * ancillas='dedicated' ec_schedule='parallel'
                                           (all blocks' EC rounds at once)

Prints one JSON line per configuration, with the JAX package's keys.
With p_idle = 0 all three agree statistically (dedicated ancillas are
freshly verified per use); with idle noise on, waiting blocks decohere
through their neighbors' EC and the serialized schedules fall behind.

Usage:
    python -m qcss_tpu_torch.benchmarks.idle_bench [--blocks 2]
        [--shots 32768] [--chunk 8192] [--p-gate2 3e-4] [--p-idle 3e-4]
        [--decoherence [--t1 --t2 --ro --idle-time]] [--device cuda]
        [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import time

from qcss_tpu_torch.circuits import Program
from qcss_tpu_torch.codes import families
from qcss_tpu_torch.ftqc import rewrite_program
from qcss_tpu_torch.sim.noise import NoiseModel

CONFIGS = (("shared", "serial"), ("dedicated", "serial"),
           ("dedicated", "parallel"))


def program(blocks: int) -> Program:
    """X on every block, then measure every block."""
    prog = Program()
    ro = prog.declare("ro", blocks)
    for b in range(blocks):
        prog.x(b)
    for b in range(blocks):
        prog.measure(b, ro[b])
    return prog


def run(noise: NoiseModel, *, blocks: int = 2, shots: int = 1 << 15,
        chunk: int = 1 << 13, decoherence: bool = False, device="cuda",
        seed: int = 0, configs=CONFIGS) -> list[dict]:
    """One row per (ancillas, ec_schedule): failures (any block not 1)
    over ``shots // chunk`` timed calls of ``chunk`` shots, after two warm
    calls, each fenced by a host read."""
    code = families.steane()
    prog = program(blocks)
    rows = []
    for ancillas, sched in configs:
        enc = rewrite_program(prog, code, noise=noise, tableau="frames",
                              ancillas=ancillas, ec_schedule=sched,
                              device=device)
        enc.run(chunk, seed + 99)
        enc.run(chunk, seed + 98)
        fails = 0
        t0 = time.perf_counter()
        for i in range(shots // chunk):
            res = enc.run(chunk, seed + 500 + i)
            fails += int((res["ro"] != 1).any(axis=1).sum())
        dt = time.perf_counter() - t0
        n = (shots // chunk) * chunk
        rows.append({
            "bench": ("idle_schedule_decoherence" if decoherence
                      else "idle_schedule"),
            "ancillas": ancillas,
            "ec_schedule": sched,
            "blocks": blocks,
            "p_gate2": noise.p_gate2,
            "p_idle": noise.p_idle,
            "shots": n,
            "fails": fails,
            "fail_rate": fails / n,
            "shots_per_sec": round(n / dt),
        })
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--p-gate2", type=float, default=3e-4)
    ap.add_argument("--p-idle", type=float, default=3e-4)
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--shots", type=int, default=1 << 15)
    ap.add_argument("--chunk", type=int, default=1 << 13)
    ap.add_argument("--decoherence", action="store_true",
                    help="use Pauli-twirled T1/T2 decoherence "
                         "(--t1/--t2/--ro/--idle-time) instead of flat "
                         "p_gate2/p_idle rates")
    ap.add_argument("--t1", type=float, default=100e-6)
    ap.add_argument("--t2", type=float, default=100e-6)
    ap.add_argument("--ro", type=float, default=0.995)
    ap.add_argument("--idle-time", type=float, default=150e-9)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="added to every call's seed (99, 98, then 500 + i)")
    args = ap.parse_args()

    if args.decoherence:
        noise = NoiseModel.from_decoherence(
            args.t1, args.t2, ro_fidelity=args.ro,
            idle_time=args.idle_time)
    else:
        noise = NoiseModel(p_gate2=args.p_gate2, p_idle=args.p_idle)
    for row in run(noise, blocks=args.blocks, shots=args.shots,
                   chunk=args.chunk, decoherence=args.decoherence,
                   device=args.device, seed=args.seed):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
