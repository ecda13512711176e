"""The repo's headline JSON line from the port (PyTorch port of the JAX
package's bench.py): the fused Steane Monte-Carlo decode, and its four
extras, on the card.

  value — Steane [[7,1,3]], p=0.01, B=2^22, 64 fused rounds a call
      (`steane_mc.run`: 2 warm-ups, 3 timed calls, each fenced by a host
      read of its failure count); samples/s. The packed decode runs K8
      then K6 on the card.
  d11_fused_sparse_shots_per_sec / d11_fused_hybrid_shots_per_sec —
      surface d=11 R=11 circuit-level DEM sampled and decoded in one
      device pipeline (`device_uf_bench.build_pipeline`, noise p_gate2 =
      2e-3, p_meas = 1e-2, d_max=48): B=2^14, 4 reps queued a trial and
      fenced once, the median of 3 trials after 2 warm trials. 'sparse'
      runs K2; 'hybrid' runs K2 with K1 behind it for the shots past
      d_max.
  d11_stream_round_shots_per_sec — the unbounded-round streaming memory
      (`stream_memory_rate`, d=11, p=q=0.004, B=2^13, R=800 after a warm
      call at R=16): rounds x shots over the timed call's wall time.
  compiled_cnot_sparse_shots_per_sec — `LogicalProgram(3, 2).cnot(0, 1)`
      run with decoder='device-uf-sparse' (p=2e-3, B=2^15, reps=4, after
      a warm call with the same reps).

Unlike bench.py, a failing extra fails the command: nothing is recorded
as a string in its place.

    python -m qcss_tpu_torch.benchmarks.headline [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.benchmarks import steane_mc

BATCH = 1 << 22
ROUNDS = 64
P_PHYS = 0.01
FUSED_BATCH = 1 << 14
FUSED_REPS = 4
STREAM_BATCH, STREAM_ROUNDS = 1 << 13, 800
CNOT_BATCH, CNOT_REPS = 1 << 15, 4
# BASELINE.md's north-star of 1e6 decoded samples/s
BASELINE_SAMPLES_PER_SEC = 1.0e6


def bench_steane(device) -> float:
    row = steane_mc.run(BATCH, ROUNDS, P_PHYS, reps=3, seed=1, device=device)
    assert row["word_fail_count"] > 0
    return row["samples_per_sec"]


def bench_d11_fused_sparse(device, decoder: str = "sparse") -> float:
    """Fused sample + sparse-UF decode, d=11 R=11 DEM at operating noise:
    the median rate of 3 trials of FUSED_REPS batches each. 'sparse' may
    report a shot past d_max as not converged; the rate is valid either
    way ('hybrid' rescues such shots in K1)."""
    from qcss_tpu_torch.benchmarks.device_uf_bench import build_pipeline
    from qcss_tpu_torch.codes.families import rotated_surface
    from qcss_tpu_torch.sim.noise import NoiseModel

    B = FUSED_BATCH
    noise = NoiseModel(p_gate2=2e-3, p_meas=1e-2)
    _, _, fused, _ = build_pipeline(rotated_surface(11), 11, noise, "dem",
                                    decoder=decoder, d_max=48, device=device)

    def run_reps(seed: int) -> int:
        gen = torch.Generator(device=device).manual_seed(seed)
        total = torch.zeros((), dtype=torch.int32, device=device)
        for _ in range(FUSED_REPS):
            f, _ = fused(gen, B, 11)
            total = total + f
        return int(total)

    run_reps(0)
    run_reps(2)
    rates = []
    for trial in range(3):
        t0 = time.perf_counter()
        run_reps(10 + trial)
        rates.append(FUSED_REPS * B / (time.perf_counter() - t0))
    return sorted(rates)[1]


def bench_d11_fused_hybrid(device) -> float:
    return bench_d11_fused_sparse(device, decoder="hybrid")


def bench_d11_stream(device) -> float:
    """Streaming memory steady-state round-shots/s at d=11."""
    from qcss_tpu_torch.codes.families import rotated_surface
    from qcss_tpu_torch.decode.device_streaming import stream_memory_rate

    code = rotated_surface(11)
    h, lz = code.raw_parity_check_c2, code.z_operator_matrix()
    stream_memory_rate(h, lz, 0.004, 0.004, rounds=16, batch=STREAM_BATCH,
                       device=device)
    t0 = time.perf_counter()
    stream_memory_rate(h, lz, 0.004, 0.004, rounds=STREAM_ROUNDS,
                       batch=STREAM_BATCH, seed=1, device=device)
    return STREAM_ROUNDS * STREAM_BATCH / (time.perf_counter() - t0)


def bench_compiled_cnot_sparse(device) -> float:
    """Compiled logical CNOT, fused device pipeline, sparse decoder."""
    from qcss_tpu_torch.experiments.logical import LogicalProgram

    prog = LogicalProgram(3, 2).cnot(0, 1)
    prog.run(2e-3, batch=CNOT_BATCH, seed=0, decoder="device-uf-sparse",
             reps=CNOT_REPS, device=device)
    t0 = time.perf_counter()
    out = prog.run(2e-3, batch=CNOT_BATCH, seed=1,
                   decoder="device-uf-sparse", reps=CNOT_REPS, device=device)
    return out["samples"] / (time.perf_counter() - t0)


def run(device="cuda") -> dict:
    """The headline row: the extras first, then the Steane headline (as
    bench.py orders them). Any exception propagates."""
    device = resolve_device(device)
    extras = {}
    for name, fn in (
        ("d11_fused_sparse_shots_per_sec", bench_d11_fused_sparse),
        ("d11_fused_hybrid_shots_per_sec", bench_d11_fused_hybrid),
        ("d11_stream_round_shots_per_sec", bench_d11_stream),
        ("compiled_cnot_sparse_shots_per_sec", bench_compiled_cnot_sparse),
    ):
        extras[name] = fn(device)
    samples_per_sec = bench_steane(device)
    return {
        "metric": "steane_mc_decode_throughput",
        "value": samples_per_sec,
        "unit": "samples/sec/card",
        "vs_baseline": samples_per_sec / BASELINE_SAMPLES_PER_SEC,
        "extras": extras,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    row = run(args.device)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
