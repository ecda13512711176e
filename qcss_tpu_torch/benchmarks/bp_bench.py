"""BP(+OSD) qLDPC decoder benchmark (PyTorch port of the JAX package's
benchmarks/bp_bench.py, every row of it).

Measures the batched belief-propagation decoder (`decode.bp`) on the
bivariate-bicycle memories it exists for:

* code capacity per code (``--codes``): BP alone timed on the device,
  then `decode_obs` with its OSD tail for the failure rate;
* the phenomenological spacetime Tanner decode (``--spacetime``, R =
  ``--rounds`` or the code's distance, measurement noise ``--q``), timed
  and scored the same way;
* sliding-window BP over an R-round phenomenological stream (``--stream
  R``): `BPStreamingDecoder`'s round-shots/s, the stream sampled on the
  device;
* the soft-output gap post-selection curve (``--gap``): `decode_obs_gap`
  at code capacity, the kept share and conditional failure at each tau;
* the whole-history circuit-level memory (``--circuit R --sectors``):
  `qldpc_memory_experiment` timed whole, its graph build included, with
  the split of its time into sampler, Tanner-graph build, detector
  assembly, BP and OSD, BP's iterations, the OSD tail and the peak device
  memory;
* the circuit-level sliding-window stream (``--circuit-stream R``):
  `qldpc_stream_memory_rate`'s round-shots/s.

Uniform circuit noise ``--p`` on every channel, as the reference bench.
Prints one JSON line per row, each naming its device:

    python -m qcss_tpu_torch.benchmarks.bp_bench --codes bb144 \\
        --circuit 12 --sectors both --batch 8192     # on the card
    python -m qcss_tpu_torch.benchmarks.bp_bench --cpu --codes bb72 \\
        --batch 128 --circuit 2                      # a rehearsal
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from qcss_tpu_torch._cuda import synchronize
from qcss_tpu_torch.codes import families
from qcss_tpu_torch.decode.bp import BPDecoder, spacetime_tanner, use_device
from qcss_tpu_torch.experiments.memory_qldpc import (
    qldpc_memory_experiment,
    qldpc_stream_memory_rate,
)
from qcss_tpu_torch.sim.noise import NoiseModel

CODES = {
    "bb72": families.bb72,
    "bb90": families.bb90,
    "bb144": families.bb144,
    "bb288": families.bb288,
}


def _device_name(device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def uniform_noise(p: float) -> NoiseModel:
    return NoiseModel(p_gate2=p, p_gate1=p, p_meas=p, p_reset=p)


def _time_decode(dec: BPDecoder, syn: np.ndarray, reps: int, device) -> float:
    """Median seconds of BP alone (`dec._run`) over ``reps`` calls after
    two warm-ups, the device synchronized around each."""
    syn_t = torch.as_tensor(syn, dtype=torch.uint8, device=device)
    ts = []
    for rep in range(reps + 2):
        synchronize(device)
        t0 = time.perf_counter()
        dec._run(syn_t)
        synchronize(device)
        if rep >= 2:
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def bench_code_capacity(name: str, p: float, batch: int, iters: int,
                        reps: int, seed: int, device) -> dict:
    """BP's device time on code-capacity syndromes (median of ``reps``
    after two warm-ups, the device synchronized), then the failure rate
    of `decode_obs` with its OSD tail."""
    code = CODES[name]()
    h2 = code.redundant_parity_check_c2
    lz = code.z_operator_matrix()
    rng = np.random.default_rng(seed)
    errs = (rng.random((batch, code.n)) < 2.0 * p / 3.0).astype(np.uint8)
    syn = (errs @ h2.T) & 1
    dec = BPDecoder(h2, 2.0 * p / 3.0, logicals=lz, iters=iters,
                    device=device)
    sec = _time_decode(dec, syn, reps, device)
    flips, conv = dec.decode_obs(syn)
    true_flip = (errs.astype(np.int64) @ lz.T.astype(np.int64)) & 1
    fail = (flips ^ true_flip).any(axis=1)
    return {
        "bench": "bp_code_capacity", "code": name, "device":
        _device_name(device), "n": code.n, "k": code.k, "p": p,
        "batch": batch, "iters": iters, "bp_ms": sec * 1e3,
        "shots_per_sec": batch / sec,
        "x_fail": float(fail.mean()),
        "bp_converged": float(np.asarray(conv).mean()),
    }


def spacetime_case(name: str, rounds: int, p: float, q: float, batch: int,
                   seed: int):
    """The spacetime row's inputs: (Tanner graph [D, V], priors [V],
    observable rows [k, V], fault draws [B, V] from numpy at ``seed``,
    syndromes [B, D])."""
    code = CODES[name]()
    tan, priors, obs, _ = spacetime_tanner(
        code.redundant_parity_check_c2, rounds, p, q,
        logicals=code.z_operator_matrix())
    rng = np.random.default_rng(seed)
    ev = (rng.random((batch, tan.shape[1])) < priors[None, :]).astype(np.uint8)
    syn = (ev.astype(np.int64) @ tan.T.astype(np.int64)) & 1
    return tan, priors, obs, ev, syn


def bench_spacetime(name: str, rounds: int, p: float, q: float, batch: int,
                    iters: int, reps: int, seed: int, device) -> dict:
    """The R-round phenomenological spacetime Tanner decode: BP alone timed
    on the device, then `decode_obs` for the word failure over the code's
    logicals."""
    tan, priors, obs, ev, syn = spacetime_case(name, rounds, p, q, batch,
                                               seed)
    dec = BPDecoder(tan, priors, logicals=obs, iters=iters, device=device)
    sec = _time_decode(dec, syn, reps, device)
    flips, conv = dec.decode_obs(syn)
    true_flip = (ev.astype(np.int64) @ obs.T.astype(np.int64)) & 1
    fail = (flips ^ true_flip).any(axis=1)
    return {
        "bench": "bp_spacetime", "code": name, "device":
        _device_name(device), "rounds": rounds, "p": p, "q": q,
        "batch": batch, "iters": iters,
        "detectors": int(tan.shape[0]), "variables": int(tan.shape[1]),
        "bp_ms": sec * 1e3, "shots_per_sec": batch / sec,
        "word_fail": float(fail.mean()),
        "bp_converged": float(np.asarray(conv).mean()),
    }


def bench_stream(name: str, rounds: int, p: float, q: float, batch: int,
                 window: int, commit: int, iters: int, seed: int,
                 device) -> dict:
    """Sliding-window BP streaming: the stream sampled on the device from a
    generator seeded ``seed``, a warm decode of its first max(8, B/8)
    shots, then the whole stream's decode timed (round-shots/s)."""
    from qcss_tpu_torch.decode.bp_streaming import BPStreamingDecoder
    from qcss_tpu_torch.decode.streaming import sample_phenomenological_stream

    code = CODES[name]()
    h2 = code.redundant_parity_check_c2
    lz = code.z_operator_matrix()
    with use_device(device):
        dec = BPStreamingDecoder(h2, lz, p, q, window=window, commit=commit,
                                 iters=iters)
        gen = torch.Generator(device=device).manual_seed(seed)
        dets, par = sample_phenomenological_stream(gen, p, q, batch, rounds,
                                                   h2, lz)
        dets = dets.cpu().numpy()
        dec.decode_stream(dets[: max(8, batch // 8)])  # warm the windows
        t0 = time.perf_counter()
        flips, conv = dec.decode_stream(dets)
        sec = time.perf_counter() - t0
    fail = (flips ^ par.cpu().numpy()).any(axis=1)
    return {
        "bench": "bp_stream", "code": name, "device": _device_name(device),
        "rounds": rounds, "p": p, "q": q, "batch": batch, "window": window,
        "commit": commit, "round_shots_per_sec": batch * rounds / sec,
        "x_fail": float(fail.mean()),
        "all_windows_converged": float(np.asarray(conv).mean()),
    }


def bench_circuit(name: str, rounds: int, p: float, batch: int,
                  iters: int, seed: int, sectors: str, device,
                  bp_kwargs: dict | None = None,
                  profile: dict | None = None) -> dict:
    """Whole-history circuit-level memory: two-sector extraction-circuit
    sampling and exact detector-fault Tanner BP(+OSD). The wall time
    covers the whole call, the Tanner graphs' build included (a
    cold-start figure; ``split_s`` gives each part). ``profile`` receives
    `qldpc_memory_experiment`'s profile (the OSD tails and their inputs)."""
    code = CODES[name]()
    prof = {} if profile is None else profile
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    synchronize(device)
    t0 = time.perf_counter()
    out = qldpc_memory_experiment(code, rounds=rounds,
                                  noise=uniform_noise(p), batch=batch,
                                  iters=iters, seed=seed, sectors=sectors,
                                  bp_kwargs=bp_kwargs, device=device,
                                  profile=prof)
    synchronize(device)
    sec = time.perf_counter() - t0
    split = {k: prof[k] for k in ("sample_s", "build_s", "detectors_s",
                                  "decode_s") if k in prof}
    for s in ("z", "x"):
        st = prof.get(s)
        if st is not None:
            split.update({f"bp_{s}_s": st["bp_s"], f"osd_{s}_s": st["osd_s"]})
            out.update({f"bp_iters_{s}": st["iters"],
                        f"osd_tail_{s}": st["tail"],
                        f"osd_backend_{s}": st["tail_backend"],
                        f"osd_host_fallback_{s}": st["host_fallback"]})
    out.update({
        "bench": "bp_circuit_memory", "code": name, "device":
        _device_name(device), "p": p, "wall_s": sec,
        "shots_per_sec": batch / sec, "split_s": split,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 2**30
                        if device.type == "cuda" else None),
    })
    return out


def bench_circuit_stream(name: str, rounds: int, p: float, batch: int,
                         window: int, commit: int, iters: int, seed: int,
                         device) -> dict:
    """Circuit-level sliding-window BP: end-to-end (two-sector extraction
    sampling + windowed decode) rate under uniform circuit noise p."""
    code = CODES[name]()
    out = qldpc_stream_memory_rate(code, uniform_noise(p), rounds=rounds,
                                   batch=batch, window=window,
                                   commit=commit, iters=iters, seed=seed,
                                   device=device)
    out.update({"bench": "bp_circuit_stream", "code": name,
                "device": _device_name(device), "p": p})
    return out


def bench_gap(name: str, p: float, batch: int, iters: int, seed: int,
              device, taus=(0.0, 5.0, 10.0, 20.0)) -> dict:
    """Soft-output gap post-selection curve at code capacity: one timed
    `decode_obs_gap` call, then the kept share and conditional word
    failure at each tau."""
    code = CODES[name]()
    h2 = code.redundant_parity_check_c2
    lz = code.z_operator_matrix()
    rng = np.random.default_rng(seed)
    errs = (rng.random((batch, code.n)) < 2.0 * p / 3.0).astype(np.uint8)
    syn = (errs @ h2.T) & 1
    dec = BPDecoder(h2, 2.0 * p / 3.0, logicals=lz, iters=iters,
                    device=device)
    synchronize(device)
    t0 = time.perf_counter()
    flips, _, gap = dec.decode_obs_gap(syn)
    sec = time.perf_counter() - t0
    true_flip = (errs.astype(np.int64) @ lz.T.astype(np.int64)) & 1
    fail = (flips ^ true_flip).any(axis=1)
    curve = []
    for tau in taus:
        keep = gap >= tau
        curve.append({"tau": tau, "keep": float(keep.mean()),
                      "cond_fail": float(fail[keep].mean())
                      if keep.any() else None})
    return {
        "bench": "bp_gap_postselect", "code": name, "device":
        _device_name(device), "p": p, "batch": batch,
        "shots_per_sec": batch / sec,
        "word_fail": float(fail.mean()), "curve": curve,
    }


def main(argv=None) -> list[dict]:
    """Parse ``argv`` (the command line by default), print the JSON rows
    and return them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--codes", default="bb72,bb144")
    ap.add_argument("--p", type=float, default=0.003)
    ap.add_argument("--q", type=float, default=0.003)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spacetime", action="store_true",
                    help="also run the R=d phenomenological Tanner decode")
    ap.add_argument("--stream", type=int, default=0, metavar="R",
                    help="also run R-round sliding-window BP streaming")
    ap.add_argument("--gap", action="store_true",
                    help="also run the soft-output gap post-selection curve")
    ap.add_argument("--circuit", type=int, default=0, metavar="R",
                    help="also run the R-round whole-history circuit-level "
                    "memory (uniform circuit noise --p)")
    ap.add_argument("--sectors", default="z", choices=["z", "both"])
    ap.add_argument("--circuit-stream", type=int, default=0, metavar="R",
                    help="also run R-round circuit-level sliding-window BP")
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--commit", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=0,
                    help="spacetime rounds (default: the code's distance)")
    ap.add_argument("--gamma", type=float, default=0.0,
                    help="min-sum message damping (memory-BP)")
    ap.add_argument("--restarts", type=int, default=0,
                    help="perturbed re-decodes of the unconverged tail")
    ap.add_argument("--osd-order", type=int, default=0,
                    help="OSD-E combination-sweep order (0 = OSD-0)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (a rehearsal; its times are not "
                    "the card's)")
    args = ap.parse_args(argv)
    device = torch.device("cpu" if args.cpu else "cuda")
    bp_kwargs = {}
    if args.gamma:
        bp_kwargs["gamma"] = args.gamma
    if args.restarts:
        bp_kwargs["restarts"] = args.restarts
    if args.osd_order:
        bp_kwargs["osd_order"] = args.osd_order
    dists = {"bb72": 6, "bb90": 10, "bb144": 12, "bb288": 18}
    rows = []

    def emit(row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    for name in args.codes.split(","):
        emit(bench_code_capacity(
            name, args.p, args.batch, args.iters, args.reps, args.seed,
            device))
        if args.spacetime:
            emit(bench_spacetime(
                name, args.rounds or dists[name], args.p, args.q,
                args.batch, args.iters, args.reps, args.seed, device))
        if args.stream:
            emit(bench_stream(
                name, args.stream, args.p, args.q, args.batch, args.window,
                args.commit, args.iters, args.seed, device))
        if args.gap:
            emit(bench_gap(name, args.p, args.batch, args.iters, args.seed,
                           device))
        if args.circuit:
            emit(bench_circuit(
                name, args.circuit, args.p, args.batch, args.iters,
                args.seed, args.sectors, device, bp_kwargs=bp_kwargs))
        if args.circuit_stream:
            emit(bench_circuit_stream(
                name, args.circuit_stream, args.p, args.batch,
                args.window, args.commit, args.iters, args.seed, device))
    return rows

if __name__ == "__main__":
    main()
