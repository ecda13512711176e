"""The fused sample-and-decode pipeline of the memory experiment (PyTorch
port of `benchmarks/device_uf_bench.py::build_pipeline`).

`build_pipeline` returns ``(graph, sample, fused, sample_dets)``; each of
the three callables takes ``(generator, batch, rounds)`` with a
`torch.Generator` on the pipeline's device:

* ``sample`` — frame-sampled (syns [R, B, r], word [B, n]);
* ``fused`` — sample, assemble detectors, decode, count: returns device
  scalars (logical failures, all shots converged);
* ``sample_dets`` — (detectors [B, (R+1)r] uint8, logical parity [B]).

`run` times the fused pipeline and sampling alone on a CUDA device
(`chip_smoke.py` drives it).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.codes.families import rotated_surface
from qcss_tpu_torch.decode.device_uf import make_obs_decoder
from qcss_tpu_torch.decode.spacetime import detector_history
from qcss_tpu_torch.decode.uf import spacetime_graph
from qcss_tpu_torch.experiments import memory as M
from qcss_tpu_torch.ops import gf2_torch
from qcss_tpu_torch.sim import frame as fr
from qcss_tpu_torch.sim.noise import NoiseModel


def build_pipeline(code, rounds, noise, graph_kind: str,
                   decoder: str = "dense", d_max: int = 48, device="cuda"):
    device = resolve_device(device)
    raw = code.raw_parity_check_c2
    logicals = code.z_operator_matrix()
    if graph_kind == "dem":
        from qcss_tpu_torch.decode.dem import (
            circuit_level_graph,
            extraction_gate_list,
        )

        graph = circuit_level_graph(
            raw, extraction_gate_list(code, raw), rounds,
            p_gate2=noise.p_gate2, p_meas=noise.p_meas,
            p_reset=noise.p_reset, logicals=logicals)
    else:
        graph = spacetime_graph(raw, logicals, rounds)
    if decoder == "dense":
        decode_fn = make_obs_decoder(graph, device=device)
    elif decoder == "sparse":
        from qcss_tpu_torch.decode.device_sparse import (
            make_sparse_obs_decoder,
        )

        decode_fn = make_sparse_obs_decoder(graph, d_max=d_max,
                                            device=device)
        if decode_fn is None:
            raise ValueError("graph refused the sparse path")
    elif decoder == "hybrid":
        from qcss_tpu_torch.decode.device_sparse import (
            make_hybrid_obs_decoder,
        )

        decode_fn = make_hybrid_obs_decoder(graph, d_max=d_max,
                                            device=device)
    else:
        raise ValueError(f"unknown decoder {decoder!r}")
    ext = M.z_extraction_circuit(code, checks=raw).to_arrays()
    comp = fr.maybe_compile(ext, code.n + raw.shape[0])
    if comp is not None:
        comp = comp.to(device)
    raw_t = torch.as_tensor(np.asarray(raw, np.uint8), device=device)
    log_row = torch.as_tensor(np.asarray(logicals[0], np.int32),
                              device=device)

    def sample(generator, batch, rounds):
        return M._memory_circuit_frames(
            generator, batch, rounds, code, noise, ext, n_anc=raw.shape[0],
            extract_comp=comp)

    def dets_of(syns, word):
        final = gf2_torch.syndromes_dense(word, raw_t)
        return detector_history(syns, final)

    def fused(generator, batch, rounds):
        syns, word = sample(generator, batch, rounds)
        obs, conv = decode_fn(dets_of(syns, word))
        outcome = (word.to(torch.int32) * log_row[None, :]).sum(-1) & 1
        return (outcome ^ (obs & 1)).to(torch.int32).sum(), conv.all()

    def sample_dets(generator, batch, rounds):
        syns, word = sample(generator, batch, rounds)
        par = (word.to(torch.int32) * log_row[None, :]).sum(-1) & 1
        return dets_of(syns, word), par

    return graph, sample, fused, sample_dets


def run(d: int, rounds: int, batch: int, reps: int, noise: NoiseModel,
        graph_kind: str, decoder: str, seed: int = 0) -> dict:
    """Time the fused pipeline, and sampling alone, on the GPU: one
    warm-up batch, then ``reps`` batches, each fenced by a host read of
    its counts."""
    if not torch.cuda.is_available():
        raise RuntimeError("the fused pipeline benchmark needs a CUDA device")
    dev = torch.device("cuda")
    code = rotated_surface(d)
    graph, sample, fused, _ = build_pipeline(code, rounds, noise, graph_kind,
                                             decoder=decoder, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def timed(step):
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = [step() for _ in range(reps)]
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    def fused_step():
        f, conv = fused(gen, batch, rounds)
        if not bool(conv):
            # the sparse decoder reports shots with more than d_max
            # defects so; the dense and hybrid decoders never should
            raise RuntimeError(f"{decoder}: a shot did not converge")
        return int(f)

    dt, fails = timed(fused_step)
    dt_s, _ = timed(lambda: int(sample(gen, batch, rounds)[1].sum()))
    return {
        "bench": "fused_sample_decode", "d": d, "rounds": rounds,
        "graph": graph_kind, "decoder": decoder, "batch": batch,
        "reps": reps, "detectors": graph.num_nodes,
        "edges": graph.num_edges,
        "shots_per_sec": reps * batch / dt,
        "sample_only_shots_per_sec": reps * batch / dt_s,
        "logical_fail": sum(fails) / (reps * batch),
        "p_gate2": noise.p_gate2, "p_meas": noise.p_meas,
        "device": torch.cuda.get_device_name(0),
    }
