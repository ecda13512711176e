"""Two-sector memory experiment with correlated X<->Z decoding (PyTorch
port of `qcss_tpu.experiments.memory_xz`).

Each round extracts BOTH check sectors (Z checks via CNOT fan-in, then X
checks via H-sandwich ancillas) under circuit-level noise; X data errors
are decoded from the Z-check detector stream and Z data errors from the
X-check stream, each on its exact circuit-level DEM (`decode.dem2`).

The point is the CORRELATION: a 2q depolarizing fault with a Y-type data
component fires one edge in each graph. Independent decoding ignores
this; the correlated second pass re-weights each Z-error-graph edge whose
partner was chosen by the X-error pass to the conditional likelihood
(P(Z | X) = 1/2 per location).

Word failure needs both observables, so the harness reads BOTH residual
frame sectors at the end — a simulation-level readout (the decoders are
only ever shown the detector streams).

Random stream. The sampler draws from one `torch.Generator` on the
device, in this fixed order each round:

1. the idle channel on the data qubits (one [B, n] uniform draw), only
   when ``noise.p_idle`` is set;
2. the Z-sector circuit's gate faults (`noise.sampled_fault_bits`);
3. the Z ancillas' measurement flips (or, with ``sigma``, one [B, rz]
   normal draw of the analog readout);
4. the Z ancillas' reset flips;
5. the X-sector circuit's gate faults;
6. the X ancillas' measurement flips (or the analog draw);
7. the X ancillas' reset flips.

Draws 3-7 are skipped where their rate is zero, as in the single-sector
sampler (`experiments.memory`). The reference splits six JAX keys a round
(seven with idle); the streams differ, so the two are compared by rates.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device, synchronize
from qcss_tpu_torch.decode.dem2 import build_two_sector_dem
from qcss_tpu_torch.decode.spacetime import detector_history
from qcss_tpu_torch.decode.uf import UFDecoder
from qcss_tpu_torch.experiments.memory import (
    x_extraction_circuit,
    z_extraction_circuit,
)
from qcss_tpu_torch.sim import frame as fr
from qcss_tpu_torch.sim import noise as noise_mod


def two_sector_circuits(code, hz, hx, device):
    """The two extraction circuits of the interleaved schedule on the
    n + rz + rx qubits (X ancillas after the Z ancillas), as (z_arrays,
    x_arrays, z_comp, x_comp): host arrays and, at 100 gates and up,
    their matrix forms on ``device`` (None below)."""
    n, rz = code.n, hz.shape[0]
    nq = n + rz + hx.shape[0]
    z_arrays = z_extraction_circuit(code, checks=hz).to_arrays()
    x_arrays = x_extraction_circuit(code, anc_offset=n + rz,
                                    checks=hx).to_arrays()
    comps = [fr.maybe_compile(a, nq) for a in (z_arrays, x_arrays)]
    z_comp, x_comp = (None if c is None else c.to(device) for c in comps)
    return z_arrays, x_arrays, z_comp, x_comp


def _idle_data(f: fr.Frames, generator, noise, n: int) -> fr.Frames:
    """The per-round idle channel on the n data qubits, charged at the
    round boundary — the species `dem2._fault_species` books at k=-1."""
    u = torch.rand((f.batch, n), generator=generator, device=f.x.device)
    x_hi, z_lo, z_hi = noise_mod._thresholds_1q(noise.rate_idle)
    x, z = f.x.clone(), f.z.clone()
    x[:, :n] ^= (u < x_hi).to(torch.uint8)
    z[:, :n] ^= ((u >= z_lo) & (u < z_hi)).to(torch.uint8)
    return fr.Frames(x, z)


def _extract(f, generator, noise, arrays, comp, anc, sigma):
    """One sector's extraction: the circuit with its gate faults, the
    ancillas' noisy measurement (Bernoulli flips, or the analog readout
    u ~ N(1, sigma) with a flip iff u < 0), their noisy reset. Returns
    (frames, syndrome deviations [B, m], amplitudes |u| or None)."""
    if comp is not None:
        f = fr.run_compiled_noisy(f, comp, noise, generator)
    else:
        f = fr.run_arrays_noisy(f, *arrays, noise, generator)
    amp = None
    if sigma is None:
        f, syn = fr.measure_deviations(f, anc, generator, noise.p_meas)
    else:
        f, syn = fr.measure_deviations(f, anc)
        u = 1.0 + float(sigma) * torch.randn(syn.shape, generator=generator,
                                             device=syn.device)
        syn = syn ^ (u < 0.0).to(torch.uint8)
        amp = u.abs()
    f = fr.reset_qubits(f, anc, generator, noise.p_reset)
    return f, syn, amp


def _sample_two_sector(generator, batch, rounds, code, noise, z_arrays,
                       x_arrays, z_comp, x_comp, rz, rx, sigma=None):
    """Frames sampler for the interleaved two-sector schedule on the
    generator's device, drawing in the order of the module docstring.
    Returns (syns_z [R, B, rz], syns_x [R, B, rx], x_err [B, n],
    z_err [B, n]) uint8. The reference run is deterministic in both
    sectors (|0~> is a +1 eigenstate of every stabilizer), so deviations
    are outcomes.

    ``sigma`` switches measurement noise to the analog readout model:
    each measurement draws u ~ N(1, sigma) — hard flip iff u < 0 — and
    the amplitudes |u| are appended to the return tuple
    (amps_z [B, R, rz], amps_x [B, R, rx]). The sampled flip rate is then
    Phi(-1/sigma); decoding models must use that p_meas."""
    n = code.n
    device = generator.device
    zanc = torch.arange(n, n + rz, device=device)
    xanc = torch.arange(n + rz, n + rz + rx, device=device)
    f = fr.zero_frames(batch, n + rz + rx, device)
    syns_z, syns_x, amps_z, amps_x = [], [], [], []
    for _ in range(rounds):  # the reference's lax.scan over rounds
        if noise.p_idle:
            f = _idle_data(f, generator, noise, n)
        f, syn_z, amp_z = _extract(f, generator, noise, z_arrays, z_comp,
                                   zanc, sigma)
        f, syn_x, amp_x = _extract(f, generator, noise, x_arrays, x_comp,
                                   xanc, sigma)
        syns_z.append(syn_z)
        syns_x.append(syn_x)
        amps_z.append(amp_z)
        amps_x.append(amp_x)
    out = (torch.stack(syns_z), torch.stack(syns_x), f.x[:, :n], f.z[:, :n])
    if sigma is None:
        return out
    return out + (torch.stack(amps_z, dim=1), torch.stack(amps_x, dim=1))


def xz_memory_experiment(code, *, rounds: int, noise: noise_mod.NoiseModel,
                         batch: int = 1 << 12, seed: int = 0,
                         n_threads: int | None = None,
                         belief: bool | int = False,
                         device="cuda",
                         profile: dict | None = None) -> dict[str, float]:
    """Run the two-sector memory, sampled on ``device`` (the card unless
    the caller asks for the CPU) from a generator seeded with ``seed``,
    and decode it on the host three ways on the same shots: X errors
    (always the correlated-pass INPUT), Z errors independently, and Z
    errors with the correlated re-weighting.

    Returns x_fail, z_fail / z_fail_corr, word_fail / word_fail_corr.
    ``belief`` (True, or an int BP iteration count) additionally decodes
    BOTH sectors with belief-matching (`decode.belief`: joint-graph BP
    posteriors on ``device`` as per-shot matching weights) on the same
    shots and adds x/z/word_fail_belief.

    ``profile``, a dict, receives the wall seconds of each stage, the
    device synchronized at each mark: 'sampler' (shots and detectors),
    'dem_build', 'uf' (the three matching passes) and, with ``belief``,
    'belief_build' (joint Tanner graph, DEM, decompositions), 'bp'
    (posteriors), 'weights' (`_shot_weights_kernel`) and 'belief_uf'."""
    device = resolve_device(device)
    marks = [time.perf_counter()]

    def mark(key):
        synchronize(device)
        marks.append(time.perf_counter())
        if profile is not None:
            profile[key] = marks[-1] - marks[-2]

    hz = np.asarray(code.raw_parity_check_c2, np.uint8) & 1
    hx = np.asarray(code.raw_parity_check_c1, np.uint8) & 1
    rz, rx = hz.shape[0], hx.shape[0]
    lz = np.asarray(code.z_operator_matrix(), np.uint8) & 1
    lx = np.asarray(code.x_operator_matrix(), np.uint8) & 1

    circuits = two_sector_circuits(code, hz, hx, device)
    generator = torch.Generator(device=device).manual_seed(seed)
    syns_z, syns_x, x_err, z_err = _sample_two_sector(
        generator, batch, rounds, code, noise, *circuits, rz=rz, rx=rx)
    syns_z, syns_x = syns_z.cpu().numpy(), syns_x.cpu().numpy()
    x_err, z_err = x_err.cpu().numpy(), z_err.cpu().numpy()

    final_z = (x_err.astype(np.int64) @ hz.T) & 1
    final_x = (z_err.astype(np.int64) @ hx.T) & 1
    dets_z = detector_history(syns_z, final_z.astype(np.uint8))
    dets_x = detector_history(syns_x, final_x.astype(np.uint8))
    mark("sampler")

    dem = build_two_sector_dem(code, rounds, noise)
    dec_x_err = UFDecoder(dem.graph_x_errors)
    dec_z_err = UFDecoder(dem.graph_z_errors)
    mark("dem_build")

    sel, obs_z = dec_x_err.decode_batch(dets_z, n_threads=n_threads)
    _, obs_x = dec_z_err.decode_batch(dets_x, want_corrections=False,
                                      n_threads=n_threads)
    # correlated second pass: Z-error edges coupled to a CHOSEN X-error
    # edge become cheap
    base = dem.graph_z_errors.edge_weight
    wts = np.broadcast_to(base, (batch, base.shape[0])).copy()
    if dem.pairs.size:
        chosen = sel[:, dem.pairs[:, 0]].astype(bool)  # [B, P]
        cheap_t = np.zeros((base.shape[0], batch), bool)
        np.logical_or.at(cheap_t, dem.pairs[:, 1], chosen.T)
        wts = np.where(cheap_t.T, np.uint8(dem.cheap_weight), wts)
    _, obs_xc = dec_z_err.decode_batch(dets_x, want_corrections=False,
                                       n_threads=n_threads,
                                       shot_weights=wts)

    par_x = ((x_err.astype(np.int64) @ lz[0]) & 1).astype(np.uint32)
    par_z = ((z_err.astype(np.int64) @ lx[0]) & 1).astype(np.uint32)
    xf = (obs_z & 1) != par_x
    zf = (obs_x & 1) != par_z
    zfc = (obs_xc & 1) != par_z
    mark("uf")
    out = {
        "x_fail": float(np.mean(xf)),
        "z_fail": float(np.mean(zf)),
        "z_fail_corr": float(np.mean(zfc)),
        "word_fail": float(np.mean(xf | zf)),
        "word_fail_corr": float(np.mean(xf | zfc)),
        "samples": batch,
        "rounds": rounds,
        "pairs": int(dem.pairs.shape[0]),
    }
    if belief:
        from qcss_tpu_torch.decode.belief import BeliefMatchingDecoder

        bm = BeliefMatchingDecoder(
            code, rounds, noise,
            iters=32 if belief is True else int(belief), device=device)
        obs_zb, obs_xb = bm.decode_obs(dets_z, dets_x, n_threads=n_threads)
        xfb = (obs_zb & 1) != par_x
        zfb = (obs_xb & 1) != par_z
        out["x_fail_belief"] = float(np.mean(xfb))
        out["z_fail_belief"] = float(np.mean(zfb))
        out["word_fail_belief"] = float(np.mean(xfb | zfb))
        if profile is not None:
            profile.update(belief_build=bm.timings["build"],
                           bp=bm.timings["bp"],
                           weights=bm.timings["weights"],
                           belief_uf=bm.timings["uf"])
    return out
