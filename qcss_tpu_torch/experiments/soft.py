"""Soft-readout (analog measurement) decoding (PyTorch port of
`qcss_tpu.experiments.soft`).

Real hardware does not measure bits: a syndrome readout returns an
ANALOG value (integrated homodyne voltage, photon count), and the
"measurement outcome" is a threshold decision on it. Hard-decision
decoding throws the confidence away; soft decoding hands the decoder a
per-measurement flip likelihood, so a marginal readout (analog value
near the decision boundary) is cheap to blame and a clean one expensive.

Model: a readout whose true outcome is m returns a = (-1)^m + sigma*N(0,1)
(symmetric Gaussian blobs at +-1); the hard decision is the sign. The
hard assignment error rate is q_eff = Phi(-1/sigma), and the posterior
flip probability given the observed amplitude |a| is

    P(flip | a) = 1 / (1 + exp(2|a|/sigma^2))

(the likelihood ratio of the two blobs at distance |a| from the
boundary). Both decoders in this module consume exactly that posterior:

* matching tier (`soft_phenomenological_error_rate`): the spacetime
  matching graph's TIME edges are the measurement flips — per-shot
  -log-likelihood growth weights ride the union-find kernel's
  ``shot_weights`` override (`UFDecoder.decode_batch`), same mechanism
  as heralded erasure (`experiments/erasure.py`);
* BP tier (`soft_bp_phenomenological_error_rate`): the spacetime Tanner
  graph's measurement VARIABLES (`bp.spacetime_tanner` layout) get
  per-shot priors (`BPDecoder.decode_batch(priors=...)`) — the qLDPC
  form, where matching does not apply.

Every experiment decodes the SAME sampled shots twice — soft and
hard-decision (static weights/priors at q_eff) — so the value of the
analog side information is priced on identical physics.

Random streams: samplers draw from `torch.Generator`s on the device.
`_sample_soft_stream` draws the data flips, then the analog values.
Where the reference splits one JAX key per chunk (or per rep), chunk i
draws from its own generator (`sim.noise.chunk_generators`); the
circuit-level experiments draw from one generator seeded with ``seed``
(`memory_xz._sample_two_sector`'s order). So the shots are held against
the reference by rates, and the decodes, given the shots, bit for bit.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from scipy.stats import norm

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.decode.uf import (
    UFDecoder,
    _pack_parity,
    graph_from_checks,
    spacetime_graph,
)
from qcss_tpu_torch.ops import gf2_torch
from qcss_tpu_torch.sim.noise import chunk_generators


def flip_prob(sigma: float) -> float:
    """Hard-decision assignment error rate of the +-1 Gaussian readout:
    q_eff = Phi(-1/sigma)."""
    if sigma <= 0:
        return 0.0
    return float(norm.cdf(-1.0 / sigma))


def sigma_for_flip_prob(q: float) -> float:
    """Inverse of `flip_prob` — the readout width whose hard-decision
    error rate is q (for calibrated soft-vs-hard comparisons)."""
    if not 0.0 < q < 0.5:
        raise ValueError("q must lie in (0, 0.5)")
    return float(-1.0 / norm.ppf(q))


def posterior_flip_prob(amp, sigma: float):
    """P(hard decision wrong | observed amplitude |a| = amp)."""
    amp = np.asarray(amp, np.float64)
    return 1.0 / (1.0 + np.exp(2.0 * amp / (sigma * sigma)))


def _sample_soft_stream(generator, p, sigma, batch, rounds, n, h, lz):
    """Phenomenological stream with ANALOG measurement readout: IID data
    flips at rate p before each of `rounds` noisy extraction rounds, one
    final data layer, perfect final readout. Each noisy measurement
    draws u ~ N(1, sigma) — the analog value relative to the true blob —
    so the hard decision flips iff u < 0 and |u| is the observed
    amplitude. ``h``, ``lz``: uint8 tensors on the generator's device.
    Draws the [rounds+1, B, n] data uniforms, then the [rounds, B, r]
    normals. Returns (detectors [B, (rounds+1)*r] uint8, parities [B, k]
    uint8, amplitudes [B, rounds, r] float32)."""
    device = generator.device
    r = h.shape[0]
    errs = (torch.rand((rounds + 1, batch, n), generator=generator,
                       device=device) < p).to(torch.uint8)
    u = 1.0 + float(sigma) * torch.randn((rounds, batch, r),
                                         generator=generator, device=device)
    flips = (u < 0.0).to(torch.uint8)
    cum = (torch.cumsum(errs.to(torch.int32), dim=0) & 1).to(torch.uint8)
    syns = gf2_torch.syndromes_dense(cum[:rounds], h) ^ flips  # [R, B, r]
    final = gf2_torch.syndromes_dense(cum[rounds], h)
    dets = torch.cat([syns[:1], syns[1:] ^ syns[:-1],
                      (final ^ syns[rounds - 1])[None]], dim=0)
    detectors = dets.permute(1, 0, 2).reshape(batch, (rounds + 1) * r)
    par = gf2_torch.mod2_matmul(cum[rounds], lz.T)
    return detectors, par, u.abs().permute(1, 0, 2)


def _llr_weights(p_edge: np.ndarray, base: float,
                 cap: int = 250, resolution: int = 2) -> np.ndarray:
    """-log-likelihood growth weights on `weights_from_probs`'s scale
    generalized to finer units: w = clip(round(resolution * ln p /
    ln p_max), 1, cap). Per-shot soft weights and the static graph share
    one `base = ln p_max` AND one resolution so they are comparable
    unit-for-unit; resolution=2 is the classic `weights_from_probs`
    pace, larger values resolve smaller likelihood differences (at the
    cost of more union-find growth rounds)."""
    w = np.rint(resolution * np.log(np.clip(p_edge, 1e-30, 1 - 1e-9))
                / base)
    return np.clip(w, 1, cap).astype(np.uint8)


def _code_tensors(code, device):
    """(h, lz) of the X-memory as uint8 tensors on ``device``."""
    h = np.asarray(code.raw_parity_check_c2, np.uint8)
    lz = np.asarray(code.z_operator_matrix(), np.uint8) & 1
    return (torch.as_tensor(h, device=device),
            torch.as_tensor(lz, device=device))


def soft_phenomenological_error_rate(
    code,
    p: float,
    sigma: float,
    *,
    rounds: int | None = None,
    samples: int = 1 << 13,
    batch: int | None = None,
    seed: int = 0,
    soft: bool = True,
    use_native: bool | None = None,
    resolution: int = 8,
    device="cuda",
) -> dict[str, float]:
    """Multi-round phenomenological X-memory with analog syndrome
    readout, decoded with spacetime union-find on the host. ``soft=True``
    gives the decoder per-measurement flip likelihoods (time-edge
    ``shot_weights`` from the observed amplitudes); ``soft=False``
    decodes the same shots hard-decision (static weights at q_eff =
    `flip_prob(sigma)`). Both arms decode the same graph at the same
    weight `resolution` (units per factor-of-p_max likelihood), so the
    comparison prices the analog information itself, not weight
    quantization. Sampling runs on ``device``, chunk i from
    `chunk_generators(seed, ...)[i]`."""
    import dataclasses

    device = resolve_device(device)
    h = code.raw_parity_check_c2
    lz = code.z_operator_matrix()
    if rounds is None:
        rounds = 2 * code.t + 1
    batch = samples if batch is None else batch
    q_eff = max(flip_prob(sigma), 1e-9)
    p_eff = max(p, 1e-9)
    base_g = graph_from_checks(h, lz)
    graph = spacetime_graph(h, lz, rounds, p_space=p_eff, p_time=q_eff)
    n_space = base_g.num_edges * (rounds + 1)
    # time edge for (round t, check c) sits at n_space + t*r + c
    # (spacetime_graph layout: space edges first, then t-major time edges)
    base_ln = np.log(max(p_eff, q_eff))
    probs = np.concatenate([np.full(n_space, p_eff),
                            np.full(graph.num_edges - n_space, q_eff)])
    static_w = _llr_weights(probs, base_ln, resolution=resolution)
    graph = dataclasses.replace(graph, edge_weight=static_w)
    dec = UFDecoder(graph, use_native=use_native)
    h_t, lz_t = _code_tensors(code, device)

    n_chunks = -(-samples // batch)
    fails = 0
    for gen in chunk_generators(seed, n_chunks, device):
        dets, par, amp = (a.cpu().numpy() for a in _sample_soft_stream(
            gen, p, sigma, batch, rounds, code.n, h_t, lz_t))
        sw = None
        if soft:
            p_flip = posterior_flip_prob(amp.reshape(batch, -1), sigma)
            sw = np.tile(static_w, (batch, 1))
            sw[:, n_space:] = _llr_weights(p_flip, base_ln,
                                           resolution=resolution)
        _, obs = dec.decode_batch(dets, want_corrections=False,
                                  shot_weights=sw)
        fails += int(np.sum(obs != _pack_parity(par)))
    n_samples = n_chunks * batch
    return {
        "logical_fail": fails / n_samples,
        "samples": n_samples,
        "rounds": rounds,
        "p": p,
        "sigma": sigma,
        "q_eff": q_eff,
        "soft": soft,
    }


def _soft_shot_weights(amp, sigma, resolution, base_ln, w_space):
    """The fused pipeline's per-shot weights on the device: amplitudes
    [B, rounds, r] float32 -> [B, E] int32, the static space weights
    ``w_space`` ([n_space] int32) then the time edges' weights
    clip(rint(resolution * ln P(flip | amp) / base_ln), 1, 250), the
    posterior clipped to [1e-9, 0.499], all in float32."""
    B = amp.shape[0]
    sig2 = float(sigma) * float(sigma)
    pf = torch.clamp(torch.sigmoid(-2.0 * amp.reshape(B, -1) / sig2),
                     1e-9, 0.499)
    wt_t = torch.clamp(torch.round(resolution * torch.log(pf)
                                   / float(base_ln)), 1, 250)
    return torch.cat([w_space[None, :].expand(B, -1),
                      wt_t.to(torch.int32)], dim=1)


def _fused_soft_graph(code, p, sigma, rounds, resolution):
    """The fused pipeline's spacetime graph (static weights of the
    reference's `spacetime_graph` at p and q_eff), its space edges'
    resolution-``resolution`` weights, and the weights' base ln p_max."""
    h = code.raw_parity_check_c2
    lz = np.asarray(code.z_operator_matrix(), np.uint8) & 1
    q_eff = max(flip_prob(sigma), 1e-9)
    p_eff = max(p, 1e-9)
    graph = spacetime_graph(h, lz, rounds, p_space=p_eff, p_time=q_eff)
    n_space = graph_from_checks(h, lz).num_edges * (rounds + 1)
    base_ln = np.log(max(p_eff, q_eff))
    w_space = _llr_weights(np.full(n_space, p_eff), base_ln,
                           resolution=resolution)
    return graph, w_space, base_ln


def _soft_device_step(code, p, sigma, rounds, resolution, batch, device):
    """The fused analog-readout pipeline's rep on ``device``:
    ``step(generator)`` samples ``batch`` shots of the stream, turns the
    amplitudes into per-shot weights, union-find-decodes and returns
    (failures, all converged) as device scalars; nothing is read back."""
    from qcss_tpu_torch.decode import device_uf

    graph, w_space, base_ln = _fused_soft_graph(code, p, sigma, rounds,
                                                resolution)
    dg = device_uf.build_device_graph(graph, stencil=False).to(device)
    w_space_t = torch.as_tensor(w_space.astype(np.int32), device=device)
    h_t, lz_t = _code_tensors(code, device)
    pow2 = torch.as_tensor(1 << np.arange(lz_t.shape[0]),
                           dtype=torch.int32, device=device)

    def step(gen):
        dets, par, amp = _sample_soft_stream(gen, p, sigma, batch, rounds,
                                             code.n, h_t, lz_t)
        sw = _soft_shot_weights(amp, sigma, resolution, base_ln, w_space_t)
        labels, conv = device_uf.decode_labels(dg, dets, shot_weights=sw)
        par_bits = torch.sum(par.to(torch.int32) * pow2[None, :], dim=1)
        return torch.sum(labels[0] != par_bits), torch.all(conv)

    return step


def soft_device_memory_rate(
    code,
    p: float,
    sigma: float,
    *,
    rounds: int | None = None,
    batch: int = 1 << 12,
    reps: int = 4,
    seed: int = 0,
    resolution: int = 8,
    device="cuda",
) -> dict[str, float]:
    """FUSED analog-readout pipeline ON THE DEVICE: stream sampling,
    analog amplitudes -> per-shot posterior LLR weights, union-find
    decode (`device_uf.decode_labels(shot_weights=)`), and failure
    counting all run on ``device`` — the amplitudes (the largest per-shot
    side-information array) never cross to the host; only the failure
    count and one convergence flag a rep do.

    Rep i draws from `chunk_generators(seed, reps + 2)[i]`; the last two
    generators drive two warm-up reps, and every rep is fenced by a host
    read of its count."""
    device = resolve_device(device)
    if rounds is None:
        rounds = 2 * code.t + 1
    q_eff = max(flip_prob(sigma), 1e-9)
    step = _soft_device_step(code, p, sigma, rounds, resolution, batch,
                             device)
    gens = chunk_generators(seed, reps + 2, device)
    # double warm-up, each fenced by a host read of its count
    int(step(gens[-1])[0])
    int(step(gens[-2])[0])
    fails = 0
    t0 = time.perf_counter()
    for i in range(reps):
        nf, conv = step(gens[i])
        fails += int(nf)
        assert bool(conv)
    dt = time.perf_counter() - t0
    n_samples = reps * batch
    return {
        "logical_fail": fails / n_samples,
        "samples": n_samples,
        "rounds": rounds,
        "p": p,
        "sigma": sigma,
        "q_eff": q_eff,
        "shots_per_sec": n_samples / dt,
    }


def _combine(p1, p2):
    """Probability an ODD number of two independent faults fired."""
    return p1 + p2 - 2.0 * p1 * p2


def _meas_edge_ids(index_sector: dict, rounds: int, r_c: int) -> np.ndarray:
    """[rounds, r_c] int32: DEM edge id of the measurement-flip edge of
    (round t, check c) — the time-like edge between detectors (t, c) and
    (t+1, c) with trivial observable. Raises if any is missing (it never
    is when p_meas > 0: the measurement species always books it)."""
    ids = np.empty((rounds, r_c), np.int32)
    for t in range(rounds):
        for c in range(r_c):
            k = ((t * r_c + c, (t + 1) * r_c + c), 0)
            if k not in index_sector:
                raise ValueError(f"no measurement edge for round {t} "
                                 f"check {c}")
            ids[t, c] = index_sector[k]
    return ids


def _analog_two_sector(code, rounds, noise_eff, sigma, batch, seed, hz, hx,
                       device):
    """`memory_xz._sample_two_sector` in analog mode on ``device``, from a
    generator seeded with ``seed``, as numpy: (syns_z, syns_x, x_err,
    z_err, amps_z [B, R, rz], amps_x [B, R, rx])."""
    from qcss_tpu_torch.experiments import memory_xz

    circuits = memory_xz.two_sector_circuits(code, hz, hx, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(a.cpu().numpy() for a in memory_xz._sample_two_sector(
        gen, batch, rounds, code, noise_eff, *circuits, rz=hz.shape[0],
        rx=hx.shape[0], sigma=float(sigma)))


def soft_xz_memory_experiment(
    code,
    *,
    rounds: int,
    noise,
    sigma: float,
    batch: int = 1 << 12,
    seed: int = 0,
    soft: bool = True,
    n_threads: int | None = None,
    resolution: int = 8,
    device="cuda",
) -> dict[str, float]:
    """CIRCUIT-LEVEL two-sector memory with analog syndrome readout,
    decoded on the host on the exact circuit-level DEMs (`decode.dem2`)
    with per-shot measurement-edge weights.

    The sampler is `memory_xz._sample_two_sector` in analog mode on
    ``device`` (every measurement draws u ~ N(1, sigma); hard flip iff
    u < 0), so the decoding model is the standard DEM built at p_meas =
    q_eff = `flip_prob(sigma)` — same physics, same graphs. A merged
    time-like edge carries MORE than the measurement flip (late ancilla
    faults and last-round resets land on the same detector pair), so the
    soft update replaces only the measurement component's share:
    p_edge(shot) = (p_static - q_eff) + P(flip | amplitude), keeping the
    DEM's linear-merge convention. ``soft=False`` decodes the same shots
    with the static weights — the hard-decision ablation. `noise` is the
    circuit noise WITHOUT measurement flips (its p_meas is ignored; the
    readout model replaces it)."""
    import dataclasses

    from qcss_tpu_torch.decode.dem2 import build_two_sector_dem
    from qcss_tpu_torch.decode.spacetime import detector_history

    device = resolve_device(device)
    q_eff = flip_prob(sigma)
    noise_eff = dataclasses.replace(noise, p_meas=q_eff)
    hz = np.asarray(code.raw_parity_check_c2, np.uint8) & 1
    hx = np.asarray(code.raw_parity_check_c1, np.uint8) & 1
    rz, rx = hz.shape[0], hx.shape[0]
    lz = np.asarray(code.z_operator_matrix(), np.uint8) & 1
    lx = np.asarray(code.x_operator_matrix(), np.uint8) & 1

    syns_z, syns_x, x_err, z_err, amps_z, amps_x = _analog_two_sector(
        code, rounds, noise_eff, sigma, batch, seed, hz, hx, device)

    final_z = ((x_err.astype(np.int64) @ hz.T) & 1).astype(np.uint8)
    final_x = ((z_err.astype(np.int64) @ hx.T) & 1).astype(np.uint8)
    dets_z = detector_history(syns_z, final_z)
    dets_x = detector_history(syns_x, final_x)

    dem, index = build_two_sector_dem(code, rounds, noise_eff,
                                      return_index=True)
    out = {"samples": batch, "rounds": rounds, "sigma": sigma,
           "q_eff": q_eff, "soft": soft}
    par = {
        "z": ((x_err.astype(np.int64) @ lz[0]) & 1).astype(np.uint32),
        "x": ((z_err.astype(np.int64) @ lx[0]) & 1).astype(np.uint32),
    }
    fails = {}
    for sector, graph, pkey, dets, amps, r_c in (
            ("z", dem.graph_x_errors, "x_errors", dets_z, amps_z, rz),
            ("x", dem.graph_z_errors, "z_errors", dets_x, amps_x, rx)):
        probs = dem.edge_probs[pkey]
        base = np.log(probs.max())
        # re-derive the static weights at the chosen resolution so soft
        # and hard decode the SAME rescaled graph (fair ablation)
        static_w = _llr_weights(probs, base, resolution=resolution)
        graph = dataclasses.replace(graph, edge_weight=static_w)
        dec = UFDecoder(graph)
        sw = None
        if soft:
            eids = _meas_edge_ids(index[sector], rounds, r_c)
            p_other = np.clip(probs[eids.ravel()] - q_eff, 1e-12, 0.499)
            # amps is [B, rounds, r_c] — same (t, c) raveling as eids
            p_flip = posterior_flip_prob(amps.reshape(batch, -1), sigma)
            p_soft = np.clip(p_other[None, :] + p_flip, 1e-12, 0.499)
            sw = np.tile(static_w, (batch, 1))
            sw[:, eids.ravel()] = _llr_weights(p_soft, base,
                                               resolution=resolution)
        _, obs = dec.decode_batch(dets, want_corrections=False,
                                  n_threads=n_threads, shot_weights=sw)
        fails[sector] = (obs & 1) != par[sector]
    out["x_fail"] = float(np.mean(fails["z"]))   # X errors, Z-check stream
    out["z_fail"] = float(np.mean(fails["x"]))
    out["word_fail"] = float(np.mean(fails["z"] | fails["x"]))
    return out


def soft_qldpc_circuit_memory(
    code,
    *,
    rounds: int,
    noise,
    sigma: float,
    batch: int = 1 << 12,
    seed: int = 0,
    soft: bool = True,
    iters: int = 48,
    alpha: float = 0.8,
    osd: bool = True,
    sectors: str = "both",
    device="cuda",
) -> dict[str, float]:
    """CIRCUIT-LEVEL qLDPC memory with analog readout, decoded by BP on
    ``device`` on the circuit fault Tanner graphs with per-shot
    measurement-variable priors. The Tanner merge is odds-combining, so
    the measurement component's share is split out as p_other = (p_v -
    q_eff)/(1 - 2 q_eff) and recombined per shot with P(flip |
    amplitude). Same-shots hard ablation via ``soft=False``; `noise`
    carries the circuit noise (its p_meas is ignored — the readout model
    replaces it)."""
    import dataclasses

    from qcss_tpu_torch.decode.bp import BPDecoder
    from qcss_tpu_torch.decode.bp_dem import build_circuit_tanner
    from qcss_tpu_torch.decode.dem2 import _RoundCircuit
    from qcss_tpu_torch.decode.spacetime import detector_history

    device = resolve_device(device)
    q_eff = flip_prob(sigma)
    noise_eff = dataclasses.replace(noise, p_meas=q_eff)
    hz = np.asarray(getattr(code, "redundant_parity_check_c2",
                            code.raw_parity_check_c2), np.uint8) & 1
    hx = np.asarray(getattr(code, "redundant_parity_check_c1",
                            code.raw_parity_check_c1), np.uint8) & 1
    rz, rx = hz.shape[0], hx.shape[0]
    lz = np.asarray(code.z_operator_matrix(), np.uint8) & 1
    lx = np.asarray(code.x_operator_matrix(), np.uint8) & 1

    syns_z, syns_x, x_err, z_err, amps_z, amps_x = _analog_two_sector(
        code, rounds, noise_eff, sigma, batch, seed, hz, hx, device)

    circ = _RoundCircuit(code, hz=hz, hx=hx)
    out = {"samples": batch, "rounds": rounds, "sigma": sigma,
           "q_eff": q_eff, "soft": soft}
    fail_any = None
    todo = (("z",), ("z", "x"))[sectors == "both"]
    for sector in todo:
        tan, mmap = build_circuit_tanner(code, rounds, noise_eff,
                                         sector=sector, hz=hz, hx=hx,
                                         with_map=True)
        r_c = rz if sector == "z" else rx
        var_ids = np.empty((rounds, r_c), np.int32)
        for k, op in enumerate(circ.ops):
            if op[0] == "measure" and op[2] == sector:
                for t in range(rounds):
                    var_ids[t, op[3]] = mmap[(("meas", k), t)]
        priors = np.clip(tan.priors, 1e-12, 0.499)
        dec = BPDecoder(tan.checks, priors, logicals=tan.obs,
                        iters=iters, alpha=alpha, osd=osd, device=device)
        if sector == "z":
            errs, h, lg, syns, amps = x_err, hz, lz, syns_z, amps_z
        else:
            errs, h, lg, syns, amps = z_err, hx, lx, syns_x, amps_x
        final = ((errs.astype(np.int64) @ h.T) & 1).astype(np.uint8)
        dets = detector_history(syns, final).reshape(batch, -1)
        pri = None
        if soft:
            p_v = priors[var_ids.ravel()]
            p_other = np.clip((p_v - q_eff) / (1.0 - 2.0 * q_eff),
                              0.0, 0.499)
            p_flip = posterior_flip_prob(amps.reshape(batch, -1), sigma)
            pri = np.tile(priors, (batch, 1))
            pri[:, var_ids.ravel()] = np.clip(
                _combine(p_other[None, :], p_flip), 1e-12, 0.499)
        flips, conv = dec.decode_obs(dets, priors=pri)
        par = (errs.astype(np.int64) @ lg.T.astype(np.int64)) & 1
        f = (flips ^ par).any(axis=1)
        key = "x_fail" if sector == "z" else "z_fail"
        out[key] = float(f.mean())
        out[f"bp_converged_{sector}"] = float(np.asarray(conv).mean())
        fail_any = f if fail_any is None else (fail_any | f)
    if sectors == "both":
        out["word_fail"] = float(fail_any.mean())
    return out


def soft_bp_phenomenological_error_rate(
    code,
    p: float,
    sigma: float,
    *,
    rounds: int,
    samples: int = 1 << 12,
    batch: int | None = None,
    seed: int = 0,
    soft: bool = True,
    iters: int = 64,
    alpha: float = 0.8,
    osd: bool = True,
    device="cuda",
) -> dict[str, float]:
    """qLDPC form: phenomenological memory with analog readout, decoded
    by spacetime BP(+OSD) on ``device`` whose measurement-variable priors
    are set per shot from the observed amplitudes (``soft=True``) or
    statically at q_eff (``soft=False``). Same-shots comparison, like the
    UF tier; chunk i draws from `chunk_generators(seed, ...)[i]`."""
    from qcss_tpu_torch.decode.bp import BPDecoder, spacetime_tanner

    device = resolve_device(device)
    h = getattr(code, "redundant_parity_check_c2", None)
    if h is None:
        h = code.raw_parity_check_c2
    h = np.asarray(h, np.uint8) & 1
    lz = code.z_operator_matrix()
    batch = samples if batch is None else batch
    q_eff = max(flip_prob(sigma), 1e-9)
    tan, priors, obs, n_data = spacetime_tanner(
        h, rounds, max(p, 1e-9), q_eff, logicals=lz)
    dec = BPDecoder(tan, priors, logicals=obs, iters=iters, alpha=alpha,
                    osd=osd, device=device)
    h_t = torch.as_tensor(h, device=device)
    lz_t = torch.as_tensor(np.asarray(lz, np.uint8), device=device)

    n_chunks = -(-samples // batch)
    fails = 0
    n_conv = 0
    for gen in chunk_generators(seed, n_chunks, device):
        dets, par, amp = (a.cpu().numpy() for a in _sample_soft_stream(
            gen, p, sigma, batch, rounds, code.n, h_t, lz_t))
        pri = None
        if soft:
            # measurement variable (t, c) sits at n_data + t*r + c —
            # exactly the amp layout flattened
            p_flip = np.clip(posterior_flip_prob(
                amp.reshape(batch, -1), sigma), 1e-9, 0.499)
            pri = np.tile(priors, (batch, 1))
            pri[:, n_data:] = p_flip
        flips, conv = dec.decode_obs(dets, priors=pri)
        fails += int(np.sum((flips ^ par).any(axis=1)))
        n_conv += int(conv.sum())
    n_samples = n_chunks * batch
    return {
        "logical_fail": fails / n_samples,
        "bp_converged": n_conv / n_samples,
        "samples": n_samples,
        "rounds": rounds,
        "p": p,
        "sigma": sigma,
        "q_eff": q_eff,
        "soft": soft,
    }
