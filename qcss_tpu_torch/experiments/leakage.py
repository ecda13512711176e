"""Leakage: persistent per-qubit loss of the computational subspace
(PyTorch port of `qcss_tpu.experiments.leakage`).

Real qubits leak (|2> states in transmons, loss in neutral atoms):
unlike a Pauli fault, leakage PERSISTS — a leaked qubit is effectively
depolarized every round until it decays or is reset, so one leakage
event produces a time-correlated error COLUMN, not a point fault. No
independent-edge detector error model can represent that correlation;
the decoding answer is per-shot side information (leakage detection
units, readout discrimination): herald masks become per-shot weight
overrides on the union-find decoders (host
`UFDecoder.decode_batch(shot_weights=...)` or the device decoders'
``shot_weights`` input — `decode.device_uf`).

Model (round-level state machine, the phenomenological tier):

* each intact data qubit LEAKS with probability ``p_leak`` per round;
* each leaked qubit SEEPS back with probability ``p_seep`` per round
  (mean dwell 1/p_seep rounds), returning in a random computational
  state;
* while leaked, the qubit contributes a 1/2 X-component flip per round
  (maximally mixed over the sector under study — the standard
  depolarizing-leakage reduction) and its checks see exactly what the
  syndrome map propagates (no extra measurement randomization at this
  tier: ancillas are fresh each round);
* intact qubits suffer the usual IID data flips ``p``; measurements
  flip with ``q``.

Decoding: the spacetime matching graph with the leak record as heralds
— a qubit leaked in round t makes its slice-t space edge near-free
(`ERASED_WEIGHT`), the same mechanism as heralded erasure
(`experiments.erasure`) but over INTERVALS. ``heralded=False`` decodes
the same shots blind (static weights) — the ablation that prices the
leakage detection hardware.

Random streams: samplers draw from `torch.Generator`s on the device in
the order their docstrings list. Where the reference splits one JAX key
per chunk, chunk i draws from its own generator
(`sim.noise.chunk_generators`); the circuit-level sampler draws from one
generator seeded with ``seed``. The shots are held against the reference
by rates, the decodes, given the shots, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.decode.uf import (
    MatchingGraph,
    UFDecoder,
    _pack_parity,
    graph_from_checks,
    spacetime_graph,
)
from qcss_tpu_torch.experiments.erasure import ERASED_WEIGHT, _pauli_weight
from qcss_tpu_torch.ops import gf2_torch
from qcss_tpu_torch.sim.noise import chunk_generators


def _uniform(generator, shape):
    return torch.rand(shape, generator=generator, device=generator.device)


def _sample_leakage_stream(generator, p, q, p_leak, p_seep, batch, rounds,
                           n, h, lz):
    """Phenomenological stream with a persistent leakage state machine,
    on the generator's device (``h``, ``lz``: uint8 tensors there).
    Each round draws, in order: the [B, n] leak uniforms, the [B, n]
    flip uniforms, the [B, r] measurement uniforms, the [B, n] seepage
    uniforms; then one [B, n] draw randomizes the still-leaked qubits at
    the final readout. Returns (detectors [B, (rounds+1)*r], parities
    [B, k], leaked [B, rounds+1, n] — the herald record; layer `rounds`
    is the leak state at final readout, whose 1/2 flip is charged in that
    layer), uint8."""
    device = generator.device
    r = h.shape[0]
    leak = torch.zeros((batch, n), dtype=torch.uint8, device=device)
    cum = torch.zeros((batch, n), dtype=torch.uint8, device=device)
    syns, heralds = [], []
    for _ in range(rounds):  # the reference's lax.scan over rounds
        # state machine first: new leaks, then seepage (a qubit leaking
        # and seeping in one round still randomizes that round)
        leak = leak | (_uniform(generator, (batch, n)) < p_leak
                       ).to(torch.uint8)
        u = _uniform(generator, (batch, n))
        err = torch.where(leak == 1, (u < 0.5).to(torch.uint8),
                          (u < p).to(torch.uint8))
        cum = cum ^ err
        syn = gf2_torch.syndromes_dense(cum, h)
        flip = (_uniform(generator, (batch, r)) < q).to(torch.uint8)
        syns.append(syn ^ flip)
        heralds.append(leak)
        leak = leak & (_uniform(generator, (batch, n)) >= p_seep
                       ).to(torch.uint8)
    # final readout: still-leaked qubits read out randomly (one more 1/2
    # flip, heralded in the final layer); the readout itself is perfect
    u = _uniform(generator, (batch, n))
    cum = cum ^ (leak & (u < 0.5).to(torch.uint8))
    final = gf2_torch.syndromes_dense(cum, h)
    dets = [syns[0]]
    for t in range(1, rounds):
        dets.append(syns[t] ^ syns[t - 1])
    dets.append(final ^ syns[rounds - 1])
    par = gf2_torch.mod2_matmul(cum, lz.T)
    return (torch.cat(dets, dim=-1), par,
            torch.stack(heralds + [leak], dim=1))


def _space_edge_index(base: MatchingGraph, rounds: int) -> np.ndarray:
    """[rounds+1, n_qubits] spacetime edge index of qubit j's slice-t
    space edge (-1 for check-free qubits); `spacetime_graph` layout."""
    idx = np.full((rounds + 1, base.n_qubits), -1, np.int32)
    for t in range(rounds + 1):
        for e, qb in enumerate(base.edge_qubit):
            idx[t, qb] = t * base.num_edges + e
    return idx


def _anc_leak(generator, syn, p_leak_anc):
    """A leaked ancilla's randomized outcome: draws the [B, m] leak
    uniforms, then the [B, m] coin uniforms. Returns (outcomes, leaked)."""
    anc = (_uniform(generator, syn.shape) < p_leak_anc).to(torch.uint8)
    coin = (_uniform(generator, syn.shape) < 0.5).to(torch.uint8)
    return syn ^ (anc & coin), anc


def _sample_two_sector_leak(generator, batch, rounds, code, noise,
                            z_arrays, x_arrays, z_comp, x_comp, rz, rx,
                            p_leak, p_seep, p_leak_anc):
    """`memory_xz._sample_two_sector` with a persistent DATA-qubit
    leakage state machine and per-round ANCILLA leakage, on the
    generator's device. Leaked data qubits draw independent 1/2 X and
    1/2 Z flips at each round boundary (exactly where dem2 books its
    k=-1 idle species — the decoder's static model stays in lockstep); a
    leaked ancilla's measurement outcome is randomized (^= Bernoulli(1/2)).

    Each round draws, in order: the [B, n] leak uniforms, the leaked
    qubits' [B, n] X and [B, n] Z coin uniforms, the Z-sector circuit's
    gate faults, the Z ancillas' measurement flips, their leak and coin
    uniforms, their reset flips, then the same five for the X sector,
    and last the [B, n] seepage uniforms (draws of a zero rate are
    skipped, as in `memory_xz`). Returns (syns_z [R, B, rz], syns_x
    [R, B, rx], x_err [B, n], z_err [B, n], herald_data [B, R, n],
    herald_anc_z [B, R, rz], herald_anc_x [B, R, rx]), uint8."""
    from qcss_tpu_torch.sim import frame as fr

    n = code.n
    device = generator.device
    zanc = torch.arange(n, n + rz, device=device)
    xanc = torch.arange(n + rz, n + rz + rx, device=device)
    f = fr.zero_frames(batch, n + rz + rx, device)
    leak = torch.zeros((batch, n), dtype=torch.uint8, device=device)
    outs = {k: [] for k in ("sz", "sx", "hd", "hz", "hx")}
    for _ in range(rounds):  # the reference's lax.scan over rounds
        leak = leak | (_uniform(generator, (batch, n)) < p_leak
                       ).to(torch.uint8)
        xr = (_uniform(generator, (batch, n)) < 0.5).to(torch.uint8) & leak
        zr = (_uniform(generator, (batch, n)) < 0.5).to(torch.uint8) & leak
        x, z = f.x.clone(), f.z.clone()
        x[:, :n] ^= xr
        z[:, :n] ^= zr
        f = fr.Frames(x, z)
        syn = {}
        for sector, arrays, comp, anc in (("z", z_arrays, z_comp, zanc),
                                          ("x", x_arrays, x_comp, xanc)):
            if comp is not None:
                f = fr.run_compiled_noisy(f, comp, noise, generator)
            else:
                f = fr.run_arrays_noisy(f, *arrays, noise, generator)
            f, s = fr.measure_deviations(f, anc, generator, noise.p_meas)
            syn[sector], hanc = _anc_leak(generator, s, p_leak_anc)
            outs["h" + sector].append(hanc)
            f = fr.reset_qubits(f, anc, generator, noise.p_reset)
        outs["sz"].append(syn["z"])
        outs["sx"].append(syn["x"])
        outs["hd"].append(leak)
        leak = leak & (_uniform(generator, (batch, n)) >= p_seep
                       ).to(torch.uint8)
    return (torch.stack(outs["sz"]), torch.stack(outs["sx"]), f.x[:, :n],
            f.z[:, :n], torch.stack(outs["hd"], dim=1),
            torch.stack(outs["hz"], dim=1), torch.stack(outs["hx"], dim=1))


def expected_leak_profile(p_leak: float, p_seep: float,
                          rounds: int) -> np.ndarray:
    """Deterministic per-round expected leak fraction of the state
    machine (leak events first, herald, then seepage)."""
    out = np.empty(rounds)
    l = 0.0
    for t in range(rounds):
        l = l + (1.0 - l) * p_leak
        out[t] = l
        l *= (1.0 - p_seep)
    return out


def leakage_circuit_memory(
    code,
    *,
    rounds: int,
    noise,
    p_leak: float,
    p_seep: float = 0.2,
    p_leak_anc: float | None = None,
    batch: int = 1 << 12,
    seed: int = 0,
    heralded: bool = True,
    n_threads: int | None = None,
    device="cuda",
) -> dict[str, float]:
    """CIRCUIT-LEVEL two-sector memory under leakage, sampled on
    ``device`` and decoded on the host on the exact circuit-level DEMs.
    The static model sees leakage as its round-boundary idle species at
    the AVERAGE leak fraction (exact lockstep: the sampler randomizes
    leaked data qubits at the round boundary, where dem2 books k=-1 idle
    species) plus a measurement-flip surplus of p_leak_anc/2 for
    randomized leaked-ancilla readouts; heralds make the leaked qubit's
    idle edges and the leaked ancilla's measurement edge near-free PER
    SHOT. ``heralded=False`` decodes the same shots blind. `noise` must
    carry no idle channel (leakage replaces it at this tier)."""
    import dataclasses

    from qcss_tpu_torch.decode.dem2 import build_two_sector_dem
    from qcss_tpu_torch.decode.spacetime import detector_history
    from qcss_tpu_torch.experiments.memory_xz import two_sector_circuits
    from qcss_tpu_torch.experiments.soft import _meas_edge_ids

    if noise.p_idle:
        raise ValueError("leakage replaces the idle channel at this "
                         "tier; pass noise with p_idle=0")
    device = resolve_device(device)
    if p_leak_anc is None:
        p_leak_anc = p_leak
    hz = np.asarray(code.raw_parity_check_c2, np.uint8) & 1
    hx = np.asarray(code.raw_parity_check_c1, np.uint8) & 1
    rz, rx = hz.shape[0], hx.shape[0]
    lz = np.asarray(code.z_operator_matrix(), np.uint8) & 1
    lx = np.asarray(code.x_operator_matrix(), np.uint8) & 1
    n = code.n

    gen = torch.Generator(device=device).manual_seed(seed)
    (syns_z, syns_x, x_err, z_err, hd, ha_z, ha_x) = (
        a.cpu().numpy() for a in _sample_two_sector_leak(
            gen, batch, rounds, code, noise,
            *two_sector_circuits(code, hz, hx, device), rz=rz, rx=rx,
            p_leak=float(p_leak), p_seep=float(p_seep),
            p_leak_anc=float(p_leak_anc)))

    final_z = ((x_err.astype(np.int64) @ hz.T) & 1).astype(np.uint8)
    final_x = ((z_err.astype(np.int64) @ hx.T) & 1).astype(np.uint8)
    dets_z = detector_history(syns_z, final_z)
    dets_x = detector_history(syns_x, final_x)

    leak_avg = float(expected_leak_profile(p_leak, p_seep,
                                           rounds).mean())
    pm_eff = noise.p_meas + 0.5 * p_leak_anc \
        - 2.0 * noise.p_meas * 0.5 * p_leak_anc
    noise_dem = dataclasses.replace(
        noise, p_meas=pm_eff, p_idle=0.75 * max(leak_avg, 1e-9),
        pauli_idle=(max(leak_avg, 1e-9) / 4.0,) * 3)
    dem, index, comp_edges = build_two_sector_dem(
        code, rounds, noise_dem, return_comp_edges=True)

    # herald targets: the leaked qubit's idle edge per (t, q), and the
    # leaked ancilla's measurement edge per (t, c)
    idle_eids = {}
    for sector, comp in (("z", "x"), ("x", "z")):
        ids = np.full((rounds, n), -1, np.int32)
        for t in range(rounds):
            for q in range(n):
                e = comp_edges.get((t, ("idle", q, comp), sector))
                if e is not None:
                    ids[t, q] = e
        idle_eids[sector] = ids
    meas_eids = {"z": _meas_edge_ids(index["z"], rounds, rz),
                 "x": _meas_edge_ids(index["x"], rounds, rx)}

    out = {"samples": batch, "rounds": rounds, "p_leak": p_leak,
           "p_seep": p_seep, "p_leak_anc": p_leak_anc,
           "leak_fraction": float(hd.mean()), "heralded": heralded}
    par = {
        "z": ((x_err.astype(np.int64) @ lz[0]) & 1).astype(np.uint32),
        "x": ((z_err.astype(np.int64) @ lx[0]) & 1).astype(np.uint32),
    }
    fails = {}
    for sector, graph, dets, ha in (
            ("z", dem.graph_x_errors, dets_z, ha_z),
            ("x", dem.graph_z_errors, dets_x, ha_x)):
        dec = UFDecoder(graph, use_native=None)
        sw = None
        if heralded:
            static_w = np.asarray(graph.edge_weight)
            sw = np.tile(static_w, (batch, 1))
            ids = idle_eids[sector]
            valid = ids >= 0
            e_flat = ids[valid]
            h_flat = hd.reshape(batch, -1)[:, valid.ravel()]
            sw[:, e_flat] = np.where(h_flat == 1, ERASED_WEIGHT,
                                     sw[:, e_flat]).astype(np.uint8)
            m_ids = meas_eids[sector].ravel()
            ham = ha.reshape(batch, -1)
            sw[:, m_ids] = np.where(ham == 1, ERASED_WEIGHT,
                                    sw[:, m_ids]).astype(np.uint8)
        _, obs = dec.decode_batch(dets, want_corrections=False,
                                  n_threads=n_threads, shot_weights=sw)
        fails[sector] = (obs & 1) != par[sector]
    out["x_fail"] = float(np.mean(fails["z"]))
    out["z_fail"] = float(np.mean(fails["x"]))
    out["word_fail"] = float(np.mean(fails["z"] | fails["x"]))
    return out


def leakage_memory_experiment(
    code,
    p: float,
    p_leak: float,
    *,
    q: float | None = None,
    p_seep: float = 0.2,
    rounds: int | None = None,
    samples: int = 1 << 13,
    batch: int | None = None,
    seed: int = 0,
    heralded: bool = True,
    decoder: str = "host",
    use_native: bool | None = None,
    calibrated: bool = False,
    device="cuda",
) -> dict[str, float]:
    """Multi-round phenomenological X-memory under persistent leakage,
    sampled on ``device`` and decoded with spacetime union-find whose
    space edges carry per-shot herald weights over the leak INTERVALS.
    ``heralded=False`` decodes the same shots blind — leakage-IGNORANT
    by default (static weights from the Pauli rates alone), or
    leakage-CALIBRATED with ``calibrated=True`` (the average
    leak-induced flip rate folded into the static space-edge weights:
    what a calibrated-but-unheralded stack decodes with).
    ``decoder='device'`` decodes on ``device`` too (`DeviceUFDecoder`)."""
    device = resolve_device(device)
    h = code.raw_parity_check_c2
    lz = code.z_operator_matrix()
    if rounds is None:
        rounds = 2 * code.t + 1
    q = p if q is None else q
    batch = samples if batch is None else batch
    base = graph_from_checks(h, lz)
    p_eff, q_eff = max(p, 1e-9), max(q, 1e-9)
    if calibrated:
        # fold the expected leak-induced 1/2-flip rate into the static
        # space-edge likelihoods (average over the round profile)
        leak_avg = float(expected_leak_profile(
            p_leak, p_seep, rounds).mean())
        extra = 0.5 * leak_avg
        p_eff = p_eff + extra - 2.0 * p_eff * extra
    graph = spacetime_graph(h, lz, rounds, p_space=p_eff, p_time=q_eff)
    # static weights on the erasure scale (ERASED_WEIGHT=1 for heralded
    # edges, Pauli edges proportionally more expensive)
    w_space = _pauli_weight(1.5 * p_eff)
    w_time = max(ERASED_WEIGHT + 1,
                 round(w_space * np.log(q_eff) / np.log(p_eff)))
    n_space = base.num_edges * (rounds + 1)
    static_w = np.concatenate([
        np.full(n_space, w_space),
        np.full(graph.num_edges - n_space, min(w_time, 250)),
    ]).astype(np.uint8)
    import dataclasses

    graph = dataclasses.replace(graph, edge_weight=static_w)
    if decoder == "device":
        from qcss_tpu_torch.decode.device_uf import DeviceUFDecoder

        dec = DeviceUFDecoder(graph, device=device)
    elif decoder == "host":
        dec = UFDecoder(graph, use_native=use_native)
    else:
        raise ValueError("decoder must be 'host' or 'device'")
    se_idx = _space_edge_index(base, rounds)
    h_t = torch.as_tensor(np.asarray(h, np.uint8), device=device)
    lz_t = torch.as_tensor(np.asarray(lz, np.uint8), device=device)

    n_chunks = -(-samples // batch)
    fails = 0
    leak_frac = 0.0
    for gen in chunk_generators(seed, n_chunks, device):
        dets, par, heralds = (a.cpu().numpy() for a in _sample_leakage_stream(
            gen, p, q, p_leak, p_seep, batch, rounds, code.n, h_t, lz_t))
        leak_frac += float(heralds.mean())
        sw = None
        if heralded:
            sw = np.tile(static_w, (batch, 1))
            valid = se_idx >= 0
            e_flat = se_idx[valid]
            hr_flat = heralds.reshape(batch, -1)[:, valid.ravel()]
            sw[:, e_flat] = np.where(hr_flat == 1, ERASED_WEIGHT,
                                     sw[:, e_flat]).astype(np.uint8)
        _, obs = dec.decode_batch(dets, want_corrections=False,
                                  shot_weights=sw)
        fails += int(np.sum(obs != _pack_parity(par)))
    n_samples = n_chunks * batch
    return {
        "logical_fail": fails / n_samples,
        "leak_fraction": leak_frac / n_chunks,
        "samples": n_samples,
        "rounds": rounds,
        "p": p,
        "q": q,
        "p_leak": p_leak,
        "p_seep": p_seep,
        "heralded": heralded,
    }
