"""Heralded-erasure noise and erasure-aware decoding (PyTorch port of
`qcss_tpu.experiments.erasure`).

Erasure qubits convert the dominant physical fault into a *heralded*
loss: the location is flagged classically and the qubit is replaced by
the maximally mixed state (uniform over I/X/Y/Z — an X-component and a
Z-component flip, each with probability 1/2, independently). The herald
is per-shot side information for the decoder: erased edges decode at
near-zero cost via the union-find kernel's per-shot weight override
(`UFDecoder.decode_batch(shot_weights=...)`), which lifts the surface
code's code-capacity threshold from ~11% (unheralded depolarizing) to
the bond-percolation bound of 50% for pure erasure, and any erasure
pattern of weight < d decodes exactly (the correction is unique up to
stabilizers once no logical operator fits inside the erased support).

Two noise tiers, mirroring the Pauli stack's ladder:

* code capacity (`erasure_error_rate`): one erasure+Pauli layer, both
  sectors decoded on the per-sector matching graphs;
* phenomenological (`erasure_phenomenological_error_rate`): per-round
  data erasures (detected and reset each cycle, the erasure-qubit
  operating model) + data flips p + measurement flips q, decoded on the
  spacetime graph with the erased (round, qubit) space edges down-
  weighted per shot.

Sampling and syndrome extraction run batched on the device; only
syndromes, logical parities, and the herald masks cross to the host.
Random streams: where the reference splits one JAX key per chunk, chunk
i draws from its own generator (`sim.noise.chunk_generators`); each
sampler's draws, in order, are listed in its docstring. The shots are
held against the reference by rates, the decodes, given the shots, bit
for bit.
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
from qcss_tpu_torch.ops import gf2_torch
from qcss_tpu_torch.sim.noise import chunk_generators

#: shot-weight assigned to heralded (erased) edges — the minimum the
#: kernel supports, so clusters absorb erased edges first.
ERASED_WEIGHT = 1


def _pauli_weight(p_pauli: float, w_erased: int = ERASED_WEIGHT,
                  cap: int = 250) -> int:
    """Growth weight for un-erased edges such that weight ratios track
    -log-likelihood ratios against the erased edges' 1/2 component rate:
    w = w_erased * ln(p_component) / ln(1/2). Pure erasure (p_pauli = 0)
    pins un-erased edges at the uint8 cap — they are never used."""
    if p_pauli <= 0.0:
        return cap
    comp = 2.0 * p_pauli / 3.0  # X (or Z) component of depolarizing p
    w = round(w_erased * np.log(comp) / np.log(0.5))
    return int(np.clip(w, w_erased + 1, cap))


def _sample_erasure_layer(generator, batch, n, p_pauli, p_erase):
    """One code-capacity layer on the generator's device: erasure mask
    [B, n] plus X/Z component flips — depolarizing p_pauli on intact
    qubits, 1/2-1/2 independent components on erased ones. Draws, in
    order: the [B, n] erasure uniforms, the [B, n] depolarizing
    uniforms, the [B, 2n] erased-component uniforms. Returns (erased,
    x_err, z_err) uint8."""
    device = generator.device
    erased = (torch.rand((batch, n), generator=generator, device=device)
              < p_erase).to(torch.uint8)
    # depolarizing components on intact qubits (event layout identical to
    # noise._thresholds_1q: X on [0, 2p/3), Z on [p/3, p))
    u = torch.rand((batch, n), generator=generator, device=device)
    x_dep = (u < 2.0 * p_pauli / 3.0).to(torch.uint8)
    z_dep = ((u >= p_pauli / 3.0) & (u < p_pauli)).to(torch.uint8)
    # independent 1/2 components on erased qubits
    v = torch.rand((batch, 2 * n), generator=generator, device=device)
    x_er = (v[:, :n] < 0.5).to(torch.uint8)
    z_er = (v[:, n:] < 0.5).to(torch.uint8)
    x_err = torch.where(erased == 1, x_er, x_dep)
    z_err = torch.where(erased == 1, z_er, z_dep)
    return erased, x_err, z_err


def _shot_weights(erased_edges: np.ndarray, w_pauli: int) -> np.ndarray:
    """[B, E] uint8 per-shot weights from a boolean erased-edge mask."""
    return np.where(erased_edges, ERASED_WEIGHT, w_pauli).astype(np.uint8)


def erasure_error_rate(
    code,
    p_pauli: float,
    p_erase: float,
    *,
    samples: int = 1 << 14,
    batch: int | None = None,
    seed: int = 0,
    heralded: bool = True,
    use_native: bool | None = None,
    device="cuda",
) -> dict[str, float]:
    """Code-capacity logical error rate under mixed depolarizing+erasure
    noise, both sectors decoded on the host with per-shot-weighted
    union-find; sampled on ``device``.

    ``heralded=False`` decodes the SAME shots ignoring the erasure flags
    (uniform weights) — the ablation that prices the herald."""
    device = resolve_device(device)
    batch = samples if batch is None else batch
    h2, h1 = code.raw_parity_check_c2, code.raw_parity_check_c1
    lz, lx = code.z_operator_matrix(), code.x_operator_matrix()
    gx = graph_from_checks(h2, lz)   # X errors, Z-type checks
    gz = graph_from_checks(h1, lx)
    dec_x, dec_z = UFDecoder(gx, use_native=use_native), UFDecoder(
        gz, use_native=use_native)
    w_pauli = _pauli_weight(p_pauli)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.uint8), device=device)

    h2_t, h1_t, lz_t, lx_t = t(h2), t(h1), t(lz), t(lx)

    n_rounds = -(-samples // batch)
    fails = {"x_fail": 0, "z_fail": 0, "word_fail": 0}
    for gen in chunk_generators(seed, n_rounds, device):
        erased, x_err, z_err = _sample_erasure_layer(
            gen, batch, code.n, p_pauli, p_erase)
        erased, syn_x, syn_z, par_x, par_z = (a.cpu().numpy() for a in (
            erased, gf2_torch.syndromes_dense(x_err, h2_t),
            gf2_torch.syndromes_dense(z_err, h1_t),
            gf2_torch.mod2_matmul(x_err, lz_t.T),
            gf2_torch.mod2_matmul(z_err, lx_t.T)))
        sw_x = sw_z = None
        if heralded:
            sw_x = _shot_weights(erased[:, gx.edge_qubit], w_pauli)
            sw_z = _shot_weights(erased[:, gz.edge_qubit], w_pauli)
        _, obs_x = dec_x.decode_batch(syn_x, want_corrections=False,
                                      shot_weights=sw_x)
        _, obs_z = dec_z.decode_batch(syn_z, want_corrections=False,
                                      shot_weights=sw_z)
        xf = obs_x != _pack_parity(par_x)
        zf = obs_z != _pack_parity(par_z)
        fails["x_fail"] += int(np.sum(xf))
        fails["z_fail"] += int(np.sum(zf))
        fails["word_fail"] += int(np.sum(xf | zf))
    n_samples = n_rounds * batch
    out = {k: v / n_samples for k, v in fails.items()}
    out.update(samples=n_samples, p_pauli=p_pauli, p_erase=p_erase,
               heralded=heralded)
    return out


# -- phenomenological spacetime tier -------------------------------------------


def _space_edge_index(graph: MatchingGraph, base: MatchingGraph,
                      rounds: int) -> np.ndarray:
    """[rounds+1, n_qubits] int32: spacetime edge index of qubit j's space
    edge in slice t (-1 for check-free qubits). Relies on
    `spacetime_graph`'s layout: slices' space edges first, t-major, in
    base-edge order; time edges after."""
    idx = np.full((rounds + 1, base.n_qubits), -1, np.int32)
    e_per_slice = base.num_edges
    for t in range(rounds + 1):
        for e, q in enumerate(base.edge_qubit):
            idx[t, q] = t * e_per_slice + e
    return idx


def _sample_phenom_erasure(generator, p, q, p_erase, batch, rounds, n, h,
                           lz):
    """Phenomenological stream with per-round heralded data erasures:
    round t draws an erasure mask [B, n] (each erased qubit suffers a
    1/2 X-component flip and is reset — the erasure-qubit conversion
    model), plus IID data flips p and measurement flips q. Layer
    `rounds` (before the perfect readout) has Pauli noise only. ``h``,
    ``lz``: uint8 tensors on the generator's device. Draws, in order:
    the [rounds+1, B, n] erasure uniforms, the [rounds+1, B, n] flip
    uniforms, the [rounds, B, r] measurement uniforms. Returns
    (detectors [B, (rounds+1)*r], parities [B, k], erased
    [B, rounds+1, n] with the final layer all-zero), uint8."""
    device = generator.device
    r = h.shape[0]
    erased = (torch.rand((rounds + 1, batch, n), generator=generator,
                         device=device) < p_erase).to(torch.uint8)
    erased[rounds] = 0
    u = torch.rand((rounds + 1, batch, n), generator=generator,
                   device=device)
    errs = torch.where(erased == 1, (u < 0.5).to(torch.uint8),
                       (u < p).to(torch.uint8))
    flips = (torch.rand((rounds, batch, r), generator=generator,
                        device=device) < q).to(torch.uint8)
    cum = (torch.cumsum(errs.to(torch.int32), dim=0) & 1).to(torch.uint8)
    syns = gf2_torch.syndromes_dense(cum[:rounds], h) ^ flips  # [R, B, r]
    final = gf2_torch.syndromes_dense(cum[rounds], h)
    dets = torch.cat([syns[:1], syns[1:] ^ syns[:-1],
                      (final ^ syns[rounds - 1])[None]], dim=0)
    detectors = dets.permute(1, 0, 2).reshape(batch, (rounds + 1) * r)
    par = gf2_torch.mod2_matmul(cum[rounds], lz.T)
    return detectors, par, erased.permute(1, 0, 2)


def erasure_phenomenological_error_rate(
    code,
    p: float,
    p_erase: float,
    q: float | None = None,
    *,
    rounds: int | None = None,
    samples: int = 1 << 13,
    batch: int | None = None,
    seed: int = 0,
    heralded: bool = True,
    use_native: bool | None = None,
    decoder: str = "host",
    device="cuda",
) -> dict[str, float]:
    """Multi-round phenomenological X-memory with per-round heralded data
    erasures, decoded with spacetime union-find whose space edges carry
    per-shot herald weights. `q` defaults to p; `rounds` to the distance.
    ``heralded=False`` is the same-physics ablation (static weights).
    Sampling runs on ``device``; ``decoder='device'`` decodes there too
    (`DeviceUFDecoder`: per-shot weights go to its generic decoders, the
    static graph to the stencil kernel K1 where the graph has a stencil)
    instead of the host C++ kernel."""
    device = resolve_device(device)
    h = code.raw_parity_check_c2
    lz = code.z_operator_matrix()
    if rounds is None:
        rounds = 2 * code.t + 1
    q = p if q is None else q
    batch = samples if batch is None else batch
    base = graph_from_checks(h, lz)
    # static weights reflect the Pauli-only rates; the herald overrides
    # per shot. Effective un-erased space rate is p, time rate q.
    p_eff = max(p, 1e-9)
    graph = spacetime_graph(h, lz, rounds, p_space=p_eff, p_time=max(q, 1e-9))
    w_space = _pauli_weight(1.5 * p_eff)  # p as X-component rate directly
    w_time = max(ERASED_WEIGHT + 1,
                 round(w_space * np.log(max(q, 1e-9)) / np.log(p_eff))) \
        if q > 0 else 250
    static_w = np.concatenate([
        np.full(base.num_edges * (rounds + 1), w_space),
        np.full(graph.num_edges - base.num_edges * (rounds + 1), w_time),
    ]).astype(np.uint8)
    graph = MatchingGraph(
        num_nodes=graph.num_nodes, edges=graph.edges,
        edge_qubit=graph.edge_qubit, edge_obs=graph.edge_obs,
        n_qubits=graph.n_qubits, edge_weight=np.minimum(static_w, 250))
    if decoder == "device":
        from qcss_tpu_torch.decode.device_uf import DeviceUFDecoder

        dec = DeviceUFDecoder(graph, device=device)
    elif decoder == "host":
        dec = UFDecoder(graph, use_native=use_native)
    else:
        raise ValueError("decoder must be 'host' or 'device'")
    se_idx = _space_edge_index(graph, base, rounds)  # [rounds+1, n]
    h_t = torch.as_tensor(np.asarray(h, np.uint8), device=device)
    lz_t = torch.as_tensor(np.asarray(lz, np.uint8), device=device)

    n_rounds = -(-samples // batch)
    fails = 0
    for gen in chunk_generators(seed, n_rounds, device):
        dets, par, erased = (a.cpu().numpy() for a in _sample_phenom_erasure(
            gen, p, q, p_erase, batch, rounds, code.n, h_t, lz_t))
        sw = None
        if heralded:
            sw = np.tile(static_w, (batch, 1))
            # erased[:, t, j] -> space edge se_idx[t, j]
            valid = se_idx >= 0
            e_flat = se_idx[valid]
            er_flat = erased.reshape(batch, -1)[:, valid.ravel()]
            sw[:, e_flat] = np.where(er_flat == 1, ERASED_WEIGHT,
                                     sw[:, e_flat]).astype(np.uint8)
        _, obs = dec.decode_batch(dets, want_corrections=False,
                                  shot_weights=sw)
        fails += int(np.sum(obs != _pack_parity(par)))
    n_samples = n_rounds * batch
    return {
        "logical_fail": fails / n_samples,
        "samples": n_samples,
        "rounds": rounds,
        "p": p,
        "q": q,
        "p_erase": p_erase,
        "heralded": heralded,
    }
