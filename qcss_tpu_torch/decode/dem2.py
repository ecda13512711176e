"""Two-sector circuit-level DEM with X<->Z fault correlations.

`decode.dem` builds the single-sector detector error model analytically.
This module generalizes to the full two-sector memory experiment (Z-check
extraction then X-check extraction every round) by PROPAGATING each
elementary fault's Pauli frame through the round circuit programmatically
— the same single-fault algebra, mechanized, which is what makes the
joint enumeration tractable: every 2-qubit depolarizing pattern
decomposes into an X-component (firing Z-check detectors -> an edge in
the X-error graph) and a Z-component (firing X-check detectors -> an edge
in the Z-error graph), and patterns carrying BOTH (the Y-type patterns of
the depolarizing channel) are recorded as CORRELATION PAIRS between the
two graphs.

Fault bookkeeping is exact about round boundaries: a fault is summarized
as, per check, its flipped MEASUREMENT rounds within a 3-round horizon
plus a persistence flag (the steady-state syndrome of its residual data
frame); detector events are then synthesized per occurrence round t with
the experiment length R in hand — measurement flips beyond round R-1
never happen (e.g. a reset fault in the final round is a physical no-op)
while residual data errors telescope into the perfect final slice.

Correlated two-pass decoding mirrors `decode.correlated` at circuit
level: decode the X-error graph, mark its chosen edges (the union-find's
edge-indicator output), and re-weight each coupled Z-error-graph edge to
the conditional -log-likelihood (P(Z-part | X-part) = 1/2 per coupled
location under depolarizing) for the second pass — see
`experiments.memory_xz`.

The reference decodes each sector with an independent LUT per extraction
and has no correlation machinery of any kind (reference:
css_code.py:436-470).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from qcss_tpu_torch.decode.uf import MatchingGraph, weights_from_probs

_HORIZON = 3


@dataclass(frozen=True)
class TwoSectorDEM:
    """Joint detector error model of the two-sector memory experiment.

    ``graph_x_errors`` decodes X data errors from the Z-check detectors;
    ``graph_z_errors`` decodes Z data errors from the X-check detectors.
    Both use ``edge_qubit = arange(E)`` (edge-indicator corrections).
    ``pairs`` is [P, 2] int32 rows (edge_in_x_error_graph,
    edge_in_z_error_graph) of correlated fault locations."""

    graph_x_errors: MatchingGraph
    graph_z_errors: MatchingGraph
    pairs: np.ndarray
    cheap_weight: int = 2
    #: per-edge merged fault probabilities, keyed "x_errors"/"z_errors"
    #: (aligned with the graphs' edge order) — what per-shot soft
    #: reweighting needs to separate a component's share out of a merged
    #: edge (`experiments.soft`)
    edge_probs: dict | None = None


class _RoundCircuit:
    """One round of the two-sector extraction schedule as an op list the
    fault propagator can walk. Ops: ("cnot", c, t), ("h", q),
    ("measure", q, sector, check), ("reset", q). Z extraction first,
    then X extraction (H-sandwich ancillas), matching
    `experiments.memory`'s circuits."""

    def __init__(self, code, hz=None, hx=None):
        # explicit check-set overrides let qLDPC callers extract the FULL
        # redundant sets (what hardware measures); default matches
        # `experiments.memory_xz`'s raw-check circuits
        hz = np.asarray(
            code.raw_parity_check_c2 if hz is None else hz, np.uint8) & 1
        hx = np.asarray(
            code.raw_parity_check_c1 if hx is None else hx, np.uint8) & 1
        n = hz.shape[1]
        rz, rx = hz.shape[0], hx.shape[0]
        self.n = n
        self.rz, self.rx = rz, rx
        self.hz, self.hx = hz, hx
        self.lz = np.asarray(code.z_operator_matrix(), np.uint8) & 1
        self.lx = np.asarray(code.x_operator_matrix(), np.uint8) & 1
        self.n_qubits = n + rz + rx
        zanc = n + np.arange(rz)
        xanc = n + rz + np.arange(rx)
        ops = []
        for c in range(rz):
            for j in np.nonzero(hz[c])[0]:
                ops.append(("cnot", int(j), int(zanc[c])))
        for c in range(rz):
            ops.append(("measure", int(zanc[c]), "z", c))
            ops.append(("reset", int(zanc[c])))
        for c in range(rx):
            ops.append(("h", int(xanc[c])))
        for c in range(rx):
            for j in np.nonzero(hx[c])[0]:
                ops.append(("cnot", int(xanc[c]), int(j)))
        for c in range(rx):
            ops.append(("h", int(xanc[c])))
        for c in range(rx):
            ops.append(("measure", int(xanc[c]), "x", c))
            ops.append(("reset", int(xanc[c])))
        self.ops = ops


def _analyze(circ: _RoundCircuit, start_op: int, x0, z0):
    """Propagate a fault injected AFTER op `start_op` (-1 = round start)
    for `_HORIZON` rounds. Returns (info, obs_z, obs_x) where info maps
    sector -> {check: (flip_rounds tuple, persistent bool)}."""
    x = x0.copy()
    z = z0.copy()
    flips: dict[str, dict[int, list[int]]] = {"z": {}, "x": {}}
    for r in range(_HORIZON):
        ops = circ.ops if r > 0 else circ.ops[start_op + 1:]
        for op in ops:
            kind = op[0]
            if kind == "cnot":
                _, c, t = op
                x[t] ^= x[c]
                z[c] ^= z[t]
            elif kind == "h":
                q = op[1]
                x[q], z[q] = z[q], x[q]
            elif kind == "measure":
                q, sector, check = op[1], op[2], op[3]
                if x[q]:
                    flips[sector].setdefault(check, []).append(r)
            else:  # reset
                q = op[1]
                x[q] = 0
                z[q] = 0
    res_x = x[: circ.n]
    res_z = z[: circ.n]
    persist = {
        "z": (circ.hz @ res_x) % 2,
        "x": (circ.hx @ res_z) % 2,
    }
    info: dict[str, dict[int, tuple]] = {"z": {}, "x": {}}
    for sector in ("z", "x"):
        checks = set(flips[sector]) | set(np.nonzero(persist[sector])[0])
        for c in checks:
            fl = tuple(flips[sector].get(c, ()))
            p = bool(persist[sector][int(c)])
            # steady state must be reached by the horizon's last round
            assert ((_HORIZON - 1) in fl) == p, (sector, c, fl, p)
            info[sector][int(c)] = (fl, p)
    # observable effects as BITMASKS over the code's k logicals (bit j =
    # logical j flipped); for k=1 this is the plain 0/1 the matching
    # graphs consume, and qLDPC Tanner builders read all k bits
    obs_z = int(np.bitwise_xor.reduce(
        (1 << np.arange(circ.lz.shape[0])) * ((circ.lz @ res_x) % 2),
        initial=0))
    obs_x = int(np.bitwise_xor.reduce(
        (1 << np.arange(circ.lx.shape[0])) * ((circ.lx @ res_z) % 2),
        initial=0))
    return info, obs_z, obs_x


def _events(info_sector: dict, t: int, rounds: int, r_c: int):
    """Detector events of a fault occurring in round t, as a sorted
    tuple of detector indices (slice * r_c + check). Measurement flips
    beyond round rounds-1 never happen; persistent residual errors
    telescope into the perfect final slice `rounds`."""
    par: dict[int, int] = {}

    def toggle(s, c):
        k = s * r_c + c
        par[k] = par.get(k, 0) ^ 1

    for c, (fl, persistent) in info_sector.items():
        for rh in fl:
            f = t + rh
            if f <= rounds - 1:
                toggle(f, c)
                toggle(f + 1, c)
        if persistent:
            if t + _HORIZON <= rounds - 1:
                # flip train continues through every remaining round
                toggle(t + _HORIZON, c)
                toggle(rounds, c)
            toggle(rounds, c)  # the perfect final readout's contribution
    return tuple(sorted(k for k, v in par.items() if v))


def _fault_species(circ: _RoundCircuit, noise):
    """EXCLUSIVE-pattern per-sector fault species of one round.

    Each noisy location's channel partitions into exclusive X-component
    supports and, independently, exclusive Z-component supports. For a
    2-qubit depolarizing the 15 patterns classify by X-support in
    {ctrl-only, tgt-only, both} — 4 patterns each, so 4p/15 per species —
    and by Z-support likewise; the both-sides species' detector signature
    is the symmetric DIFFERENCE the frame propagation computes naturally.
    (The earlier per-side MARGINAL decomposition — 8p/15 per side with
    X (x) X booked on both component edges — double-counted those edges
    and missed the symmetric-difference diagonals; detector-statistics
    calibration caught the identical bug in the single-sector model,
    decode/dem.py::_round_faults, and this is the same fix.) Same-
    location (X-support, Z-support) co-occurrences — the patterns with a
    Y on some side — are recorded as correlation pairs with their exact
    joint probabilities (each of the 9 (xs, zs) support combinations is
    exactly one of the 15 patterns: p/15).

    Returns (components, pairs): components is a list of
    (comp_key, info, obs_z, obs_x, prob); pairs maps
    (x_comp_key, z_comp_key) -> joint probability."""
    comps = []
    pairs = {}
    nq = circ.n_qubits

    def inject(k, qs, pauli_x: bool, prob, key):
        x0 = np.zeros(nq, np.uint8)
        z0 = np.zeros(nq, np.uint8)
        for q in np.atleast_1d(qs):
            (x0 if pauli_x else z0)[q] = 1
        info, oz, ox = _analyze(circ, k, x0, z0)
        comps.append((key, info, oz, ox, prob))

    p2 = noise.p_gate2
    if p2:
        r2 = noise.rate2
        if isinstance(r2, tuple):
            # BIASED 2q locations are two INDEPENDENT per-qubit biased
            # channels (NoiseModel.pauli2 semantics; the frame engine's
            # _inject2 tuple branch samples exactly this). Per side the
            # (X-component, Z-component) indicator joint is
            # {(1,0): px, (1,1): py, (0,1): pz, (0,0): rest}; classes
            # and pairs are exact products over the two sides.
            px, py, pz = r2
            a = px + py          # P(X component) per side
            b = pz + py          # P(Z component) per side
            xcls = {"c": a * (1 - a), "t": (1 - a) * a, "ct": a * a}
            zcls = {"c": b * (1 - b), "t": (1 - b) * b, "ct": b * b}
            q_ = {(0, 0): 1 - px - py - pz, (1, 0): px,
                  (1, 1): py, (0, 1): pz}
            sup_bits = {"c": (1, 0), "t": (0, 1), "ct": (1, 1)}

            def pair_p(xs, zs):
                (xc, xt), (zc, zt) = sup_bits[xs], sup_bits[zs]
                return q_[(xc, zc)] * q_[(xt, zt)]
        else:
            # uniform 15-way depolarizing: 4 patterns per exclusive
            # support class (4p/15), each (xs, zs) combo one pattern
            xcls = zcls = {s: 4.0 * p2 / 15.0 for s in ("c", "t", "ct")}

            def pair_p(xs, zs):
                return p2 / 15.0

        for k, op in enumerate(circ.ops):
            if op[0] != "cnot":
                continue
            sups = {"c": (op[1],), "t": (op[2],), "ct": (op[1], op[2])}
            for sup, qs in sups.items():
                if xcls[sup]:
                    inject(k, qs, True, xcls[sup], ("2q", k, sup, "x"))
                if zcls[sup]:
                    inject(k, qs, False, zcls[sup], ("2q", k, sup, "z"))
            for xs in sups:
                for zs in sups:
                    jp = pair_p(xs, zs)
                    if jp:
                        pairs[(("2q", k, xs, "x"),
                               ("2q", k, zs, "z"))] = jp
    p1 = noise.p_gate1
    if p1:
        r1 = noise.rate1
        if isinstance(r1, tuple):
            px1, py1, pz1 = r1
            px_c, pz_c, pxy = px1 + py1, pz1 + py1, py1
        else:
            # uniform 1q depolarizing: P(X-comp) = P(Z-comp) = 2/3 p;
            # joint (Y) = 1/3 p
            px_c = pz_c = 2.0 * p1 / 3.0
            pxy = p1 / 3.0
        for k, op in enumerate(circ.ops):
            if op[0] != "h":
                continue
            q = op[1]
            kx = ("1q", k, q, "x")
            kz = ("1q", k, q, "z")
            if px_c:
                inject(k, q, True, px_c, kx)
            if pz_c:
                inject(k, q, False, pz_c, kz)
            if pxy:
                pairs[(kx, kz)] = pxy
    pm = noise.p_meas
    if pm:
        for k, op in enumerate(circ.ops):
            if op[0] != "measure":
                continue
            sector, check = op[2], op[3]
            info = {"z": {}, "x": {}}
            info[sector][check] = ((0,), False)
            comps.append((("meas", k), info, 0, 0, pm))
    pr = noise.p_reset
    if pr:
        for k, op in enumerate(circ.ops):
            if op[0] != "reset":
                continue
            x0 = np.zeros(nq, np.uint8)
            x0[op[1]] = 1
            info, oz, ox = _analyze(circ, k, x0, np.zeros(nq, np.uint8))
            comps.append((("reset", k), info, oz, ox, pr))
    if noise.p_idle:
        # one idle Pauli channel per DATA qubit per round, charged at the
        # round boundary (k=-1) — the memory-pipeline interpretation of
        # NoiseModel.p_idle (per ROUND, not per elementary step; callers
        # wanting duration weighting compose with noise.compose_pauli).
        # Matches memory_xz._sample_two_sector's injection exactly.
        rate = noise.rate_idle
        px, py, pz = (rate if isinstance(rate, tuple)
                      else (rate / 3.0,) * 3)
        for q in range(circ.n):
            kx = ("idle", q, "x")
            kz = ("idle", q, "z")
            inject(-1, q, True, px + py, kx)
            inject(-1, q, False, pz + py, kz)
            pairs[(kx, kz)] = py
    return comps, pairs


def _decompose_into_edges(have, dets, obs, cache):
    """Greedy exact decomposition of a fault signature into existing
    elementary (dets_tuple, obs) edge keys of ``have`` whose detector
    sets partition ``dets`` and whose observable effects XOR to ``obs``.
    Returns the list of edge keys, or None if no decomposition exists.
    ``cache`` memoizes across calls that share one ``have`` dict (keys
    must be stable while cached — `build_two_sector_dem` only mutates
    values)."""
    ck = (dets, obs)
    if ck in cache:
        return cache[ck]
    if not dets:
        out = [] if obs == 0 else None
        cache[ck] = out
        return out
    d0, rest = dets[0], dets[1:]
    for o in (0, 1):
        if ((d0,), o) in have:
            sub = _decompose_into_edges(have, rest, obs ^ o, cache)
            if sub is not None:
                out = [((d0,), o)] + sub
                cache[ck] = out
                return out
        for i, d1 in enumerate(rest):
            if ((d0, d1), o) in have:
                rem = rest[:i] + rest[i + 1:]
                sub = _decompose_into_edges(have, rem, obs ^ o, cache)
                if sub is not None:
                    out = [((d0, d1), o)] + sub
                    cache[ck] = out
                    return out
    cache[ck] = None
    return None


def build_two_sector_dem(code, rounds: int, noise, *,
                         return_index: bool = False,
                         return_comp_edges: bool = False):
    """Joint DEM over (rounds+1) detector slices per sector, with the
    correlation pairs of same-qubit (X, Z) fault components.

    Compound components (ancilla-side faults that fan out into several
    data qubits — >= 3 detectors) are DECOMPOSED into existing elementary
    edges with consistent total observable effect, the standard matching
    treatment (their probability adds to each component edge; the
    correlation between the pieces is ignored, as for every X (x) X
    decomposition)."""
    circ = _RoundCircuit(code)
    comps, pair_probs = _fault_species(circ, noise)
    n_checks = {"z": circ.rz, "x": circ.rx}

    merged = {"z": {}, "x": {}}      # (dets, obs) -> prob
    compounds = {"z": [], "x": []}   # (dets, obs, prob)
    comp_edge: dict[tuple, tuple] = {}  # (t, comp_key, sector) -> (dets, obs)
    for t in range(rounds):
        for key, info, oz, ox, prob in comps:
            for sector, obs in (("z", oz), ("x", ox)):
                dets = _events(info[sector], t, rounds, n_checks[sector])
                if not dets:
                    continue
                if len(dets) <= 2:
                    k = (dets, obs)
                    merged[sector][k] = merged[sector].get(k, 0.0) + prob
                    comp_edge[(t, key, sector)] = k
                else:
                    compounds[sector].append((dets, obs, prob))

    # decompose compounds into existing elementary edges
    for sector in ("z", "x"):
        have = merged[sector]
        cache: dict = {}
        for dets, obs, prob in compounds[sector]:
            parts = _decompose_into_edges(have, dets, obs, cache)
            if parts is None:
                raise ValueError(
                    f"cannot decompose compound fault {dets} (obs {obs}) "
                    "into elementary edges")
            for k in parts:
                have[k] = have[k] + prob

    graphs = {}
    index = {}
    edge_probs = {}
    for sector in ("z", "x"):
        r_c = n_checks[sector]
        edges, eobs, probs = [], [], []
        idx = {}
        for (dets, obs), prob in merged[sector].items():
            a = dets[0]
            b = dets[1] if len(dets) == 2 else -1
            idx[(dets, obs)] = len(edges)
            edges.append((a, b))
            eobs.append(obs)
            probs.append(min(prob, 0.499))
        e = len(edges)
        graphs[sector] = MatchingGraph(
            num_nodes=(rounds + 1) * r_c,
            edges=np.asarray(edges, np.int32).reshape(-1, 2),
            edge_qubit=np.arange(e, dtype=np.int32),  # edge indicators
            edge_obs=np.asarray(eobs, np.uint32),
            n_qubits=e,
            edge_weight=weights_from_probs(probs),
        )
        index[sector] = idx
        edge_probs["x_errors" if sector == "z" else "z_errors"] = \
            np.asarray(probs, np.float64)

    pair_acc: dict[tuple, float] = {}
    for (kx_comp, kz_comp), joint in pair_probs.items():
        for t in range(rounds):
            ez = comp_edge.get((t, kx_comp, "z"))
            ex = comp_edge.get((t, kz_comp, "x"))
            if ez is None or ex is None:
                continue  # a side vanished or was compound-decomposed
            k = (index["z"][ez], index["x"][ex])
            pair_acc[k] = pair_acc.get(k, 0.0) + joint
    pairs = np.asarray(sorted(pair_acc), np.int32).reshape(-1, 2)
    dem = TwoSectorDEM(
        graph_x_errors=graphs["z"],
        graph_z_errors=graphs["x"],
        pairs=pairs,
        edge_probs=edge_probs,
    )
    if return_comp_edges:
        # (t, comp_key, sector) -> edge id in that sector's graph, for
        # elementary (non-compound) components — what per-shot herald
        # reweighting needs to find a specific mechanism's edge (e.g.
        # the idle species of a leaked data qubit, experiments/leakage)
        ce = {k: index[k[2]][v] for k, v in comp_edge.items()
              if v in index[k[2]]}
        return dem, index, ce
    if return_index:
        # index[sector]: (dets_tuple, obs) -> edge id in that sector's
        # graph — what belief-matching needs to map Tanner-variable
        # decompositions onto matching edges (decode/belief.py)
        return dem, index
    return dem
