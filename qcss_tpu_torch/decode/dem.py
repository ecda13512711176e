"""Circuit-level detector error model (DEM) for memory experiments.

The phenomenological spacetime graph (`decode.uf.spacetime_graph`) knows
two fault species: whole-round data errors and measurement flips. The real
extraction circuit is richer — a 2-qubit depolarizing fault striking
mid-round, after some of a data qubit's CNOT fan-outs but before the rest,
fires part of its detector signature in slice t and the rest in slice t+1
(a DIAGONAL edge the phenomenological graph cannot represent).

This module builds the exact single-fault error model by propagating every
X-component fault of the round's circuit through the remaining gates
(Pauli-frame algebra; no simulation needed for Clifford propagation):

* for each CNOT (data j → anc c) at position k, the three X-patterns
  X⊗I / I⊗X / X⊗X each occur with probability 4·p_gate2/15;
  - the data-side X fires (t, c') for every check c' ∋ j whose fan-out
    CNOT comes AFTER k, and (t+1, c') for those already copied;
  - the ancilla-side X flips this round's measured bit c: (t, c), (t+1, c);
  - X⊗X fires the symmetric DIFFERENCE of the two component signatures
    (the just-fired check's next-round detector cancels), which for
    single-ancilla fan-out extraction is always <= 2 detectors — so the
    exact mechanism is its own edge, no decomposition needed;
* each measurement flip (p_meas) gives (t, c), (t+1, c);
* each reset flip (p_reset) flips the NEXT round's bit: (t+1, c), (t+2, c).

Faults with identical detector signatures merge (probabilities summed; in
a distance-≥3 code equal signatures imply logically equivalent
corrections). The per-round model is replicated across the R noisy rounds
(signatures clipped at the perfect final slice R), producing a weighted
`MatchingGraph` over the (R+1)·r detectors for the union-find decoder.

The reference has no circuit-level decoding machinery of any kind (its EC
decodes single noisy extractions with a LUT — reference:
css_code.py:436-470); this module is how the memory experiment gets the
decoder its noise actually calls for.
"""

from __future__ import annotations

import numpy as np

from qcss_tpu_torch.decode.uf import MatchingGraph, _column_obs_masks, weights_from_probs


def _round_faults(h, extraction_gates, p_gate2, p_meas, p_reset,
                  rate2=None):
    """Single-fault species of ONE extraction round.

    h: [r, n] raw Z-check matrix; extraction_gates: ordered list of
    (data_j, check_c) CNOT fan-outs. Returns a list of
    (signature, qubit, prob, needs_round_delta) with signature a tuple of
    (slice_delta, check) pairs; needs_round_delta is the latest NOISY
    measurement round (relative to t) the fault needs to exist — 1 for
    reset flips (they corrupt the NEXT round's measurement, so a flip
    after the final round's measurement is a physical no-op).

    ``rate2`` — a biased (p_x, p_y, p_z) per-qubit tuple
    (`NoiseModel.pauli2` semantics: independent per-side channels) makes
    the X-support class probabilities exact products instead of the
    uniform 4p/15 split.
    """
    h = np.asarray(h, dtype=np.uint8) & 1
    r, n = h.shape
    checks_of = [np.nonzero(h[:, j])[0] for j in range(n)]
    # position of each (j -> c) fan-out in the gate order
    pos = {}
    for k, (j, c) in enumerate(extraction_gates):
        pos[(j, c)] = k

    faults: list[tuple[tuple, int, float, int]] = []

    def data_sig(j, after_k):
        """Detector signature of an X on data qubit j arising right after
        gate position after_k (-1 = before the round's first gate)."""
        sig = []
        for c in checks_of[j]:
            delta = 0 if pos[(j, int(c))] > after_k else 1
            sig.append((delta, int(c)))
        return tuple(sorted(sig))

    if rate2 is not None:
        a = rate2[0] + rate2[1]  # per-side X-component probability
        p_data, p_anc, p_both = a * (1 - a), (1 - a) * a, a * a
    else:
        # each X-pattern class of uniform 2q depolarizing
        p_data = p_anc = p_both = 4.0 * p_gate2 / 15.0
    for k, (j, c) in enumerate(extraction_gates):
        if p_gate2:
            # X on the data side, arising after this gate
            faults.append((data_sig(j, k), j, p_data, 0))
            # X on the ancilla side: flips this round's measured bit c
            anc_sig = ((0, c), (1, c))
            faults.append((anc_sig, -1, p_anc, 0))
            # X⊗X is ONE mechanism: its detector effect is the symmetric
            # difference of the two component signatures — the just-fired
            # check c appears in BOTH (the data X was already copied into
            # this round's ancilla, delta=1; the ancilla X flips the same
            # measured bit) so its next-round detector XOR-cancels. For
            # single-ancilla fan-out extraction the result always has
            # <= 2 detectors, so the exact signature is itself matchable;
            # the earlier both-component decomposition double-booked the
            # data and ancilla edges AND missed this mirrored diagonal —
            # detector-statistics calibration (decode/calibrate.py)
            # measured the discrepancy on sampled circuits, which is how
            # this was found.
            xx_sig = tuple(sorted(set(data_sig(j, k)) ^ set(anc_sig)))
            faults.append((xx_sig, j, p_both, 0))
    if p_meas:
        for c in range(r):
            faults.append((((0, c), (1, c)), -1, float(p_meas), 0))
    if p_reset:
        for c in range(r):
            faults.append((((1, c), (2, c)), -1, float(p_reset), 1))
    return faults


def circuit_level_graph(h, extraction_gates, rounds: int,
                        p_gate2: float = 0.0, p_meas: float = 0.0,
                        p_reset: float = 0.0,
                        logicals=None, return_probs: bool = False,
                        rate2=None):
    """Weighted matching graph over the (rounds+1)·r detectors from the
    exact single-fault model of the given extraction circuit.

    ``return_probs=True`` additionally returns the merged per-edge fault
    probabilities [E] (aligned with ``graph.edges``) — the ground truth
    that `decode.calibrate.estimate_edge_probs` recovers from detector
    statistics alone."""
    h = np.asarray(h, dtype=np.uint8) & 1
    r, n = h.shape
    obs = _column_obs_masks(np.asarray(logicals, dtype=np.uint8) & 1)

    per_round = _round_faults(h, extraction_gates, p_gate2, p_meas,
                              p_reset, rate2=rate2)

    # replicate across rounds, clip at the perfect final slice
    merged: dict[tuple, list] = {}  # detector-tuple -> [qubit, prob]
    for t in range(rounds):
        for sig, qubit, prob, needs in per_round:
            if t + needs > rounds - 1:
                continue  # e.g. a reset flip after the final measurement
            dets = tuple(sorted(
                (t + delta) * r + c for delta, c in sig if t + delta <= rounds
            ))
            if not dets:
                continue
            obs_val = int(obs[qubit]) if qubit >= 0 else 0
            cur = merged.get(dets)
            if cur is None:
                merged[dets] = [qubit, prob, obs_val]
            else:
                # same signature => logically equivalent correction for a
                # distance >= 3 code; keep the first representative qubit,
                # but the observable effect must agree
                if cur[2] != obs_val:
                    raise ValueError(
                        f"signature {dets} maps to conflicting logical "
                        "effects; code distance < 3?"
                    )
                cur[1] += prob
    if not merged:
        raise ValueError("no faults: all rates are zero")

    edges, equbit, eobs, probs = [], [], [], []
    for dets, (qubit, prob, obs_val) in merged.items():
        if len(dets) > 2:
            raise ValueError(
                f"non-matchable fault signature {dets}; the extraction "
                "circuit produced a >2-detector fault"
            )
        a = dets[0]
        b = dets[1] if len(dets) == 2 else -1
        edges.append((a, b))
        equbit.append(int(qubit))
        eobs.append(obs_val)
        probs.append(min(prob, 0.499))
    graph = MatchingGraph(
        num_nodes=(rounds + 1) * r,
        edges=np.asarray(edges, dtype=np.int32).reshape(-1, 2),
        edge_qubit=np.asarray(equbit, dtype=np.int32),
        edge_obs=np.asarray(eobs, dtype=np.uint32),
        n_qubits=n,
        edge_weight=weights_from_probs(probs),
    )
    if return_probs:
        return graph, np.asarray(probs, dtype=np.float64)
    return graph


def extraction_gate_list(code, checks=None):
    """The ordered (data_j, check_c) fan-outs of
    `experiments.memory.z_extraction_circuit` for the given checks
    (defaults to the raw Z checks, the matching-decoder convention)."""
    checks = code.raw_parity_check_c2 if checks is None else np.asarray(checks)
    gates = []
    for i in range(checks.shape[0]):
        for j in np.nonzero(checks[i])[0]:
            gates.append((int(j), int(i)))
    return gates


def circuit_level_window_graph(h, extraction_gates, window: int,
                               commit: int, p_gate2: float = 0.0,
                               p_meas: float = 0.0, p_reset: float = 0.0,
                               logicals=None, rate2=None):
    """Mid-stream sliding-window DEM graph over ``window`` detector
    slices (time-invariant — one graph serves every mid window).

    Partition rule: an edge belongs to the window whose coordinate
    system puts its EARLIEST detector in the commit region [0, commit)
    — every stream edge is decided exactly once. Edges with early slice
    < commit and late slice == commit are COMMITTED now (their
    observable counts) and toggle the late-endpoint detector of the
    next window (a carry defect) so the chain continues with full
    context. Fault signatures extending past the window's last slice
    truncate to open-future boundary edges — the unseen tail is
    re-decoded by a later window via the carry. All crossing edges land
    exactly on next-window slice 0 because every single-fault signature
    in `_round_faults` spans <= 1 slice between endpoints (the reset
    species starts at delta 1).

    Returns (graph, committed_obs [E] uint32, carry_check [E] int32,
    -1 = not crossing). Requires commit <= window - 2 so committed
    edges are never truncated (their signatures end by slice commit)."""
    if not 1 <= commit <= window - 2:
        raise ValueError("need 1 <= commit <= window - 2 for DEM windows")
    h = np.asarray(h, dtype=np.uint8) & 1
    r, n = h.shape
    obs = _column_obs_masks(np.asarray(logicals, dtype=np.uint8) & 1)
    per_round = _round_faults(h, extraction_gates, p_gate2, p_meas,
                              p_reset, rate2=rate2)

    merged: dict[tuple, list] = {}
    for t in range(window):
        for sig, qubit, prob, _needs in per_round:
            full = sorted((t + delta, c) for delta, c in sig)
            visible = [(s, c) for s, c in full if s <= window - 1]
            if not visible:
                continue
            early = visible[0][0]
            committed = early < commit
            obs_val = (int(obs[qubit]) if qubit >= 0 else 0)
            carry = -1
            if committed and len(visible) == 2 and visible[1][0] == commit:
                carry = visible[1][1]
            dets = tuple(s * r + c for s, c in visible)
            cur = merged.get(dets)
            if cur is None:
                merged[dets] = [prob, obs_val if committed else 0,
                                committed, carry]
            else:
                if committed and cur[2] and cur[1] != obs_val:
                    raise ValueError(
                        f"window signature {dets} maps to conflicting "
                        "logical effects; code distance < 3?")
                cur[0] += prob
    edges, eobs, carries, probs = [], [], [], []
    for dets, (prob, obs_val, _committed, carry) in merged.items():
        if len(dets) > 2:
            raise ValueError(f"non-matchable window signature {dets}")
        edges.append((dets[0], dets[1] if len(dets) == 2 else -1))
        eobs.append(obs_val)
        carries.append(carry)
        probs.append(min(prob, 0.499))
    graph = MatchingGraph(
        num_nodes=window * r,
        edges=np.asarray(edges, dtype=np.int32).reshape(-1, 2),
        edge_qubit=np.zeros(len(edges), dtype=np.int32),
        edge_obs=np.asarray(eobs, dtype=np.uint32),
        n_qubits=n,
        edge_weight=weights_from_probs(probs),
    )
    return graph, np.asarray(eobs, np.uint32), np.asarray(carries,
                                                         np.int32)
