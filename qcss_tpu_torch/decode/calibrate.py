"""Decoder calibration from detector statistics — no noise model needed.

Production decoders should not have to trust an assumed error model: the
per-edge fault probabilities of a matching graph are identifiable from
the detector data itself. For an edge (i, j) fired independently with
probability p and all other mechanisms independent, the pair correlation

    <d_i d_j> - <d_i><d_j>
    ----------------------------------- = p (1 - p)
    1 - 2<d_i> - 2<d_j> + 4 <d_i d_j>

holds EXACTLY, independent of everything else hitting i and j (the XOR
algebra is in `estimate_edge_probs`), so p = 1/2 - 1/2 sqrt(1 - 4y) for
the measured ratio y; boundary edges are then fixed by the residual of
the node marginal, 1 - 2<d_i> = prod_e (1 - 2 p_e) over all edges at i.

The estimates feed `uf.weights_from_probs` for weighted union-find /
MWPM decoding: `calibrated_graph(graph, dets)` is a drop-in reweighted
graph. The reference has nothing of this kind — its decoding trusts a
hand-built syndrome table (reference: css_code.py:649-735).

Scope: matching graphs (every mechanism flips <= 2 detectors). Parallel
edges between the same detector pair are not separately identifiable
from two-point statistics; their combined probability is split evenly
(documented approximation, exact when at most one parallel edge
dominates).
"""

from __future__ import annotations

import numpy as np

from qcss_tpu_torch.decode.uf import MatchingGraph, weights_from_probs


def estimate_edge_probs(dets: np.ndarray, graph: MatchingGraph, *,
                        p_min: float = 1e-5,
                        p_max: float = 0.45) -> np.ndarray:
    """Per-edge fault probabilities from [B, num_nodes] detection events.

    Derivation: write d_i = e ^ x_i, d_j = e ^ x_j with e the edge
    indicator (prob p) and x_i, x_j the XOR of every other mechanism at
    i / j (independent of e; a mechanism hitting BOTH i and j is another
    parallel edge, folded into p). With biases P = 1-2p, A = 1-2·P(x_i),
    B = 1-2·P(x_j):

        <d_i d_j> - <d_i><d_j>            = A B (1 - P^2) / 4
        1 - 2<d_i> - 2<d_j> + 4<d_i d_j>  = A B

    so the ratio y = num/den equals p(1-p) exactly, independent of the
    rest of the graph, and

        p = 1/2 - 1/2 sqrt(1 - 4 y)          (0 <= y <= 1/4)

    Boundary edges get the node-marginal residual:
    1 - 2<d_i> = prod_{edges e at i} (1 - 2 p_e)."""
    dets = np.asarray(dets)
    if dets.ndim != 2 or dets.shape[1] != graph.num_nodes:
        raise ValueError(f"dets must be [B, {graph.num_nodes}]")
    d = dets.astype(np.float64)
    m = d.mean(axis=0)
    e = graph.edges
    n_e = e.shape[0]
    probs = np.full(n_e, p_min, np.float64)

    # -- pair edges: group parallel edges by unordered detector pair
    pair_groups: dict[tuple[int, int], list[int]] = {}
    boundary: dict[int, list[int]] = {}
    for k in range(n_e):
        i, j = int(e[k, 0]), int(e[k, 1])
        if i < 0 or j < 0:
            boundary.setdefault(max(i, j), []).append(k)
        else:
            pair_groups.setdefault((min(i, j), max(i, j)), []).append(k)

    for (i, j), ks in pair_groups.items():
        mij = float(d[:, i] @ d[:, j]) / d.shape[0]
        num = mij - m[i] * m[j]
        den = 1.0 - 2.0 * m[i] - 2.0 * m[j] + 4.0 * mij
        if den <= 0 or num <= 0:
            p = p_min
        else:
            y = min(num / den, 0.25)
            p = 0.5 - 0.5 * np.sqrt(1.0 - 4.0 * y)
        p = float(np.clip(p, p_min, p_max))
        if len(ks) > 1:  # split evenly across parallel edges
            share = 0.5 * (1.0 - (1.0 - 2.0 * p) ** (1.0 / len(ks)))
            p = float(np.clip(share, p_min, p_max))
        for k in ks:
            probs[k] = p

    # -- boundary edges: residual of the node marginal
    for i, ks in boundary.items():
        r = 1.0 - 2.0 * m[i]
        for k in range(n_e):
            a, b = int(e[k, 0]), int(e[k, 1])
            if a >= 0 and b >= 0 and (a == i or b == i):
                r /= max(1.0 - 2.0 * probs[k], 1e-9)
        r = float(np.clip(r, 1e-9, 1.0))
        p_total = 0.5 * (1.0 - r)
        share = 0.5 * (1.0 - max(r, 0.0) ** (1.0 / len(ks))) \
            if len(ks) > 1 else p_total
        for k in ks:
            probs[k] = float(np.clip(share, p_min, p_max))
    return probs


def calibrated_graph(graph: MatchingGraph, dets: np.ndarray,
                     **kwargs) -> MatchingGraph:
    """Drop-in reweighted graph: edge weights from the probabilities the
    detector data itself exhibits (`estimate_edge_probs`)."""
    probs = estimate_edge_probs(dets, graph, **kwargs)
    return MatchingGraph(
        num_nodes=graph.num_nodes,
        edges=graph.edges,
        edge_qubit=graph.edge_qubit,
        edge_obs=graph.edge_obs,
        n_qubits=graph.n_qubits,
        edge_weight=weights_from_probs(probs),
    )
