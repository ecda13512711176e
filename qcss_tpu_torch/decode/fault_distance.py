"""Exact per-observable FAULT DISTANCE of a matching-graph model.

The fault distance of an observable channel is the minimum number of
faults whose combined detector signature is empty while the observable
parity is odd — the spacetime analogue of code distance, and the number
that decides whether a compiled logical operation actually suppresses
with d: a channel whose fault distance is stuck at a constant fails at
a fixed polynomial order in p no matter how large the patch grows
(the round-4 op-set ladder's flattening m1/OUT channels — see
BASELINE.md — are exactly this signature).

On a matching graph (every fault flips <= 2 detectors; faults grouped
by signature into edges, `surgery._graph_from_signatures`) the minimum
is EXACTLY computable: an undetectable fault set is a union of cycles
of the graph extended by a virtual boundary vertex, so the per-channel
fault distance is the shortest cycle with odd observable label — found
as a shortest path in the PARITY DOUBLE COVER (vertex (v, s) with s the
accumulated label parity; an edge with label o connects (u, s) to
(v, s ^ o); the shortest (v, 0) -> (v, 1) walk over all v is the
shortest odd cycle; closed walks and simple cycles have equal minima).

The same construction weighted by -log p gives the most-LIKELY
undetectable logical fault set (`weighted=True` uses the graph's
integer growth weights).

No reference analogue: the reference neither measures nor bounds the
fault tolerance of anything it builds (its t is a constructor input,
reference: css_code.py:60-71).

Port of `qcss_tpu.decode.fault_distance` (host numpy and scipy, no
device work). Everything but the witness is the JAX package's text. The
witness differs by design: the JAX package maps each double-cover hop
back to an edge by its endpoints alone, so between two detectors joined
by parallel edges of different labels it can return the wrong edge, and
its witness need not be an odd cycle (the distance is right either way).
Here each hop is keyed on its endpoints and its label (whether it
crosses cover levels), with the lightest edge of that key where
``weighted=True``, and the witness is checked to be an odd cycle.
"""

from __future__ import annotations

import numpy as np

from qcss_tpu_torch.decode.uf import MatchingGraph


def observable_fault_distance(graph: MatchingGraph, obs_bit: int = 0, *,
                              weighted: bool = False,
                              with_witness: bool = False):
    """Exact fault distance of one observable bit on a matching graph.

    Returns ``(distance, n_min)`` where ``n_min`` counts the base
    vertices achieving the minimum (cycles of length L are counted at L
    base vertices, so ``n_min / distance`` estimates the number of
    distinct minimal configurations — the coefficient of the leading
    failure order). ``distance`` is ``None`` when no odd cycle exists
    (the channel is topologically protected at every order — only
    possible when the observable label is a potential on the graph).

    ``weighted=True`` measures cycles by the graph's integer growth
    weights (-log likelihood) instead of fault count.
    ``with_witness=True`` additionally returns one minimal odd cycle as
    an edge-index array (third element of the tuple).
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra

    V = graph.num_nodes
    B = V            # virtual boundary vertex
    NV = V + 1
    edges = np.asarray(graph.edges, np.int64)
    lab = ((np.asarray(graph.edge_obs, np.uint32) >> obs_bit) & 1
           ).astype(np.int64)
    if weighted:
        w = np.asarray(graph.edge_weight, np.int64)
    else:
        w = np.ones(edges.shape[0], np.int64)
    u = np.where(edges[:, 0] < 0, B, edges[:, 0])
    v = np.where(edges[:, 1] < 0, B, edges[:, 1])

    # double cover: (x, s) -> x + s * NV
    src = np.concatenate([u, u + NV, v, v + NV])
    dst = np.concatenate([v + lab * NV, v + (1 - lab) * NV,
                          u + lab * NV, u + (1 - lab) * NV])
    ww = np.concatenate([w, w, w, w]).astype(np.float64)
    # parallel edges (same endpoints, same label — e.g. a node with two
    # boundary edges) must keep the MINIMUM weight; coo_matrix would
    # SUM duplicates, silently inflating distances
    flat = src * (2 * NV) + dst
    order = np.argsort(flat, kind="stable")
    flat, ww = flat[order], ww[order]
    first = np.concatenate([[True], flat[1:] != flat[:-1]])
    grp = np.cumsum(first) - 1
    w_min = np.full(int(grp[-1]) + 1, np.inf)
    np.minimum.at(w_min, grp, ww)
    flat_u = flat[first]
    m = coo_matrix((w_min, (flat_u // (2 * NV), flat_u % (2 * NV))),
                   shape=(2 * NV, 2 * NV)).tocsr()

    # shortest (x, 0) -> (x, 1) over all x. Only vertices touched by an
    # odd edge can start a minimal odd cycle's BFS profitably, but
    # running all sources keeps it simple; dijkstra from the level-0
    # block only.
    dist = dijkstra(m, directed=False, indices=np.arange(NV))
    per_v = dist[np.arange(NV), np.arange(NV) + NV]
    finite = np.isfinite(per_v)
    if not finite.any():
        return (None, 0, None) if with_witness else (None, 0)
    d_min = per_v[finite].min()
    n_min = int((per_v[finite] == d_min).sum())
    d_min = int(d_min)
    if not with_witness:
        return d_min, n_min

    # witness: reconstruct one shortest odd cycle by predecessor chase
    x0 = int(np.arange(NV)[finite][int(np.argmin(per_v[finite]))])
    _, pred = dijkstra(m, directed=False, indices=x0,
                       return_predecessors=True)
    path = [x0 + NV]
    while path[-1] != x0:
        p = int(pred[path[-1]])
        if p < 0:
            raise AssertionError("predecessor chase left the shortest path")
        path.append(p)
    # map cover-vertex hops back to edge indices: a hop joins base
    # vertices (a, b) and crosses cover levels iff its edge's label is 1,
    # so parallel edges of different labels are different hops; of the
    # edges of one key, the lightest is the one the distance counted
    key = {}
    for e in range(edges.shape[0]):
        for a, b in ((int(u[e]), int(v[e])), (int(v[e]), int(u[e]))):
            k = (a, b, int(lab[e]))
            if k not in key or w[e] < w[key[k]]:
                key[k] = e
    wit = []
    for a, b in zip(path[:-1], path[1:]):
        wit.append(key[(a % NV, b % NV, int((a >= NV) != (b >= NV)))])
    wit = np.asarray(wit, np.int64)
    if int(lab[wit].sum()) % 2 != 1:
        raise AssertionError("the witness is not an odd cycle")
    return d_min, n_min, wit


def model_fault_distances(model, *, weighted: bool = False) -> dict:
    """Per-observable fault distances of a `patches.ScheduleModel`
    (or any object with ``.graph`` and ``.meta['obs_names']``).
    Returns {name: (distance, n_min)}."""
    names = model.meta.get("obs_names")
    if names is None:
        names = [f"obs{i}" for i in range(model.obs.shape[0])]
    out = {}
    for i, name in enumerate(names):
        out[name] = observable_fault_distance(model.graph, i,
                                              weighted=weighted)
    return out
