"""Sparse-defect union-find decoding: defect-granular ball growth (PyTorch
port of `qcss_tpu.decode.device_sparse`).

At operating noise a d=11 R=11 DEM shot carries a handful of defects out
of 720 detectors, so this path decodes at DEFECT granularity: per-shot
work scales with (defects)^2, not V. Each defect i carries a growth
radius r_i; two clusters merge when r_i + r_j >= dist(v_i, v_j) for some
defect pair across them; a cluster freezes when its defect parity is even
or its ball reaches the boundary (r_i >= bdist(v_i)). With exact
all-pairs graph distances this evolves the same cluster merge structure
as the vertex-granular decoder, at [B, D, D] cost instead of [B, V].

Observables use a potential decomposition of the edge labels: for a
planar matchable graph there is phi: V -> lane mask with
obs(e=(u,v)) = phi[u] ^ phi[v], so a cluster's flip is XOR phi over its
defects, plus the boundary-side potential of its boundary-connecting
defect for odd clusters.

Routing: a CUDA tensor goes to the hand-written kernel
(`device_sparse_cuda`, the counterpart of the Mosaic `make_growth_kernel`),
which compacts the defects, gathers their geometry and runs the growth
loop in one launch; a CPU tensor goes to the plain version
(`_sparse_plain`: compaction, an int32 index gather, `_growth_core`).

Contract: ``decode(detectors) -> (obs [B] int32, converged [B] bool)``;
shots with more than ``d_max`` defects (or a stuck component: odd
parity, no boundary, nothing to merge with) report converged=False.
`make_hybrid_obs_decoder` runs the dense decoder for exactly those
batches.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from qcss_tpu_torch._cuda import resolve_device
from qcss_tpu_torch.decode.uf import MatchingGraph
from qcss_tpu_torch.ops.gf2_torch import xor_reduce

#: distances at or above this are "unreachable" (distinct components);
#: all real distances must stay below to remain f32-exact after the
#: one-hot matmul fetch (integers < 2^24 are exact in f32).
UNREACH = 1 << 21


@dataclasses.dataclass(frozen=True)
class SparseTables:
    """Host-precomputed geometry for defect-granular decoding."""

    dist: np.ndarray    # [V, V] int32 internal-edge APSP; UNREACH apart
    phi: np.ndarray     # [V] uint32 observable potential (per component)
    bdist: np.ndarray   # [V] int32 distance to the boundary (UNREACH: none)
    bside: np.ndarray   # [V] uint32 boundary potential reached from v
    num_nodes: int


def build_sparse_tables(graph: MatchingGraph) -> SparseTables | None:
    """APSP + observable potential from a MatchingGraph, or None when the
    graph does not admit the sparse path (non-potential observable
    labels, no boundary anywhere — see module docstring)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import dijkstra

    V = graph.num_nodes
    edges = np.asarray(graph.edges)
    wt = np.asarray(graph.edge_weight, np.int64)
    obs = np.asarray(graph.edge_obs, np.uint32)
    if obs.max(initial=0) >= (1 << 24):
        return None  # observable lanes must survive the f32 fetch exactly
    int_m = (edges[:, 0] >= 0) & (edges[:, 1] >= 0)
    b_m = (edges[:, 0] < 0) ^ (edges[:, 1] < 0)
    iu, iv, iw = edges[int_m, 0], edges[int_m, 1], wt[int_m]
    if len({(min(a, b), max(a, b)) for a, b in zip(iu, iv)}) != iu.size:
        return None  # parallel internal edges: obs potential ill-defined

    # -- observable potential via a BFS forest over internal edges
    adj: list[list[tuple[int, int, int]]] = [[] for _ in range(V)]
    for u, v, w, o in zip(iu, iv, iw, obs[int_m]):
        adj[u].append((v, int(w), int(o)))
        adj[v].append((u, int(w), int(o)))
    phi = np.zeros(V, np.uint32)
    seen = np.zeros(V, bool)
    for s in range(V):
        if seen[s]:
            continue
        seen[s] = True
        stack = [s]
        while stack:
            u = stack.pop()
            for v, _, o in adj[u]:
                if not seen[v]:
                    seen[v] = True
                    phi[v] = phi[u] ^ o
                    stack.append(v)
    for u, v, _, o in zip(iu, iv, iw, obs[int_m]):
        if int(phi[u]) ^ int(phi[v]) != int(o):
            return None  # odd-observable internal cycle (e.g. toric wrap)

    # -- internal APSP (int weights; dijkstra returns float64, exact here)
    w2 = np.concatenate([iw, iw])
    r2 = np.concatenate([iu, iv])
    c2 = np.concatenate([iv, iu])
    spm = coo_matrix((w2.astype(np.float64), (r2, c2)), shape=(V, V))
    dist = dijkstra(spm.tocsr(), directed=False)
    dist = np.where(np.isfinite(dist), dist, UNREACH).astype(np.int64)
    if dist[dist < UNREACH].max(initial=0) >= UNREACH // 2:
        return None  # pathological weights

    # -- boundary distance + boundary-side potential via one extra
    #    Dijkstra from a virtual source over the boundary edges
    bu = np.where(edges[b_m, 0] < 0, edges[b_m, 1], edges[b_m, 0])
    bw = wt[b_m]
    bo = obs[b_m]
    if bu.size == 0:
        # no boundary anywhere: odd-defect components could never pair
        # off, so the sparse decoder would report converged=False on
        # every odd shot — refuse, per the documented contract, and let
        # callers keep the dense kernel
        return None
    bdist = np.full(V, UNREACH, np.int64)
    bside = np.zeros(V, np.uint32)
    if bu.size:
        # seed: per boundary-attached vertex, its cheapest boundary edge
        seed_d = np.full(V, UNREACH, np.int64)
        seed_s = np.zeros(V, np.uint32)
        for e in range(bu.size):  # first-edge-wins tie-break (strict <)
            u = int(bu[e])
            if bw[e] < seed_d[u]:
                seed_d[u] = int(bw[e])
                # boundary potential: phi at the attachment point XOR the
                # boundary edge's obs — a cluster pairing defect m to the
                # boundary flips phi[m] ^ bside[m]
                seed_s[u] = np.uint32(int(phi[u]) ^ int(bo[e]))
        # bdist[v] = min_u (dist[v, u] + seed_d[u]); pick the argmin's side
        cand = dist + seed_d[None, :]              # [V, V]
        arg = np.argmin(cand, axis=1)
        bdist = cand[np.arange(V), arg]
        bside = seed_s[arg]
        bdist = np.minimum(bdist, UNREACH)

    return SparseTables(
        dist=dist.astype(np.int32),
        phi=phi,
        bdist=bdist.astype(np.int32),
        bside=bside.astype(np.uint32),
        num_nodes=V,
    )


def sparse_tables_from_numpy(dist, phi, bdist, bside,
                             num_nodes: int) -> SparseTables:
    """`SparseTables` from numpy arrays (e.g. the JAX package's tables), so
    that both packages decode with identical geometry."""
    return SparseTables(
        dist=np.asarray(dist, np.int32),
        phi=np.asarray(phi, np.uint32),
        bdist=np.asarray(bdist, np.int32),
        bside=np.asarray(bside, np.uint32),
        num_nodes=int(num_nodes),
    )


def _tables_to(tables: SparseTables, device):
    """(dist, phi, bdist, bside) as int32 tensors on ``device``. The
    potentials are below 2^24, so int32 holds them unchanged."""
    return (torch.as_tensor(tables.dist, dtype=torch.int32).to(device),
            torch.as_tensor(tables.phi.astype(np.int64))
            .to(torch.int32).to(device),
            torch.as_tensor(tables.bdist, dtype=torch.int32).to(device),
            torch.as_tensor(tables.bside.astype(np.int64))
            .to(torch.int32).to(device))


def _sparse_decode(tables_dev, d_max, max_events, detectors):
    """The defect-granular decode: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if not isinstance(detectors, torch.Tensor):
        detectors = torch.as_tensor(np.asarray(detectors))
    if detectors.is_cuda:
        from qcss_tpu_torch.decode.device_sparse_cuda import (
            sparse_decode_cuda,
        )

        return sparse_decode_cuda(tables_dev, d_max, max_events, detectors)
    return _sparse_plain(tables_dev, d_max, max_events, detectors)


def _fetch(tables_dev, d_max, detectors):
    """Compact each shot's first ``d_max`` fired detectors to slots in
    ascending detector order and gather their geometry by index:
    (dm [B,D,D], bdm/phim/bsm [B,D] int32, valid [B,D] bool, count [B]).
    Empty slots are infinitely far and carry no potential."""
    dist_t, phi_t, bdist_t, bside_t = tables_dev
    B, V = detectors.shape
    D = d_max
    BIG = UNREACH
    dev = detectors.device
    defect = detectors.to(torch.int32) & 1
    count = defect.sum(dim=1)
    rank = torch.cumsum(defect, dim=1) - defect
    slot = torch.where(defect > 0, rank, D).clamp(max=D)  # D: dump column
    valid = torch.arange(D, device=dev)[None, :] < count[:, None]
    idx = torch.zeros((B, D + 1), dtype=torch.int64, device=dev)
    idx.scatter_(1, slot.long(),
                 torch.arange(V, device=dev)[None, :].expand(B, V))
    idx = torch.where(valid, idx[:, :D], 0)
    dm = dist_t[idx[:, :, None], idx[:, None, :]]
    eye = torch.eye(D, dtype=torch.bool, device=dev)[None]
    inval = ~valid[:, :, None] | ~valid[:, None, :]
    dm = torch.where(inval | eye, BIG, dm)
    bdm = torch.where(valid, bdist_t[idx], BIG)
    phim = torch.where(valid, phi_t[idx], 0)
    bsm = torch.where(valid, bside_t[idx], 0)
    return dm, bdm, phim, bsm, valid, count


def _sparse_plain(tables_dev, d_max, max_events, detectors):
    """The plain version of the sparse kernel
    (`device_sparse_cuda.sparse_decode_cuda`): detectors [B, V] ->
    (obs [B] int32, converged [B] bool)."""
    dm, bdm, phim, bsm, valid, count = _fetch(tables_dev, d_max, detectors)
    obs, unfinished = _growth_core(dm, bdm, phim, bsm, valid,
                                   max_events=max_events)
    return obs, (count <= d_max) & ~unfinished


def _growth_core(dm, bdm, phim, bsm, valid, *, max_events):
    """Delta-stepped ball growth + observable extraction on pre-fetched
    defect geometry; a line-for-line port of the reference's
    `_growth_core`. Its batch-wide loops test their fixpoints on the host.

    dm [N,D,D] / bdm,phim,bsm [N,D] int32, valid [N,D] bool.
    Returns (obs [N] int32, unfinished [N] bool)."""
    N, D = bdm.shape
    BIG = UNREACH
    dev = bdm.device
    iota = torch.arange(D, dtype=torch.int32, device=dev)[None, :] \
        .expand(N, D)
    iota_l = torch.arange(D, dtype=torch.int32, device=dev)[None, None, :]
    vi = valid.to(torch.int32)

    def components(sat, root):
        """Min-label connected components of the [N, D, D] saturation
        adjacency, warm-started from ``root`` (merging only adds sat
        edges, so a previous fixpoint is a valid seed)."""
        while True:
            via = torch.where(sat, root[:, None, :], D).amin(dim=2)
            new = torch.minimum(root, via)
            # pointer-jump through the current labels: root <- root[root]
            new = torch.gather(new, 1, new.long())
            changed = bool((new != root).any())
            root = new
            if not changed:
                return root

    def cluster_stats(r, root):
        eq = root[:, :, None] == root[:, None, :]
        cnt = torch.where(eq, vi[:, None, :], 0).sum(dim=2)
        bsat_i = ((r >= bdm) & valid).to(torch.int32)
        btouch_i = (torch.where(eq, bsat_i[:, None, :], 0).sum(dim=2)
                    > 0).to(torch.int32)
        active_i = (valid & ((cnt & 1) == 1) & (btouch_i == 0)) \
            .to(torch.int32)
        return cnt, btouch_i, active_i

    r = torch.zeros((N, D), dtype=torch.int32, device=dev)
    root = iota.clone()
    ev = 0
    cont = bool((vi.amax() > 0)) if N else False
    while cont:
        sat = (r[:, :, None] + r[:, None, :]) >= dm
        root = components(sat, root)
        _, _, ai = cluster_stats(r, root)
        # next events: pair saturation and boundary arrival
        rate = ai[:, :, None] + ai[:, None, :]
        need = dm - r[:, :, None] - r[:, None, :]
        pair_ok = (need > 0) & (rate > 0) & (dm < BIG)
        # ceil(need / rate) with rate in {1, 2}
        step_p = torch.where(pair_ok,
                             torch.where(rate == 2, (need + 1) >> 1, need),
                             BIG)
        bneed = bdm - r
        b_ok = (ai > 0) & (bneed > 0) & (bdm < BIG)
        step_b = torch.where(b_ok, bneed, BIG)
        delta = torch.minimum(step_p.amin(dim=(1, 2))[:, None],
                              step_b.amin(dim=1, keepdim=True))  # [N, 1]
        # shots whose every active cluster is stuck stop growing; their
        # residual activity is detected after the loop
        grow_i = ((ai.amax(dim=1, keepdim=True) > 0)
                  & (delta < BIG)).to(torch.int32)
        r = r + grow_i * ai * torch.where(delta < BIG, delta, 0)
        cont = bool(grow_i.amax() > 0) and ev + 1 < max_events
        ev += 1

    # -- final cluster structure + observable extraction
    sat = (r[:, :, None] + r[:, None, :]) >= dm
    root = components(sat, root)
    eq = root[:, :, None] == root[:, None, :]
    cnt, btouch_i, _ = cluster_stats(r, root)
    odd_b = valid & (root == iota) & ((cnt & 1) == 1) & (btouch_i > 0)
    # boundary-connecting defect of each cluster: among members with
    # bsat, the one with minimal (bdist, slot) — deterministic
    bkey = torch.where((r >= bdm) & valid, bdm, BIG)
    mkey = torch.where(eq, bkey[:, None, :] * D + iota_l, BIG * D)
    mmin = mkey.amin(dim=2)
    mslot = mmin - (mmin // D) * D
    bs_of_m = torch.gather(bsm, 1, mslot.long())
    terms = torch.where(valid, phim, 0) ^ torch.where(odd_b, bs_of_m, 0)
    obs = xor_reduce(terms).to(torch.int32)

    # residual activity (incl. stuck components) = incomplete decode
    unfinished = (valid & ((cnt & 1) == 1) & (btouch_i == 0)).any(dim=1)
    return obs, unfinished


def sparse_decoder_from_tables(tables: SparseTables, *, d_max: int = 32,
                               max_events: int | None = None,
                               device="cuda"):
    """``decode(detectors) -> (obs, converged)`` over given tables, placed
    on ``device`` (the card by default)."""
    device = resolve_device(device)
    d_max = min(d_max, tables.num_nodes)  # compaction cap on tiny graphs
    if max_events is None:
        max_events = d_max * (d_max + 1) // 2 + 4
    return partial(_sparse_decode, _tables_to(tables, device), d_max,
                   max_events)


def make_sparse_obs_decoder(graph: MatchingGraph, *, d_max: int = 32,
                            max_events: int | None = None, device="cuda"):
    """A ``decode(detectors) -> (obs, converged)`` defect-granular decoder
    (same contract as `device_uf.make_obs_decoder`), or None when the
    graph does not admit the sparse path. Shots with more than ``d_max``
    defects report converged=False — compose with
    `make_hybrid_obs_decoder`. ``d_max`` need not be a power of two (the
    reference padded it for the TPU's XOR roll-tree)."""
    tables = build_sparse_tables(graph)
    if tables is None:
        return None
    return sparse_decoder_from_tables(tables, d_max=d_max,
                                      max_events=max_events, device=device)


def make_hybrid_obs_decoder(graph: MatchingGraph, *, d_max: int = 32,
                            device="cuda", **dense_kwargs):
    """Sparse decode with a dense-decoder escape hatch: the defect-granular
    path always runs; iff some shot did not converge there (overflow /
    stuck component), the dense decoder runs too and its result is
    selected for exactly those shots. Falls back to the dense decoder
    alone when the graph refuses the sparse path."""
    from qcss_tpu_torch.decode.device_uf import make_obs_decoder

    dense = make_obs_decoder(graph, device=device, **dense_kwargs)
    sparse = make_sparse_obs_decoder(graph, d_max=d_max, device=device)
    if sparse is None:
        return dense

    def decode(detectors):
        obs_s, conv_s = sparse(detectors)
        # The reference's lax.cond: reading conv_s on the host costs one
        # sync per batch, and spares the dense decode on quiet batches.
        if bool(conv_s.all()):
            return obs_s, conv_s
        obs_d, conv_d = dense(detectors)
        return torch.where(conv_s, obs_s, obs_d), conv_s | conv_d

    return decode
