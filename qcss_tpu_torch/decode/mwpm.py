"""Exact minimum-weight perfect matching decoding.

Decodes a `MatchingGraph` (the same graph objects `UFDecoder` uses,
weights included) by exact MWPM: all-pairs shortest paths over the
weighted matching graph (Dijkstra, cached per source) reduce each shot to
a small complete graph on its defects — with one virtual partner per
defect carrying its boundary distance, so "match to boundary" is just
another pairing — which is solved exactly.

Two exact solvers share that reduction:

* ``'dp'`` — bitmask dynamic programming, O(2^k · k) for k defects; the
  fastest exact method for k ≲ 16.
* ``'blossom'`` — the O(V^3) blossom algorithm (`decode.blossom`), no
  defect-count limit; this is the production path.

``method='auto'`` (default) picks per shot. Union-find
(`decode.uf.UFDecoder`) remains the speed decoder; MWPM is the accuracy
decoder and the oracle UF is benchmarked against (tests/test_mwpm.py,
benchmarks/uf_bench.py).

(No reference counterpart of any kind — the reference's decoding is a
dense LUT, css_code.py:649-735.)
"""

from __future__ import annotations

import heapq

import numpy as np

from qcss_tpu_torch import native
from qcss_tpu_torch.decode.blossom import min_weight_perfect_matching
from qcss_tpu_torch.decode.uf import MatchingGraph


class MWPMDecoder:
    """Exact matching decoder over a fixed `MatchingGraph`.

    `decode_batch(syndromes)` takes `[B, num_nodes]` 0/1 detection events
    and returns `[B]` uint32 observable-flip bitmasks (matching
    `UFDecoder`'s obs output). Exact: the returned correction class has
    minimum total -log-likelihood weight for every shot.
    """

    #: defect counts up to this solve by bitmask DP under method='auto'
    DP_CUTOVER = 13

    def __init__(self, graph: MatchingGraph, method: str = "auto",
                 use_native: bool | None = None):
        if method not in ("auto", "dp", "blossom"):
            raise ValueError(f"unknown method {method!r}")
        self.graph = graph
        self.method = method
        # The native kernel (mwpm_decoder.cc) implements the 'auto' solver
        # split; forcing a specific solver runs pure Python.
        if use_native and method != "auto":
            raise ValueError(
                "use_native=True supports only method='auto' (the native "
                "kernel hardwires the DP/blossom cutover)"
            )
        if use_native is None:
            use_native = method == "auto" and native.available()
        self._native = None
        if use_native:
            self._native = native.mwpm_create_native(
                graph.edges, graph.edge_qubit, graph.edge_obs,
                graph.edge_weight, graph.num_nodes, graph.n_qubits,
            )
        self._adj = self._build_adjacency()
        # lazily cached single-source results: node -> (dist[], obs-par[])
        self._sssp_cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def _build_adjacency(self):
        g = self.graph
        adj: list[list[tuple[int, int, int, int]]] = [
            [] for _ in range(g.num_nodes + 1)
        ]
        B = g.num_nodes
        for e in range(g.num_edges):
            u = int(g.edges[e, 0])
            v = int(g.edges[e, 1])
            a = B if u < 0 else u
            b = B if v < 0 else v
            w = int(g.edge_weight[e])
            obs = int(g.edge_obs[e])
            adj[a].append((b, w, obs, e))
            adj[b].append((a, w, obs, e))
        return adj

    def _sssp(self, src: int):
        """Dijkstra from src: (dist, obs-parity-of-shortest-path,
        predecessor-vertex, predecessor-edge) arrays over all vertices
        incl. the boundary (index num_nodes)."""
        cached = self._sssp_cache.get(src)
        if cached is not None:
            return cached
        nv = self.graph.num_nodes + 1
        dist = np.full(nv, np.iinfo(np.int64).max, dtype=np.int64)
        par = np.zeros(nv, dtype=np.uint32)
        prev_vert = np.full(nv, -1, dtype=np.int32)
        prev_edge = np.full(nv, -1, dtype=np.int32)
        dist[src] = 0
        pq = [(0, src)]
        while pq:
            d, v = heapq.heappop(pq)
            if d > dist[v]:
                continue
            for w_vert, w_cost, obs, e in self._adj[v]:
                nd = d + w_cost
                if nd < dist[w_vert]:
                    dist[w_vert] = nd
                    par[w_vert] = par[v] ^ obs
                    prev_vert[w_vert] = v
                    prev_edge[w_vert] = e
                    heapq.heappush(pq, (nd, w_vert))
        out = (dist, par, prev_vert, prev_edge)
        self._sssp_cache[src] = out
        return out

    def _path_qubits(self, src: int, dst: int, corr: np.ndarray) -> None:
        """XOR the data qubits of the src->dst shortest path into corr."""
        g = self.graph
        _, _, prev_vert, prev_edge = self._sssp(src)
        v = dst
        while v != src:
            e = int(prev_edge[v])
            q = int(g.edge_qubit[e])
            if q >= 0:
                corr[q] ^= 1
            v = int(prev_vert[v])

    def _defect_graph(self, defects: np.ndarray):
        """Pairwise defect distances/parities + boundary columns."""
        k = len(defects)
        B = self.graph.num_nodes
        dists = np.empty((k, k), dtype=np.int64)
        pars = np.zeros((k, k), dtype=np.uint32)
        bdist = np.empty(k, dtype=np.int64)
        bpar = np.zeros(k, dtype=np.uint32)
        for i, d_i in enumerate(defects):
            dist, par, _, _ = self._sssp(int(d_i))
            dists[i] = dist[defects]
            pars[i] = par[defects]
            bdist[i] = dist[B]
            bpar[i] = par[B]
        return dists, pars, bdist, bpar

    #: unreachable-distance sentinel (Dijkstra init value)
    _UNREACH = np.iinfo(np.int64).max

    @staticmethod
    def _solve_dp(dists, pars, bdist, bpar):
        """Bitmask DP: pair the lowest set bit with the boundary or with
        another defect. Returns (cost, obs parity, pairs) where pairs are
        (i, -1) for boundary matches and (i, j) for defect pairs."""
        unreach = MWPMDecoder._UNREACH
        memo_cost: dict[int, int] = {0: 0}
        memo_par: dict[int, int] = {0: 0}
        memo_pick: dict[int, tuple[int, int]] = {}

        def solve(mask: int):
            if mask in memo_cost:
                return memo_cost[mask], memo_par[mask]
            i = (mask & -mask).bit_length() - 1
            rest = mask & ~(1 << i)
            best = None
            best_par = 0
            best_pick = (i, -1)
            if bdist[i] < unreach:
                c, p = solve(rest)
                best = int(bdist[i]) + c
                best_par = int(bpar[i]) ^ p
            m = rest
            while m:
                j = (m & -m).bit_length() - 1
                m &= m - 1
                if dists[i, j] >= unreach:
                    continue
                c, p = solve(rest & ~(1 << j))
                cand = int(dists[i, j]) + c
                if best is None or cand < best:
                    best = cand
                    best_par = int(pars[i, j]) ^ p
                    best_pick = (i, j)
            if best is None:
                raise ValueError(
                    "syndrome not matchable on this graph (odd defect "
                    "count in a boundaryless component)"
                )
            memo_cost[mask] = best
            memo_par[mask] = best_par
            memo_pick[mask] = best_pick
            return best, best_par

        full = (1 << len(bdist)) - 1
        cost, par = solve(full)
        pairs = []
        mask = full
        while mask:
            i, j = memo_pick[mask]
            pairs.append((i, j))
            mask &= ~(1 << i)
            if j >= 0:
                mask &= ~(1 << j)
        return cost, par, pairs

    @staticmethod
    def _solve_blossom(dists, pars, bdist, bpar):
        """Blossom on 2k nodes: defects 0..k-1 plus a virtual partner k+i
        per defect (edge i—(k+i) carries the boundary distance; virtual
        partners pair among themselves for free). Returns
        (cost, obs parity, pairs) — same pair encoding as `_solve_dp`."""
        k = len(bdist)
        unreach = MWPMDecoder._UNREACH
        edges = []
        for i in range(k):
            for j in range(i + 1, k):
                if dists[i, j] < unreach:
                    edges.append((i, j, int(dists[i, j])))
                edges.append((k + i, k + j, 0))
            if bdist[i] < unreach:
                edges.append((i, k + i, int(bdist[i])))
        try:
            mate = min_weight_perfect_matching(2 * k, edges)
        except ValueError:
            raise ValueError(
                "syndrome not matchable on this graph (odd defect "
                "count in a boundaryless component)"
            ) from None
        cost = 0
        par = 0
        pairs = []
        for i in range(k):
            m = mate[i]
            if m == k + i:
                cost += int(bdist[i])
                par ^= int(bpar[i])
                pairs.append((i, -1))
            elif m < k and m > i:
                cost += int(dists[i, m])
                par ^= int(pars[i, m])
                pairs.append((i, m))
        return cost, par, pairs

    @staticmethod
    def _decompose(dists, bdist):
        """Exactness-preserving defect-graph decomposition (mirrors the
        native kernel): a pair edge with d(i,j) >= bd(i) + bd(j) can be
        replaced by the two boundary pairings at no greater cost, so some
        optimal matching avoids it; dropping those edges splits the
        defects into independent components (ascending member order,
        ordered by smallest member)."""
        unreach = MWPMDecoder._UNREACH
        k = len(bdist)
        parent = list(range(k))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for i in range(k):
            for j in range(i + 1, k):
                if dists[i, j] >= unreach:
                    continue
                if (bdist[i] < unreach and bdist[j] < unreach
                        and dists[i, j] >= bdist[i] + bdist[j]):
                    continue
                a, b = find(i), find(j)
                if a != b:
                    parent[max(a, b)] = min(a, b)
        comps: dict[int, list[int]] = {}
        for i in range(k):
            comps.setdefault(find(i), []).append(i)
        return [comps[r] for r in sorted(comps)]

    def decode_one(self, syn: np.ndarray, corr: np.ndarray | None = None) -> int:
        """Decode one shot; returns the observable-flip bitmask. When
        ``corr`` (a zeroed `[n_qubits]` uint8 buffer) is passed, the
        per-qubit correction is XORed into it."""
        defects = np.nonzero(np.asarray(syn) & 1)[0]
        k = len(defects)
        if k == 0:
            return 0
        dg = self._defect_graph(defects)
        if self.method == "auto":
            # decomposed solve, component-for-component the native kernel
            dists, pars, bdist, bpar = dg
            par = 0
            pairs = []
            for comp in self._decompose(dists, bdist):
                idx = np.asarray(comp)
                sub = (dists[np.ix_(idx, idx)], pars[np.ix_(idx, idx)],
                       bdist[idx], bpar[idx])
                if len(comp) <= self.DP_CUTOVER:
                    _, p, sub_pairs = self._solve_dp(*sub)
                else:
                    _, p, sub_pairs = self._solve_blossom(*sub)
                par ^= p
                pairs.extend(
                    (comp[i], -1 if j < 0 else comp[j]) for i, j in sub_pairs)
        elif self.method == "dp":
            _, par, pairs = self._solve_dp(*dg)
        else:
            _, par, pairs = self._solve_blossom(*dg)
        if corr is not None:
            B = self.graph.num_nodes
            for i, j in pairs:
                src = int(defects[i])
                dst = B if j < 0 else int(defects[j])
                self._path_qubits(src, dst, corr)
        return par

    def decode_batch(self, syndromes: np.ndarray, want_corrections: bool = True,
                     n_threads: int | None = None):
        """UFDecoder-compatible batch decode: `[B, num_nodes]` 0/1
        detection events -> (corrections `[B, n_qubits]` uint8 | None,
        obs-flip bitmasks `[B]` uint32)."""
        syndromes = np.asarray(syndromes)
        if self._native is not None:
            return self._native.decode_batch(
                syndromes, want_corrections, n_threads)
        batch = syndromes.shape[0]
        obs = np.zeros(batch, dtype=np.uint32)
        corr = (
            np.zeros((batch, self.graph.n_qubits), dtype=np.uint8)
            if want_corrections
            else None
        )
        for b in range(batch):
            obs[b] = self.decode_one(
                syndromes[b], None if corr is None else corr[b]
            )
        return corr, obs


class MWPMOracle(MWPMDecoder):
    """Back-compat evaluation wrapper: DP-only, shots whose defect count
    exceeds ``max_defects`` are skipped and reported (the original
    round-2 oracle contract; `MWPMDecoder` has no such limit)."""

    def __init__(self, graph: MatchingGraph, max_defects: int = 16):
        super().__init__(graph, method="dp")
        self.max_defects = max_defects

    def decode_one(self, syn: np.ndarray):
        """Returns (obs_flips, ok). ok=False if the defect count exceeds
        max_defects (shot skipped)."""
        defects = np.nonzero(np.asarray(syn) & 1)[0]
        k = len(defects)
        if k == 0:
            return 0, True
        if k > self.max_defects:
            return 0, False
        _, par, _ = self._solve_dp(*self._defect_graph(defects))
        return par, True

    def decode_batch(self, syndromes: np.ndarray):
        """Returns (obs [B] uint32, ok [B] bool)."""
        syndromes = np.asarray(syndromes)
        obs = np.zeros(syndromes.shape[0], dtype=np.uint32)
        ok = np.ones(syndromes.shape[0], dtype=bool)
        for b in range(syndromes.shape[0]):
            obs[b], ok[b] = self.decode_one(syndromes[b])
        return obs, ok
