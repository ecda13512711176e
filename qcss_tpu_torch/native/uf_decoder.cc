// Batched union-find decoder for matchable codes (surface/toric/repetition),
// host-native. The reference has no decoder beyond dense syndrome LUTs
// (reference: css_code.py:649-735), which cap out near 2^14 syndromes; this
// kernel decodes arbitrary-distance matching graphs — including 3D
// spacetime graphs for multi-round memory experiments — at millions of
// shots per second across host threads, while syndromes are produced on
// the TPU.
//
// Algorithm: Delfosse-Nickerson union-find ("Almost-linear time decoding
// algorithm for topological codes", arXiv:1709.06218): grow clusters of
// half-edges around odd-parity defects, union on contact, stop clusters
// that become even or touch a boundary; then peel a spanning forest of the
// grown subgraph leaf-first, emitting an edge into the correction whenever
// the leaf carries a defect.
//
// The growth stage is the paper's near-linear form: each active cluster
// root owns a boundary-edge list (weighted-merged on union, stale entries
// filtered lazily), so a round touches only frontier edges instead of
// rescanning the whole edge set. Growth uses snapshot semantics — all
// increments of a round are computed before any union — which makes the
// support trajectory identical to a whole-edge-scan implementation (the
// Python fallback in qcss_tpu/decode/uf.py keeps that form; the two are
// differentially tested for bit-identity).
//
// Graph encoding (shared with the Python fallback):
//   edges      [E,2] int32 detector indices, -1 encodes the boundary
//   edge_qubit [E]   int32 data-qubit flipped by this edge (-1: none, e.g.
//                    measurement-error edges in spacetime graphs)
//   edge_obs   [E]   uint32 bitmask of logical observables the edge flips

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

namespace {

struct Graph {
  const int32_t* edges;
  const int32_t* edge_qubit;
  const uint32_t* edge_obs;
  const uint8_t* edge_weight;  // growth halves to saturation (2 = unweighted)
  int32_t num_nodes;  // real detectors; the virtual boundary is node num_nodes
  int32_t num_edges;
  int32_t n_qubits;
  // CSR of vertex -> incident edges (built once per call, shared by threads)
  std::vector<int32_t> csr_off;   // [num_nodes + 2]
  std::vector<int32_t> csr_edge;  // [2E]
};

void build_csr(Graph& g) {
  int32_t nv = g.num_nodes + 1;  // + boundary vertex
  g.csr_off.assign(nv + 1, 0);
  auto vert = [&](int32_t x) { return x < 0 ? g.num_nodes : x; };
  for (int32_t e = 0; e < g.num_edges; ++e) {
    g.csr_off[vert(g.edges[2 * e]) + 1]++;
    g.csr_off[vert(g.edges[2 * e + 1]) + 1]++;
  }
  for (int32_t v = 0; v < nv; ++v) g.csr_off[v + 1] += g.csr_off[v];
  g.csr_edge.resize(2 * (size_t)g.num_edges);
  std::vector<int32_t> cur(g.csr_off.begin(), g.csr_off.end() - 1);
  for (int32_t e = 0; e < g.num_edges; ++e) {
    g.csr_edge[cur[vert(g.edges[2 * e])]++] = e;
    g.csr_edge[cur[vert(g.edges[2 * e + 1])]++] = e;
  }
}

struct Scratch {
  // union-find state over num_nodes + 1 vertices (last = boundary)
  std::vector<int32_t> parent;
  std::vector<int8_t> rnk;
  std::vector<uint8_t> parity;    // defect count mod 2 per root
  std::vector<uint8_t> boundary;  // root touches the boundary
  std::vector<uint8_t> support;   // per-edge growth in {0,1,2}
  std::vector<uint8_t> defect;    // per-vertex defect for peeling
  // frontier growth
  std::vector<std::vector<int32_t>> bound;  // per-root boundary edge lists
  std::vector<uint8_t> materialized;        // bound[v] holds v's CSR edges
  std::vector<int32_t> dirty;               // bound[]/materialized[] to reset
  std::vector<int32_t> active, next_active, merges;
  std::vector<int32_t> stamp;               // dedupe epochs per vertex
  int32_t epoch = 0;
  std::vector<int32_t> touched_edges;       // support[] entries to reset
  std::vector<int32_t> grown;               // saturated edges (the forest)
  // adjacency over grown edges, rebuilt per shot
  std::vector<int32_t> head;      // per-vertex list head (edge slot index)
  std::vector<int32_t> nxt;       // [2E] next slot
  std::vector<int32_t> slot_to;   // [2E] target vertex
  std::vector<int32_t> slot_edge; // [2E] edge id
  // forest order
  std::vector<int32_t> order;        // visit order (vertices)
  std::vector<int32_t> parent_vert;  // per-vertex forest parent (-2 root)
  std::vector<int32_t> parent_edge;  // per-vertex forest parent edge
  std::vector<uint8_t> visited;

  void init(const Graph& g) {
    int32_t nv = g.num_nodes + 1;
    parent.resize(nv);
    rnk.resize(nv);
    parity.resize(nv);
    boundary.resize(nv);
    support.resize(g.num_edges);
    defect.resize(nv);
    bound.resize(nv);
    materialized.assign(nv, 0);
    stamp.assign(nv, -1);
    head.resize(nv);
    nxt.resize(2 * (size_t)g.num_edges);
    slot_to.resize(2 * (size_t)g.num_edges);
    slot_edge.resize(2 * (size_t)g.num_edges);
    order.reserve(nv);
    parent_vert.resize(nv);
    parent_edge.resize(nv);
    visited.resize(nv);
  }

  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }

  void materialize(const Graph& g, int32_t v) {
    if (materialized[v]) return;
    materialized[v] = 1;
    bound[v].assign(g.csr_edge.begin() + g.csr_off[v],
                    g.csr_edge.begin() + g.csr_off[v + 1]);
    dirty.push_back(v);
  }

  // Union two roots, merging defect parity, boundary contact, and the
  // frontier lists (smaller appended to larger). Returns the new root.
  int32_t unite(const Graph& g, int32_t a, int32_t b) {
    if (a == b) return a;
    materialize(g, a);
    materialize(g, b);
    if (rnk[a] < rnk[b]) std::swap(a, b);
    parent[b] = a;
    parity[a] ^= parity[b];
    boundary[a] |= boundary[b];
    if (rnk[a] == rnk[b]) rnk[a]++;
    if (bound[a].size() < bound[b].size()) bound[a].swap(bound[b]);
    bound[a].insert(bound[a].end(), bound[b].begin(), bound[b].end());
    bound[b].clear();  // capacity kept: reused across shots
    return a;
  }
};

inline bool cluster_active(Scratch& s, int32_t root) {
  return s.parity[root] && !s.boundary[root];
}

void decode_one(const Graph& g, const uint8_t* syn, const uint8_t* wt,
                uint8_t* corr, uint32_t* obs_out, Scratch& s) {
  const int32_t N = g.num_nodes;
  const int32_t B = N;  // virtual boundary vertex

  // reset only what the previous shot touched
  for (int32_t v : s.dirty) {
    s.bound[v].clear();
    s.materialized[v] = 0;
  }
  s.dirty.clear();
  for (int32_t e : s.touched_edges) s.support[e] = 0;
  s.touched_edges.clear();
  s.grown.clear();

  int32_t n_defects = 0;
  s.active.clear();
  for (int32_t i = 0; i < N; ++i) {
    s.parent[i] = i;
    s.rnk[i] = 0;
    s.parity[i] = syn[i] & 1;
    s.boundary[i] = 0;
    s.defect[i] = syn[i] & 1;
    if (syn[i] & 1) {
      n_defects++;
      s.active.push_back(i);
    }
  }
  s.parent[B] = B;
  s.rnk[B] = 0;
  s.parity[B] = 0;
  s.boundary[B] = 1;
  s.defect[B] = 0;

  uint32_t obs = 0;
  if (n_defects == 0) {
    *obs_out = 0;
    return;
  }

  for (int32_t v : s.active) s.materialize(g, v);

  // -- growth (frontier form, snapshot semantics) ----------------------------
  // Round: every boundary edge of every active cluster gains one half per
  // active endpoint (an edge shared by two active frontiers appears in
  // both lists). No union happens until the round's growth is done, so
  // increments match a whole-edge-scan snapshot implementation exactly.
  while (!s.active.empty()) {
    bool grew = false;
    s.merges.clear();
    for (int32_t root : s.active) {
      auto& blist = s.bound[root];
      size_t w = 0;
      for (size_t ri = 0; ri < blist.size(); ++ri) {
        int32_t e = blist[ri];
        if (s.support[e] >= wt[e]) continue;  // saturated
        int32_t u = g.edges[2 * e];
        int32_t v = g.edges[2 * e + 1];
        int32_t ru = s.find(u < 0 ? B : u);
        int32_t rv = s.find(v < 0 ? B : v);
        if (ru == rv) continue;  // stale: became internal
        grew = true;
        if (s.support[e] == 0) s.touched_edges.push_back(e);
        if (++s.support[e] >= wt[e]) {
          s.merges.push_back(e);
          s.grown.push_back(e);
        }
        blist[w++] = e;
      }
      blist.resize(w);
    }
    for (int32_t e : s.merges) {
      int32_t u = g.edges[2 * e];
      int32_t v = g.edges[2 * e + 1];
      int32_t ru = s.find(u < 0 ? B : u);
      int32_t rv = s.find(v < 0 ? B : v);
      if (ru != rv) s.unite(g, ru, rv);
    }
    // next round's active roots: survivors + merge winners, deduped
    s.epoch++;
    s.next_active.clear();
    for (int32_t root : s.active) {
      int32_t r = s.find(root);
      if (s.stamp[r] == s.epoch) continue;
      s.stamp[r] = s.epoch;
      if (cluster_active(s, r)) s.next_active.push_back(r);
    }
    s.active.swap(s.next_active);
    if (!grew && !s.active.empty()) break;  // defensive: stuck defect
  }

  // -- peeling ---------------------------------------------------------------
  // Spanning forest of the grown subgraph, rooted at the boundary first so
  // boundary-touching clusters can discharge their last defect into it.
  // Only vertices incident to grown edges (plus the boundary) take part,
  // so resets touch that set, not the whole graph.
  // The forest — and hence which of several equivalent corrections comes
  // out — must match the whole-edge-scan reference implementation, which
  // inserts adjacency slots in ascending edge-index order. Sort the
  // (small) grown list rather than rescanning all E edges; also reset
  // head/visited only for participating vertices. Defects are reset
  // explicitly too so the defensive stuck-defect break can't leave stale
  // bits (normally every defect is an endpoint of some grown edge).
  std::sort(s.grown.begin(), s.grown.end());
  s.head[B] = -1;
  s.visited[B] = 0;
  for (int32_t i = 0; i < N; ++i) {
    if (s.defect[i]) {
      s.head[i] = -1;
      s.visited[i] = 0;
    }
  }
  for (int32_t e : s.grown) {
    int32_t u = g.edges[2 * e];
    int32_t v = g.edges[2 * e + 1];
    int32_t a = u < 0 ? B : u;
    int32_t b = v < 0 ? B : v;
    s.head[a] = s.head[b] = -1;
    s.visited[a] = s.visited[b] = 0;
  }
  int32_t n_slots = 0;
  for (int32_t e : s.grown) {
    int32_t u = g.edges[2 * e];
    int32_t v = g.edges[2 * e + 1];
    int32_t a = u < 0 ? B : u;
    int32_t b = v < 0 ? B : v;
    s.slot_to[n_slots] = b;
    s.slot_edge[n_slots] = e;
    s.nxt[n_slots] = s.head[a];
    s.head[a] = n_slots++;
    s.slot_to[n_slots] = a;
    s.slot_edge[n_slots] = e;
    s.nxt[n_slots] = s.head[b];
    s.head[b] = n_slots++;
  }
  s.order.clear();

  auto bfs_from = [&](int32_t root) {
    s.visited[root] = 1;
    s.parent_vert[root] = -2;
    s.parent_edge[root] = -1;
    size_t qhead = s.order.size();
    s.order.push_back(root);
    while (qhead < s.order.size()) {
      int32_t v = s.order[qhead++];
      for (int32_t slot = s.head[v]; slot >= 0; slot = s.nxt[slot]) {
        int32_t w = s.slot_to[slot];
        if (s.visited[w]) continue;
        s.visited[w] = 1;
        s.parent_vert[w] = v;
        s.parent_edge[w] = s.slot_edge[slot];
        s.order.push_back(w);
      }
    }
  };

  bfs_from(B);
  for (int32_t i = 0; i < N; ++i)
    if (!s.visited[i] && s.defect[i]) bfs_from(i);

  // Leaf-first: reverse BFS order. A defect at a leaf selects its parent
  // edge and hands the defect up; even clusters and boundary-rooted trees
  // absorb everything.
  for (size_t idx = s.order.size(); idx-- > 0;) {
    int32_t v = s.order[idx];
    if (!s.defect[v] || s.parent_vert[v] < 0) continue;
    int32_t e = s.parent_edge[v];
    s.defect[v] = 0;
    s.defect[s.parent_vert[v]] ^= 1;
    obs ^= g.edge_obs[e];
    int32_t q = g.edge_qubit[e];
    if (corr != nullptr && q >= 0) corr[q] ^= 1;
  }
  s.defect[B] = 0;
  *obs_out = obs;
}

void decode_range(const Graph* g, const uint8_t* syndromes,
                  const uint8_t* shot_weights, int64_t lo, int64_t hi,
                  uint8_t* corrections, uint32_t* obs_out) {
  Scratch s;
  s.init(*g);
  for (int64_t b = lo; b < hi; ++b) {
    uint8_t* corr = nullptr;
    if (corrections != nullptr) {
      corr = corrections + b * (int64_t)g->n_qubits;
      std::memset(corr, 0, g->n_qubits);
    }
    const uint8_t* wt =
        shot_weights != nullptr ? shot_weights + b * (int64_t)g->num_edges
                                : g->edge_weight;
    decode_one(*g, syndromes + b * (int64_t)g->num_nodes, wt, corr,
               obs_out + b, s);
  }
}

}  // namespace

// shot_weights: optional [batch, num_edges] per-shot growth weights
// (nullptr = use edge_weight for every shot) — the hook two-pass
// correlated decoding uses to make X-correction-conditioned Z edges cheap.
extern "C" int32_t qcss_uf_decode_batch(
    const int32_t* edges, const int32_t* edge_qubit, const uint32_t* edge_obs,
    const uint8_t* edge_weight,
    int32_t num_nodes, int32_t num_edges, int32_t n_qubits,
    const uint8_t* syndromes, int64_t batch, uint8_t* corrections,
    uint32_t* obs_out, const uint8_t* shot_weights, int32_t n_threads) {
  if (num_nodes <= 0 || num_edges <= 0 || batch < 0) return 1;
  Graph g{edges, edge_qubit, edge_obs, edge_weight,
          num_nodes, num_edges, n_qubits, {}, {}};
  build_csr(g);
  if (n_threads <= 1 || batch < 2 * n_threads) {
    decode_range(&g, syndromes, shot_weights, 0, batch, corrections, obs_out);
    return 0;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (batch + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(batch, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(decode_range, &g, syndromes, shot_weights, lo, hi,
                         corrections, obs_out);
  }
  for (auto& th : threads) th.join();
  return 0;
}
