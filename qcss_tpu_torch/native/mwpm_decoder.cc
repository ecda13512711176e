// Batched exact minimum-weight perfect matching decoder, host-native.
// Same MatchingGraph encoding as uf_decoder.cc; this kernel is the
// production form of qcss_tpu/decode/mwpm.py (the two are differentially
// tested for agreement on optimal matching cost, and for identical obs
// output on tie-free graphs).
//
// Pipeline per graph (handle API — create once, decode many batches):
//   1. create: for graphs up to kApspMaxNodes vertices, all-pairs
//      shortest paths (one Dijkstra per source, threaded) with distance,
//      path obs parity, and predecessor edges. Larger graphs switch to
//      LAZY mode: no precomputation — each shot runs one early-terminated
//      Dijkstra per defect (stopping once every other defect and the
//      boundary are finalized), so memory is O(k * V) transient per
//      worker instead of O(V^2) resident, and V is unbounded.
//   2. decode_batch: each shot reduces to its defect set, which is first
//      DECOMPOSED: a pair edge (i, j) with d(i, j) >= bd(i) + bd(j) can
//      be replaced in any matching by two boundary pairings at no extra
//      cost, so some optimal matching uses no such edge and they are
//      dropped; the surviving edges split the defects into independent
//      components (usually singletons and pairs at operating error
//      rates). Components up to 13 defects solve by bitmask DP, larger
//      ones by the blossom algorithm (Edmonds; primal-dual O(n^3) as
//      organized in Galil's 1986 survey) on 2k nodes, where defect i's
//      virtual partner k+i carries its boundary distance and virtual
//      partners pair freely.
//
// The reference's only decoder is a dense syndrome LUT
// (reference: css_code.py:649-735); it has no matching decoder of any
// kind.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <thread>
#include <utility>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Blossom: exact maximum-weight matching (max-cardinality mode), a direct
// translation of qcss_tpu/decode/blossom.py (whose internal organization
// follows van Rantwijk's public-domain mwmatching.py scheme — see that
// module's docstring). Vertex count per call is 2 * defect_count, so
// sizes stay small; everything is allocated per call.
// ---------------------------------------------------------------------------

struct BEdge {
  int32_t i, j;
  int64_t w;
};

class Blossom {
 public:
  // mate[v] = matched partner or -1.
  static void max_weight_matching(int nvertex, const std::vector<BEdge>& edges,
                                  bool maxcardinality,
                                  std::vector<int32_t>& mate_out) {
    mate_out.assign(nvertex, -1);
    if (nvertex == 0 || edges.empty()) return;
    Blossom b(nvertex, edges, maxcardinality);
    b.run();
    for (int v = 0; v < nvertex; ++v)
      mate_out[v] = b.mate_[v] >= 0 ? b.endpoint_[b.mate_[v]] : -1;
  }

 private:
  int n_;
  const std::vector<BEdge>& edges_;
  bool maxcard_;
  int nedge_;
  int64_t maxweight_;
  std::vector<int32_t> endpoint_;                // [2E]
  std::vector<std::vector<int32_t>> neighbend_;  // [V]
  std::vector<int32_t> mate_;                    // [V] endpoint or -1
  std::vector<int32_t> label_;                   // [2V]
  std::vector<int32_t> labelend_;                // [2V]
  std::vector<int32_t> inblossom_;               // [V]
  std::vector<int32_t> blossomparent_;           // [2V]
  std::vector<std::vector<int32_t>> blossomchilds_;  // [2V]
  std::vector<int32_t> blossombase_;                 // [2V]
  std::vector<std::vector<int32_t>> blossomendps_;   // [2V]
  std::vector<int32_t> bestedge_;                    // [2V]
  std::vector<std::vector<int32_t>> blossombestedges_;  // [2V]
  std::vector<char> bbe_valid_;                         // [2V]
  std::vector<int32_t> unusedblossoms_;
  std::vector<int64_t> dualvar_;  // [2V]
  std::vector<char> allowedge_;   // [E]
  std::vector<int32_t> queue_;

  Blossom(int n, const std::vector<BEdge>& edges, bool maxcard)
      : n_(n), edges_(edges), maxcard_(maxcard), nedge_((int)edges.size()) {
    maxweight_ = 0;
    for (const auto& e : edges_) maxweight_ = std::max(maxweight_, e.w);
    endpoint_.resize(2 * nedge_);
    for (int p = 0; p < 2 * nedge_; ++p)
      endpoint_[p] = (p % 2) ? edges_[p / 2].j : edges_[p / 2].i;
    neighbend_.assign(n_, {});
    for (int k = 0; k < nedge_; ++k) {
      neighbend_[edges_[k].i].push_back(2 * k + 1);
      neighbend_[edges_[k].j].push_back(2 * k);
    }
    mate_.assign(n_, -1);
    label_.assign(2 * n_, 0);
    labelend_.assign(2 * n_, -1);
    inblossom_.resize(n_);
    for (int v = 0; v < n_; ++v) inblossom_[v] = v;
    blossomparent_.assign(2 * n_, -1);
    blossomchilds_.assign(2 * n_, {});
    blossombase_.resize(2 * n_);
    for (int v = 0; v < n_; ++v) blossombase_[v] = v;
    for (int b = n_; b < 2 * n_; ++b) blossombase_[b] = -1;
    blossomendps_.assign(2 * n_, {});
    bestedge_.assign(2 * n_, -1);
    blossombestedges_.assign(2 * n_, {});
    bbe_valid_.assign(2 * n_, 0);
    for (int b = 2 * n_ - 1; b >= n_; --b) unusedblossoms_.push_back(b);
    std::reverse(unusedblossoms_.begin(), unusedblossoms_.end());
    dualvar_.assign(2 * n_, 0);
    for (int v = 0; v < n_; ++v) dualvar_[v] = maxweight_;
    allowedge_.assign(nedge_, 0);
  }

  int64_t slack(int k) const {
    return dualvar_[edges_[k].i] + dualvar_[edges_[k].j] - 2 * edges_[k].w;
  }

  template <typename F>
  void blossom_leaves(int b, F&& f) {
    if (b < n_) {
      f(b);
    } else {
      for (int t : blossomchilds_[b]) blossom_leaves(t, f);
    }
  }

  void assign_label(int w, int t, int p) {
    int b = inblossom_[w];
    label_[w] = label_[b] = t;
    labelend_[w] = labelend_[b] = p;
    bestedge_[w] = bestedge_[b] = -1;
    if (t == 1) {
      blossom_leaves(b, [&](int leaf) { queue_.push_back(leaf); });
    } else {  // t == 2
      int base = blossombase_[b];
      assign_label(endpoint_[mate_[base]], 1, mate_[base] ^ 1);
    }
  }

  int scan_blossom(int v, int w) {
    std::vector<int32_t> path;
    int base = -1;
    while (v != -1 || w != -1) {
      int b = inblossom_[v];
      if (label_[b] & 4) {
        base = blossombase_[b];
        break;
      }
      path.push_back(b);
      label_[b] = 5;
      if (labelend_[b] == -1) {
        v = -1;
      } else {
        v = endpoint_[labelend_[b]];
        b = inblossom_[v];
        v = endpoint_[labelend_[b]];
      }
      if (w != -1) std::swap(v, w);
    }
    for (int b : path) label_[b] = 1;
    return base;
  }

  void add_blossom(int base, int k) {
    int v = edges_[k].i, w = edges_[k].j;
    int bb = inblossom_[base];
    int bv = inblossom_[v];
    int bw = inblossom_[w];
    int b = unusedblossoms_.back();
    unusedblossoms_.pop_back();
    blossombase_[b] = base;
    blossomparent_[b] = -1;
    blossomparent_[bb] = b;
    std::vector<int32_t> path, endps;
    while (bv != bb) {
      blossomparent_[bv] = b;
      path.push_back(bv);
      endps.push_back(labelend_[bv]);
      v = endpoint_[labelend_[bv]];
      bv = inblossom_[v];
    }
    path.push_back(bb);
    std::reverse(path.begin(), path.end());
    std::reverse(endps.begin(), endps.end());
    endps.push_back(2 * k);
    while (bw != bb) {
      blossomparent_[bw] = b;
      path.push_back(bw);
      endps.push_back(labelend_[bw] ^ 1);
      w = endpoint_[labelend_[bw]];
      bw = inblossom_[w];
    }
    blossomchilds_[b] = std::move(path);
    blossomendps_[b] = std::move(endps);
    label_[b] = 1;
    labelend_[b] = labelend_[bb];
    dualvar_[b] = 0;
    blossom_leaves(b, [&](int leaf) {
      if (label_[inblossom_[leaf]] == 2) queue_.push_back(leaf);
      inblossom_[leaf] = b;
    });
    std::vector<int32_t> bestedgeto(2 * n_, -1);
    for (int child : blossomchilds_[b]) {
      auto consider = [&](int ke) {
        int i = edges_[ke].i, j = edges_[ke].j;
        if (inblossom_[j] == b) std::swap(i, j);
        int bj = inblossom_[j];
        if (bj != b && label_[bj] == 1 &&
            (bestedgeto[bj] == -1 || slack(ke) < slack(bestedgeto[bj])))
          bestedgeto[bj] = ke;
      };
      if (!bbe_valid_[child]) {
        blossom_leaves(child, [&](int leaf) {
          for (int p : neighbend_[leaf]) consider(p / 2);
        });
      } else {
        for (int ke : blossombestedges_[child]) consider(ke);
      }
      blossombestedges_[child].clear();
      bbe_valid_[child] = 0;
      bestedge_[child] = -1;
    }
    blossombestedges_[b].clear();
    for (int ke : bestedgeto)
      if (ke != -1) blossombestedges_[b].push_back(ke);
    bbe_valid_[b] = 1;
    bestedge_[b] = -1;
    for (int ke : blossombestedges_[b])
      if (bestedge_[b] == -1 || slack(ke) < slack(bestedge_[b]))
        bestedge_[b] = ke;
  }

  void expand_blossom(int b, bool endstage) {
    for (int s : blossomchilds_[b]) {
      blossomparent_[s] = -1;
      if (s < n_) {
        inblossom_[s] = s;
      } else if (endstage && dualvar_[s] == 0) {
        expand_blossom(s, endstage);
      } else {
        blossom_leaves(s, [&](int leaf) { inblossom_[leaf] = s; });
      }
    }
    if (!endstage && label_[b] == 2) {
      int entrychild = inblossom_[endpoint_[labelend_[b] ^ 1]];
      int len = (int)blossomchilds_[b].size();
      int j = 0;
      while (blossomchilds_[b][j] != entrychild) ++j;
      int jstep, endptrick;
      if (j & 1) {
        j -= len;
        jstep = 1;
        endptrick = 0;
      } else {
        jstep = -1;
        endptrick = 1;
      }
      auto childs = [&](int idx) {
        return blossomchilds_[b][(idx % len + len) % len];
      };
      auto endps = [&](int idx) {
        return blossomendps_[b][(idx % len + len) % len];
      };
      int p = labelend_[b];
      while (j != 0) {
        label_[endpoint_[p ^ 1]] = 0;
        label_[endpoint_[endps(j - endptrick) ^ endptrick ^ 1]] = 0;
        assign_label(endpoint_[p ^ 1], 2, p);
        allowedge_[endps(j - endptrick) / 2] = 1;
        j += jstep;
        p = endps(j - endptrick) ^ endptrick;
        allowedge_[p / 2] = 1;
        j += jstep;
      }
      int bv = childs(j);
      label_[endpoint_[p ^ 1]] = label_[bv] = 2;
      labelend_[endpoint_[p ^ 1]] = labelend_[bv] = p;
      bestedge_[bv] = -1;
      j += jstep;
      while (childs(j) != entrychild) {
        bv = childs(j);
        if (label_[bv] == 1) {
          j += jstep;
          continue;
        }
        int reach = -1;
        blossom_leaves(bv, [&](int leaf) {
          if (reach < 0 && label_[leaf] != 0) reach = leaf;
        });
        if (reach >= 0) {
          label_[reach] = 0;
          label_[endpoint_[mate_[blossombase_[bv]]]] = 0;
          assign_label(reach, 2, labelend_[reach]);
        }
        j += jstep;
      }
    }
    label_[b] = -1;
    labelend_[b] = -1;
    blossomchilds_[b].clear();
    blossomendps_[b].clear();
    blossombase_[b] = -1;
    blossombestedges_[b].clear();
    bbe_valid_[b] = 0;
    bestedge_[b] = -1;
    unusedblossoms_.push_back(b);
  }

  void augment_blossom(int b, int v) {
    int t = v;
    while (blossomparent_[t] != b) t = blossomparent_[t];
    if (t >= n_) augment_blossom(t, v);
    int len = (int)blossomchilds_[b].size();
    int i = 0;
    while (blossomchilds_[b][i] != t) ++i;
    int j = i, jstep, endptrick;
    if (i & 1) {
      j -= len;
      jstep = 1;
      endptrick = 0;
    } else {
      jstep = -1;
      endptrick = 1;
    }
    auto childs = [&](int idx) {
      return blossomchilds_[b][(idx % len + len) % len];
    };
    auto endps = [&](int idx) {
      return blossomendps_[b][(idx % len + len) % len];
    };
    while (j != 0) {
      j += jstep;
      t = childs(j);
      int p = endps(j - endptrick) ^ endptrick;
      if (t >= n_) augment_blossom(t, endpoint_[p]);
      j += jstep;
      t = childs(j);
      if (t >= n_) augment_blossom(t, endpoint_[p ^ 1]);
      mate_[endpoint_[p]] = p ^ 1;
      mate_[endpoint_[p ^ 1]] = p;
    }
    std::rotate(blossomchilds_[b].begin(), blossomchilds_[b].begin() + i,
                blossomchilds_[b].end());
    std::rotate(blossomendps_[b].begin(), blossomendps_[b].begin() + i,
                blossomendps_[b].end());
    blossombase_[b] = blossombase_[blossomchilds_[b][0]];
  }

  void augment_matching(int k) {
    const int starts[2][2] = {{edges_[k].i, 2 * k + 1}, {edges_[k].j, 2 * k}};
    for (int side = 0; side < 2; ++side) {
      int s = starts[side][0];
      int p = starts[side][1];
      while (true) {
        int bs = inblossom_[s];
        if (bs >= n_) augment_blossom(bs, s);
        mate_[s] = p;
        if (labelend_[bs] == -1) break;
        int t = endpoint_[labelend_[bs]];
        int bt = inblossom_[t];
        s = endpoint_[labelend_[bt]];
        int j = endpoint_[labelend_[bt] ^ 1];
        if (bt >= n_) augment_blossom(bt, j);
        mate_[j] = labelend_[bt];
        p = labelend_[bt] ^ 1;
      }
    }
  }

  void run() {
    for (int stage = 0; stage < n_; ++stage) {
      std::fill(label_.begin(), label_.end(), 0);
      std::fill(bestedge_.begin(), bestedge_.end(), -1);
      for (int b = n_; b < 2 * n_; ++b) {
        blossombestedges_[b].clear();
        bbe_valid_[b] = 0;
      }
      std::fill(allowedge_.begin(), allowedge_.end(), 0);
      queue_.clear();
      for (int v = 0; v < n_; ++v)
        if (mate_[v] == -1 && label_[inblossom_[v]] == 0) assign_label(v, 1, -1);
      bool augmented = false;
      while (true) {
        while (!queue_.empty() && !augmented) {
          int v = queue_.back();
          queue_.pop_back();
          for (int p : neighbend_[v]) {
            int k = p / 2;
            int w = endpoint_[p];
            if (inblossom_[v] == inblossom_[w]) continue;
            int64_t kslack = 0;
            if (!allowedge_[k]) {
              kslack = slack(k);
              if (kslack <= 0) allowedge_[k] = 1;
            }
            if (allowedge_[k]) {
              if (label_[inblossom_[w]] == 0) {
                assign_label(w, 2, p ^ 1);
              } else if (label_[inblossom_[w]] == 1) {
                int base = scan_blossom(v, w);
                if (base >= 0) {
                  add_blossom(base, k);
                } else {
                  augment_matching(k);
                  augmented = true;
                  break;
                }
              } else if (label_[w] == 0) {
                label_[w] = 2;
                labelend_[w] = p ^ 1;
              }
            } else if (label_[inblossom_[w]] == 1) {
              int b = inblossom_[v];
              if (bestedge_[b] == -1 || kslack < slack(bestedge_[b]))
                bestedge_[b] = k;
            } else if (label_[w] == 0) {
              if (bestedge_[w] == -1 || kslack < slack(bestedge_[w]))
                bestedge_[w] = k;
            }
          }
        }
        if (augmented) break;

        int deltatype = -1;
        int64_t delta = 0;
        int deltaedge = -1, deltablossom = -1;
        if (!maxcard_) {
          deltatype = 1;
          delta = *std::min_element(dualvar_.begin(), dualvar_.begin() + n_);
        }
        for (int v = 0; v < n_; ++v) {
          if (label_[inblossom_[v]] == 0 && bestedge_[v] != -1) {
            int64_t d = slack(bestedge_[v]);
            if (deltatype == -1 || d < delta) {
              delta = d;
              deltatype = 2;
              deltaedge = bestedge_[v];
            }
          }
        }
        for (int b = 0; b < 2 * n_; ++b) {
          if (blossomparent_[b] == -1 && label_[b] == 1 && bestedge_[b] != -1) {
            int64_t d = slack(bestedge_[b]) / 2;
            if (deltatype == -1 || d < delta) {
              delta = d;
              deltatype = 3;
              deltaedge = bestedge_[b];
            }
          }
        }
        for (int b = n_; b < 2 * n_; ++b) {
          if (blossombase_[b] >= 0 && blossomparent_[b] == -1 &&
              label_[b] == 2 && (deltatype == -1 || dualvar_[b] < delta)) {
            delta = dualvar_[b];
            deltatype = 4;
            deltablossom = b;
          }
        }
        if (deltatype == -1) {
          deltatype = 1;
          delta = std::max<int64_t>(
              0, *std::min_element(dualvar_.begin(), dualvar_.begin() + n_));
        }

        for (int v = 0; v < n_; ++v) {
          int lb = label_[inblossom_[v]];
          if (lb == 1)
            dualvar_[v] -= delta;
          else if (lb == 2)
            dualvar_[v] += delta;
        }
        for (int b = n_; b < 2 * n_; ++b) {
          if (blossombase_[b] >= 0 && blossomparent_[b] == -1) {
            if (label_[b] == 1)
              dualvar_[b] += delta;
            else if (label_[b] == 2)
              dualvar_[b] -= delta;
          }
        }

        if (deltatype == 1) {
          break;
        } else if (deltatype == 2) {
          allowedge_[deltaedge] = 1;
          int i = edges_[deltaedge].i;
          int j = edges_[deltaedge].j;
          if (label_[inblossom_[i]] == 0) std::swap(i, j);
          queue_.push_back(i);
        } else if (deltatype == 3) {
          allowedge_[deltaedge] = 1;
          queue_.push_back(edges_[deltaedge].i);
        } else {
          expand_blossom(deltablossom, false);
        }
      }
      if (!augmented) break;
      for (int b = n_; b < 2 * n_; ++b) {
        if (blossomparent_[b] == -1 && blossombase_[b] >= 0 &&
            label_[b] == 1 && dualvar_[b] == 0)
          expand_blossom(b, true);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Decoder handle: graph + APSP tables.
// ---------------------------------------------------------------------------

constexpr int32_t kUnreach = INT32_MAX;
constexpr int kDpCutover = 13;  // keep in sync with MWPMDecoder.DP_CUTOVER
// Above this vertex count the O(V^2) APSP tables are skipped and shots
// run per-defect early-terminated Dijkstras instead (lazy mode).
constexpr int32_t kApspMaxNodes = 4096;

struct MwpmHandle {
  int32_t num_nodes;  // real detectors; boundary is node num_nodes
  int32_t num_edges;
  int32_t n_qubits;
  bool lazy = false;
  std::vector<int32_t> edge_qubit;
  std::vector<uint32_t> edge_obs;
  // adjacency (CSR over num_nodes + 1 vertices)
  std::vector<int32_t> adj_off, adj_vert, adj_edge;
  std::vector<int32_t> adj_w;
  std::vector<uint32_t> adj_par;
  // APSP, row-major [num_nodes + 1, num_nodes + 1] (empty in lazy mode)
  std::vector<int32_t> dist;
  std::vector<uint32_t> par;
  std::vector<int32_t> prev_edge;  // entering edge on shortest path
  std::vector<int32_t> prev_vert;

  size_t nv() const { return (size_t)num_nodes + 1; }
};

// Single-source shortest paths. With `targets` non-null (lazy mode), the
// search stops once `n_targets` marked vertices have been finalized —
// popped entries have exact distances and valid predecessor chains, which
// is all the matching needs.
void dijkstra_row(const MwpmHandle& h, int src, int32_t* dist, uint32_t* par,
                  int32_t* prev_edge, int32_t* prev_vert,
                  const uint8_t* targets = nullptr, int n_targets = 0) {
  size_t nv = h.nv();
  std::fill(dist, dist + nv, kUnreach);
  std::fill(par, par + nv, 0u);
  std::fill(prev_edge, prev_edge + nv, -1);
  std::fill(prev_vert, prev_vert + nv, -1);
  dist[src] = 0;
  int remaining = n_targets;
  if (targets && targets[src] && --remaining == 0) return;
  using QE = std::pair<int32_t, int32_t>;  // (dist, vertex)
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
  pq.push({0, src});
  std::vector<uint8_t> done;
  if (targets) done.assign(nv, 0);
  while (!pq.empty()) {
    auto [d, v] = pq.top();
    pq.pop();
    if (d > dist[v]) continue;
    if (targets && targets[v] && v != src && !done[v]) {
      done[v] = 1;
      if (--remaining == 0) return;
    }
    for (int32_t a = h.adj_off[v]; a < h.adj_off[v + 1]; ++a) {
      int32_t w = h.adj_vert[a];
      int32_t nd = d + h.adj_w[a];
      if (nd < dist[w]) {
        dist[w] = nd;
        par[w] = par[v] ^ h.adj_par[a];
        prev_edge[w] = h.adj_edge[a];
        prev_vert[w] = v;
        pq.push({nd, w});
      }
    }
  }
}

// Per-shot view over shortest-path rows: row i belongs to defect slot i
// and is nv-wide, regardless of whether it points into the resident APSP
// table or a lazy per-shot Dijkstra scratch.
struct ShotView {
  const MwpmHandle* h;
  const std::vector<int32_t>* defects;
  std::vector<const int32_t*> drow;
  std::vector<const uint32_t*> prow;
  std::vector<const int32_t*> perow;
  std::vector<const int32_t*> pvrow;

  int64_t D(int i, int j) const {
    int32_t d = drow[i][(*defects)[j]];
    return d == kUnreach ? -1 : d;
  }
  uint32_t P(int i, int j) const { return prow[i][(*defects)[j]]; }
  int64_t BD(int i) const {
    int32_t d = drow[i][h->num_nodes];
    return d == kUnreach ? -1 : d;
  }
  uint32_t BP(int i) const { return prow[i][h->num_nodes]; }
};

// Exact solve on one decomposed component. `comp` holds defect slots in
// ascending order. Returns the obs parity; appends matched pairs (i, j)
// as defect slots, with j == -1 for boundary.
uint32_t solve_component(const ShotView& sv, const std::vector<int32_t>& comp,
                         std::vector<std::pair<int32_t, int32_t>>& pairs) {
  int k = (int)comp.size();
  auto D = [&](int i, int j) -> int64_t { return sv.D(comp[i], comp[j]); };
  auto P = [&](int i, int j) -> uint32_t { return sv.P(comp[i], comp[j]); };
  auto BD = [&](int i) -> int64_t { return sv.BD(comp[i]); };
  auto BP = [&](int i) -> uint32_t { return sv.BP(comp[i]); };

  uint32_t parity = 0;
  if (k == 1) {  // decomposition leaves singletons only when boundary-matched
    int64_t bd = BD(0);
    if (bd < 0) return 0;
    parity ^= BP(0);
    pairs.push_back({comp[0], -1});
    return parity;
  }
  if (k <= kDpCutover) {
    // bitmask DP
    int full = (1 << k) - 1;
    std::vector<int64_t> cost((size_t)full + 1, -1);
    std::vector<int32_t> pick((size_t)full + 1, -1);
    cost[0] = 0;
    for (int mask = 1; mask <= full; ++mask) {
      int i = __builtin_ctz(mask);
      int rest = mask & ~(1 << i);
      int64_t best = -1;
      int bestpick = -1;
      int64_t bd = BD(i);
      if (bd >= 0 && cost[rest] >= 0) {
        best = bd + cost[rest];
        bestpick = k;  // boundary marker
      }
      for (int m = rest; m; m &= m - 1) {
        int j = __builtin_ctz(m);
        int64_t dij = D(i, j);
        int sub = rest & ~(1 << j);
        if (dij >= 0 && cost[sub] >= 0) {
          int64_t cand = dij + cost[sub];
          if (best < 0 || cand < best) {
            best = cand;
            bestpick = j;
          }
        }
      }
      cost[mask] = best;
      pick[mask] = bestpick;
    }
    if (cost[full] < 0) return 0;  // unmatchable; caller surfaces rc
    int mask = full;
    while (mask) {
      int i = __builtin_ctz(mask);
      int p = pick[mask];
      if (p == k) {
        parity ^= BP(i);
        pairs.push_back({comp[i], -1});
        mask &= ~(1 << i);
      } else {
        parity ^= P(i, p);
        pairs.push_back({comp[i], comp[p]});
        mask &= ~(1 << i);
        mask &= ~(1 << p);
      }
    }
    return parity;
  }

  // blossom on 2k nodes: defect i's virtual partner is k + i
  std::vector<BEdge> edges;
  edges.reserve((size_t)k * k + k);
  for (int i = 0; i < k; ++i) {
    for (int j = i + 1; j < k; ++j) {
      int64_t dij = D(i, j);
      if (dij >= 0) edges.push_back({i, j, -dij});
      edges.push_back({k + i, k + j, 0});
    }
    int64_t bd = BD(i);
    if (bd >= 0) edges.push_back({i, k + i, -bd});
  }
  std::vector<int32_t> mate;
  Blossom::max_weight_matching(2 * k, edges, /*maxcardinality=*/true, mate);
  for (int i = 0; i < k; ++i) {
    int m = mate[i];
    if (m == k + i) {
      parity ^= BP(i);
      pairs.push_back({comp[i], -1});
    } else if (m > i && m < k) {
      parity ^= P(i, m);
      pairs.push_back({comp[i], comp[m]});
    }
  }
  return parity;
}

// Decompose the defect graph and solve each component independently.
// Exactness: a pair edge with d(i, j) >= bd(i) + bd(j) can be replaced
// in any matching by the two boundary pairings at no greater cost, so
// some optimal matching avoids every dropped edge; the kept edges'
// connected components then share no usable pair edges and separate.
uint32_t solve_defects(const ShotView& sv,
                       std::vector<std::pair<int32_t, int32_t>>& pairs) {
  const std::vector<int32_t>& defects = *sv.defects;
  int k = (int)defects.size();
  std::vector<int64_t> bd(k);
  for (int i = 0; i < k; ++i) bd[i] = sv.BD(i);
  std::vector<int32_t> dsu(k);
  for (int i = 0; i < k; ++i) dsu[i] = i;
  std::vector<int32_t> stack;
  auto find = [&](int32_t x) {
    while (dsu[x] != x) {
      dsu[x] = dsu[dsu[x]];
      x = dsu[x];
    }
    return x;
  };
  for (int i = 0; i < k; ++i) {
    for (int j = i + 1; j < k; ++j) {
      int64_t dij = sv.D(i, j);
      if (dij < 0) continue;
      if (bd[i] >= 0 && bd[j] >= 0 && dij >= bd[i] + bd[j]) continue;
      int32_t a = find(i), b = find(j);
      if (a != b) dsu[a < b ? b : a] = a < b ? a : b;
    }
  }
  // components keyed by root (== smallest member), members ascending
  std::vector<std::vector<int32_t>> comps(k);
  for (int i = 0; i < k; ++i) comps[find(i)].push_back(i);
  uint32_t parity = 0;
  for (int r = 0; r < k; ++r)
    if (!comps[r].empty()) parity ^= solve_component(sv, comps[r], pairs);
  return parity;
}

void apply_path(const MwpmHandle& h, const ShotView& sv, int src_slot,
                int32_t dst_node, uint8_t* corr) {
  const int32_t* pe = sv.perow[src_slot];
  const int32_t* pv = sv.pvrow[src_slot];
  int32_t src_node = (*sv.defects)[src_slot];
  int32_t v = dst_node;
  while (v != src_node) {
    int32_t e = pe[v];
    int32_t q = h.edge_qubit[e];
    if (q >= 0) corr[q] ^= 1;
    v = pv[v];
  }
}

}  // namespace

extern "C" {

// Build a decoder handle. Returns nullptr on invalid input.
void* qcss_mwpm_create(const int32_t* edges, const int32_t* edge_qubit,
                       const uint32_t* edge_obs, const uint8_t* edge_weight,
                       int32_t num_nodes, int32_t num_edges, int32_t n_qubits,
                       int32_t n_threads) {
  if (num_nodes <= 0 || num_edges <= 0) return nullptr;
  auto* h = new MwpmHandle();
  h->num_nodes = num_nodes;
  h->num_edges = num_edges;
  h->n_qubits = n_qubits;
  h->edge_qubit.assign(edge_qubit, edge_qubit + num_edges);
  h->edge_obs.assign(edge_obs, edge_obs + num_edges);
  size_t nv = h->nv();
  auto vert = [&](int32_t x) { return x < 0 ? num_nodes : x; };
  h->adj_off.assign(nv + 1, 0);
  for (int32_t e = 0; e < num_edges; ++e) {
    h->adj_off[vert(edges[2 * e]) + 1]++;
    h->adj_off[vert(edges[2 * e + 1]) + 1]++;
  }
  for (size_t v = 0; v < nv; ++v) h->adj_off[v + 1] += h->adj_off[v];
  h->adj_vert.resize(2 * (size_t)num_edges);
  h->adj_edge.resize(2 * (size_t)num_edges);
  h->adj_w.resize(2 * (size_t)num_edges);
  h->adj_par.resize(2 * (size_t)num_edges);
  std::vector<int32_t> cur(h->adj_off.begin(), h->adj_off.end() - 1);
  for (int32_t e = 0; e < num_edges; ++e) {
    int32_t a = vert(edges[2 * e]), b = vert(edges[2 * e + 1]);
    for (auto [x, y] : {std::pair<int32_t, int32_t>{a, b}, {b, a}}) {
      int32_t slot = cur[x]++;
      h->adj_vert[slot] = y;
      h->adj_edge[slot] = e;
      h->adj_w[slot] = edge_weight[e];
      h->adj_par[slot] = edge_obs[e];
    }
  }
  h->lazy = num_nodes > kApspMaxNodes ||
            (std::getenv("QCSS_MWPM_FORCE_LAZY") != nullptr);
  if (h->lazy) return h;  // per-shot Dijkstras at decode time
  h->dist.resize(nv * nv);
  h->par.resize(nv * nv);
  h->prev_edge.resize(nv * nv);
  h->prev_vert.resize(nv * nv);
  int nt = std::max(1, (int)std::min<int64_t>(n_threads, (int64_t)nv));
  std::vector<std::thread> pool;
  std::atomic<int32_t> next{0};
  auto worker = [&]() {
    while (true) {
      int32_t src = next.fetch_add(1);
      if ((size_t)src >= nv) break;
      dijkstra_row(*h, src, &h->dist[(size_t)src * nv],
                   &h->par[(size_t)src * nv], &h->prev_edge[(size_t)src * nv],
                   &h->prev_vert[(size_t)src * nv]);
    }
  };
  for (int t = 1; t < nt; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return h;
}

void qcss_mwpm_destroy(void* handle) {
  delete static_cast<MwpmHandle*>(handle);
}

// Decode a batch. syndromes [batch, num_nodes] 0/1; obs [batch] out;
// corrections [batch, n_qubits] out or nullptr. Returns 0 on success.
int32_t qcss_mwpm_decode_batch(void* handle, const uint8_t* syndromes,
                               int64_t batch, uint8_t* corrections,
                               uint32_t* obs, int32_t n_threads) {
  if (!handle) return 1;
  const auto& h = *static_cast<MwpmHandle*>(handle);
  int nt = std::max(1, (int)std::min<int64_t>(n_threads, batch));
  std::atomic<int64_t> next{0};
  std::atomic<int32_t> rc{0};
  size_t nv = h.nv();
  auto worker = [&]() {
    std::vector<int32_t> defects;
    std::vector<std::pair<int32_t, int32_t>> pairs;
    // lazy-mode scratch, grown to the largest defect count seen
    std::vector<int32_t> l_dist, l_pe, l_pv;
    std::vector<uint32_t> l_par;
    std::vector<uint8_t> targets;
    while (true) {
      int64_t b = next.fetch_add(1);
      if (b >= batch) break;
      const uint8_t* syn = syndromes + (size_t)b * h.num_nodes;
      defects.clear();
      pairs.clear();
      for (int32_t v = 0; v < h.num_nodes; ++v)
        if (syn[v] & 1) defects.push_back(v);
      uint8_t* corr =
          corrections ? corrections + (size_t)b * h.n_qubits : nullptr;
      if (corr) std::memset(corr, 0, h.n_qubits);
      if (defects.empty()) {
        obs[b] = 0;
        continue;
      }
      size_t k = defects.size();
      ShotView sv;
      sv.h = &h;
      sv.defects = &defects;
      sv.drow.resize(k);
      sv.prow.resize(k);
      sv.perow.resize(k);
      sv.pvrow.resize(k);
      if (h.lazy) {
        if (l_dist.size() < k * nv) {
          l_dist.resize(k * nv);
          l_par.resize(k * nv);
          l_pe.resize(k * nv);
          l_pv.resize(k * nv);
        }
        targets.assign(nv, 0);
        for (int32_t d : defects) targets[d] = 1;
        targets[h.num_nodes] = 1;
        int n_targets = (int)k + 1;
        for (size_t i = 0; i < k; ++i) {
          dijkstra_row(h, defects[i], &l_dist[i * nv], &l_par[i * nv],
                       &l_pe[i * nv], &l_pv[i * nv], targets.data(),
                       n_targets);
          sv.drow[i] = &l_dist[i * nv];
          sv.prow[i] = &l_par[i * nv];
          sv.perow[i] = &l_pe[i * nv];
          sv.pvrow[i] = &l_pv[i * nv];
        }
      } else {
        for (size_t i = 0; i < k; ++i) {
          size_t off = (size_t)defects[i] * nv;
          sv.drow[i] = &h.dist[off];
          sv.prow[i] = &h.par[off];
          sv.perow[i] = &h.prev_edge[off];
          sv.pvrow[i] = &h.prev_vert[off];
        }
      }
      obs[b] = solve_defects(sv, pairs);
      size_t covered = 0;
      for (auto [i, j] : pairs) covered += (j < 0) ? 1 : 2;
      if (covered != defects.size()) rc.store(2);  // unmatchable syndrome
      if (corr) {
        for (auto [i, j] : pairs) {
          int32_t dst = j < 0 ? h.num_nodes : defects[j];
          apply_path(h, sv, i, dst, corr);
        }
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < nt; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return rc.load();
}

}  // extern "C"
