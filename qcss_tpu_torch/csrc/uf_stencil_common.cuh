// Device code of the staged stencil union-find kernels
// (uf_stencil_staged.cu), and the limits every stencil kernel shares.
//
// Every function here is called by all threads of one block, which holds
// one shot: per-vertex state lives in shared memory, V vertices with the
// boundary hub at V-1, O stencil offsets (edge (o, v) joins v and
// v + deltas[o]) and KB boundary slots per vertex. Labels are packed int32
// words, comp << L | lanes. `sat[v]` is a bit word: bit o says edge (o, v)
// is saturated, bit O+k that boundary slot (k, v) is.
#pragma once

#include <cuda_runtime.h>

#include "block_reduce.cuh"

namespace qcss {

constexpr int kBig = 1 << 30;
constexpr int kMaxOffsets = 10;
constexpr int kMaxBoundary = 4;
constexpr int kStencilThreads = 256;

// The stencil tables as the wrappers pass them: [3*O + 3*KB, V] int32 =
// emask, ewt, eobs (O rows each), then bmask, bwt, bobs (KB rows each).
struct StencilTables {
  const int* emask;
  const int* ewt;
  const int* eobs;
  const int* bmask;
  const int* bwt;
  const int* bobs;
};

__device__ __forceinline__ StencilTables split_tables(const int* tab, int V,
                                                      int O, int KB) {
  StencilTables t;
  t.emask = tab;
  t.ewt = tab + O * V;
  t.eobs = tab + 2 * O * V;
  t.bmask = tab + 3 * O * V;
  t.bwt = t.bmask + KB * V;
  t.bobs = t.bwt + KB * V;
  return t;
}

// Label propagation to the fixpoint over the saturated edges, by Jacobi
// sweeps: every sweep reads `cur` and writes `nxt`, then the two swap, so
// on return `cur` holds the result. A vertex adopts the smallest candidate
// among its saturated neighbours and the hub, and only if that lowers its
// comp; the hub adopts the block-wide minimum over the saturated boundary
// slots under the same rule.
__device__ __forceinline__ void propagate_labels(
    int*& cur, int*& nxt, const int* sat, const int* eobs, const int* bobs,
    const int* deltas, int V, int O, int KB, int L, int* scratch) {
  const int bn = V - 1;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  while (true) {
    const int hub_val = cur[bn];
    int changed = 0;
    int hub_local = kBig;
    for (int v = tid; v < V; v += nt) {
      const int pv = cur[v];
      const int sb = sat[v];
      int cand = kBig;
      for (int o = 0; o < O; ++o) {
        const int d = deltas[o];
        if (((sb >> o) & 1) && v + d < V)  // parent = v + d
          cand = min(cand, cur[v + d] ^ eobs[o * V + v]);
        if (v >= d && ((sat[v - d] >> o) & 1))  // parent = v - d
          cand = min(cand, cur[v - d] ^ eobs[o * V + v - d]);
      }
      for (int k = 0; k < KB; ++k) {
        if ((sb >> (O + k)) & 1) {
          const int lab = bobs[k * V + v];
          cand = min(cand, hub_val ^ lab);  // v adopts from the hub
          hub_local = min(hub_local, pv ^ lab);  // the hub adopts from v
        }
      }
      const bool adopt = (cand >> L) < (pv >> L);
      nxt[v] = adopt ? cand : pv;
      changed |= adopt;
    }
    const int hub = block_min(hub_local, scratch);
    const bool adopt_b = (hub >> L) < (hub_val >> L);  // same in every thread
    if (adopt_b) {
      if (tid == 0) nxt[bn] = hub;
      changed = 1;
    }
    const int any = __syncthreads_or(changed);
    int* t = cur;
    cur = nxt;
    nxt = t;
    if (!any) break;
  }
}

// Activity OR-fixpoint: act[v] (0/1) spreads over the edges whose bit is
// set in `pass` (bit o of pass[v]: edge (o, v) passes), in both directions,
// until a sweep changes nothing. The closure is monotone, so the sweeps
// update in place: whatever order the threads run in, they reach the same
// least fixpoint as Jacobi sweeps.
__device__ __forceinline__ void spread_activity(int* act, const int* pass,
                                                const int* deltas, int V,
                                                int O) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  while (true) {
    int changed = 0;
    for (int v = tid; v < V; v += nt) {
      if (act[v]) continue;
      const int pb = pass[v];
      int a = 0;
      for (int o = 0; o < O; ++o) {
        const int d = deltas[o];
        if (((pb >> o) & 1) && v + d < V) a |= act[v + d];
        if (v >= d && ((pass[v - d] >> o) & 1)) a |= act[v - d];
      }
      if (a) {
        act[v] = 1;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
}

// One delta-stepped growth step from the activity `act` and the labels
// `cur`: every growable edge of an active cluster advances by the shot's
// minimum slack (ceil((wt - sup) / inc) over the growing edges, at least
// 1), so that some edge saturates. Updates sup [O, V] (then supb [KB, V]
// behind it) and rewrites the saturation bits `sat`. Where `grew_out` is
// not null, grew_out[v] becomes 1 if an edge or slot at v grew, else 0.
// Returns whether anything grew in the block.
__device__ __forceinline__ int grow_step(const int* cur, const int* act,
                                         int* sup, int* sat,
                                         const StencilTables& t,
                                         const int* deltas, int V, int O,
                                         int KB, int L, int* grew_out,
                                         int* scratch) {
  const int bn = V - 1;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  int* supb = sup + O * V;
  const int hub_comp = cur[bn] >> L;
  int local = kBig;
  for (int v = tid; v < V; v += nt) {
    const int comp = cur[v] >> L;
    const int av = act[v];
    for (int o = 0; o < O; ++o) {
      const int idx = o * V + v;
      const int d = deltas[o];
      const int w = t.ewt[idx];
      if (t.emask[idx] && sup[idx] < w) {
        const int nb = v + d < V ? (cur[v + d] >> L) : -1;
        if (comp != nb) {
          const int inc = av + (v + d < V ? act[v + d] : 0);
          if (inc > 0) local = min(local, (w - sup[idx] + inc - 1) / inc);
        }
      }
    }
    for (int k = 0; k < KB; ++k) {
      const int idx = k * V + v;
      const int w = t.bwt[idx];
      if (t.bmask[idx] && supb[idx] < w && comp != hub_comp && av > 0)
        local = min(local, w - supb[idx]);
    }
  }
  const int slack = block_min(local, scratch);
  int delta = slack > 1 ? slack : 1;
  if (delta >= kBig) delta = 1;
  int grew_local = 0;
  for (int v = tid; v < V; v += nt) {
    const int comp = cur[v] >> L;
    const int av = act[v];
    int bits = 0;
    int grew_v = 0;
    for (int o = 0; o < O; ++o) {
      const int idx = o * V + v;
      const int d = deltas[o];
      const int w = t.ewt[idx];
      if (t.emask[idx] && sup[idx] < w) {
        const int nb = v + d < V ? (cur[v + d] >> L) : -1;
        if (comp != nb) {
          const int inc = av + (v + d < V ? act[v + d] : 0);
          sup[idx] += inc * delta;
          grew_v |= inc > 0;
        }
      }
      if (t.emask[idx] && sup[idx] >= w) bits |= 1 << o;
    }
    for (int k = 0; k < KB; ++k) {
      const int idx = k * V + v;
      const int w = t.bwt[idx];
      if (t.bmask[idx] && supb[idx] < w && comp != hub_comp) {
        supb[idx] += av * delta;
        grew_v |= av > 0;
      }
      if (t.bmask[idx] && supb[idx] >= w) bits |= 1 << (O + k);
    }
    sat[v] = bits;
    if (grew_out) grew_out[v] = grew_v;
    grew_local |= grew_v;
  }
  return __syncthreads_or(grew_local);
}

// Checks shared by the launchers: the limits above, and the bit word.
inline bool stencil_shape_ok(int V, int O, int KB) {
  return O >= 1 && O <= kMaxOffsets && KB >= 1 && KB <= kMaxBoundary &&
         V >= 1 && O + KB <= 30;
}

}  // namespace qcss
