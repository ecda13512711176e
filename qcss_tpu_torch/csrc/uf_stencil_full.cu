// Stencil union-find decode: one thread block per shot (CUDA C++, sm_90a).
//
// Replaces: qcss_tpu/decode/device_uf_pallas.py make_full_kernel (its
//   pallas_call, driven by decode_stencil_pallas_full). Plain version:
//   qcss_tpu_torch/decode/device_uf.py _stencil_plain. Both return the
//   same packed labels and activity, bit for bit.
//
// What it computes, per shot: delta-stepped growth over O stencil offsets
//   and KB boundary slots; label propagation to a fixpoint on packed
//   int32 words (comp << L | lanes), Jacobi sweeps so every sweep reads
//   the previous sweep's labels; cluster parity; activity. Rounds stop
//   when no cluster is active or nothing grew.
//
// What bounds it on this card: not HBM. A shot reads V detector words and
//   the 3(O+KB) stencil tables (21 KB at d=11, shared by every shot and so
//   resident in L2), and writes 2V words. The work is integer control
//   flow: per round a slack minimum, a propagation fixpoint of (2O+KB)
//   neighbour reads per vertex per sweep, and a parity pass — each step
//   ends at a block barrier. Barrier latency, shared-memory traffic and
//   the depth of the hardest label chain set the time.
//
// Design:
//   * one block per shot, all per-shot state in shared memory: labels
//     (double-buffered for the Jacobi sweeps), activity, defects, the
//     per-root parity counter, per-vertex saturation bits and the O+KB
//     support planes — (6+O+KB)*V ints, 40 KB at V=721, O=7, KB=1;
//   * each block leaves its round loop when its own shot stops, so easy
//     shots do not wait for the batch's hardest one (this is what
//     sort_shots and pick_tile approximated on the TPU; neither is needed);
//   * cluster parity is a shared-memory atomicXor into a per-root counter.
//     The TPU kernel raked parities up a parent forest only because Mosaic
//     has no scatter. Activity is then read off directly: a vertex is
//     active iff its root's parity is odd and its root is not the hub's.
//     That is the set the reference's root-to-leaf spread reaches, since a
//     cluster without the hub is connected by saturated internal edges;
//   * the hub (vertex V-1) adopts the minimum over every saturated
//     boundary slot, a block-wide min.
//
// Spilled label lanes (ChunkLanes) are not handled here; the wrapper
// refuses graphs that have them.

#include <cuda_runtime.h>

#include "block_reduce.cuh"

namespace {

using qcss::block_min;

constexpr int kBig = 1 << 30;
constexpr int kMaxOffsets = 10;
constexpr int kMaxBoundary = 4;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
uf_stencil_full_kernel(const int* __restrict__ defect_in,
                       const int* __restrict__ tab,
                       const int* __restrict__ deltas_in,
                       int V, int O, int KB, int L, int max_rounds,
                       int* __restrict__ out_packed,
                       int* __restrict__ out_act) {
  extern __shared__ int smem[];
  __shared__ int deltas[kMaxOffsets];
  __shared__ int scratch[33];

  int* cur = smem;                 // [V] labels
  int* nxt = cur + V;              // [V] labels, next sweep
  int* act = nxt + V;              // [V] 0/1
  int* defect = act + V;           // [V] 0/1
  int* cnt = defect + V;           // [V] per-root defect parity
  int* sat = cnt + V;              // [V] bit o: edge (o,v); bit O+k: slot (k,v)
  int* sup = sat + V;              // [O, V] then supb [KB, V]
  int* supb = sup + O * V;

  const int* emask = tab;
  const int* ewt = tab + O * V;
  const int* eobs = tab + 2 * O * V;
  const int* bmask = tab + 3 * O * V;
  const int* bwt = bmask + KB * V;
  const int* bobs = bwt + KB * V;

  const int bn = V - 1;
  const long long row = (long long)blockIdx.x * V;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  if (tid < O) deltas[tid] = deltas_in[tid];
  int any_def = 0;
  for (int v = tid; v < V; v += nt) {
    const int dv = defect_in[row + v] & 1;
    defect[v] = dv;
    act[v] = dv;
    cur[v] = v << L;
    any_def |= dv;
  }
  for (int i = tid; i < (O + KB) * V; i += nt) sup[i] = 0;
  int active = __syncthreads_or(any_def);

  for (int round = 0; active && round < max_rounds; ++round) {
    // -- grow (delta-stepped), from last round's activity
    const int hub_comp = cur[bn] >> L;
    int local = kBig;
    for (int v = tid; v < V; v += nt) {
      const int comp = cur[v] >> L;
      const int av = act[v];
      for (int o = 0; o < O; ++o) {
        const int idx = o * V + v;
        const int d = deltas[o];
        const int w = ewt[idx];
        if (emask[idx] && sup[idx] < w) {
          const int nb = v + d < V ? (cur[v + d] >> L) : -1;
          if (comp != nb) {
            const int inc = av + (v + d < V ? act[v + d] : 0);
            if (inc > 0) local = min(local, (w - sup[idx] + inc - 1) / inc);
          }
        }
      }
      for (int k = 0; k < KB; ++k) {
        const int idx = k * V + v;
        const int w = bwt[idx];
        if (bmask[idx] && supb[idx] < w && comp != hub_comp && av > 0)
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
      for (int o = 0; o < O; ++o) {
        const int idx = o * V + v;
        const int d = deltas[o];
        const int w = ewt[idx];
        if (emask[idx] && sup[idx] < w) {
          const int nb = v + d < V ? (cur[v + d] >> L) : -1;
          if (comp != nb) {
            const int inc = av + (v + d < V ? act[v + d] : 0);
            sup[idx] += inc * delta;
            grew_local |= inc > 0;
          }
        }
        if (emask[idx] && sup[idx] >= w) bits |= 1 << o;
      }
      for (int k = 0; k < KB; ++k) {
        const int idx = k * V + v;
        const int w = bwt[idx];
        if (bmask[idx] && supb[idx] < w && comp != hub_comp) {
          supb[idx] += av * delta;
          grew_local |= av > 0;
        }
        if (bmask[idx] && supb[idx] >= w) bits |= 1 << (O + k);
      }
      sat[v] = bits;
    }
    const int grew = __syncthreads_or(grew_local);

    // -- propagate labels to the fixpoint (Jacobi: read cur, write nxt)
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
          if (((sb >> o) & 1) && v + d < V)       // parent = v + d
            cand = min(cand, cur[v + d] ^ eobs[o * V + v]);
          if (v >= d && ((sat[v - d] >> o) & 1))  // parent = v - d
            cand = min(cand, cur[v - d] ^ eobs[o * V + v - d]);
        }
        for (int k = 0; k < KB; ++k) {
          if ((sb >> (O + k)) & 1) {
            const int lab = bobs[k * V + v];
            cand = min(cand, hub_val ^ lab);        // v adopts from the hub
            hub_local = min(hub_local, pv ^ lab);   // the hub adopts from v
          }
        }
        const bool adopt = (cand >> L) < (pv >> L);
        nxt[v] = adopt ? cand : pv;
        changed |= adopt;
      }
      const int hub = block_min(hub_local, scratch);
      if (tid == 0 && (hub >> L) < (nxt[bn] >> L)) {
        nxt[bn] = hub;
        changed = 1;
      }
      const int any = __syncthreads_or(changed);
      int* t = cur;
      cur = nxt;
      nxt = t;
      if (!any) break;
    }

    // -- cluster parity per root, then activity
    for (int v = tid; v < V; v += nt) cnt[v] = 0;
    __syncthreads();
    for (int v = tid; v < V; v += nt)
      if (defect[v]) atomicXor(&cnt[cur[v] >> L], 1);
    __syncthreads();
    const int broot = cur[bn] >> L;
    int any_act = 0;
    for (int v = tid; v < V; v += nt) {
      const int c = cur[v] >> L;
      const int a = (cnt[c] & 1) && c != broot;
      act[v] = a;
      any_act |= a;
    }
    active = __syncthreads_or(any_act) && grew;
  }

  for (int v = tid; v < V; v += nt) {
    out_packed[row + v] = cur[v];
    out_act[row + v] = act[v];
  }
}

}  // namespace

// defect [B, V] int32 (column V-1, the boundary hub, is 0); tables
// [3*O + 3*KB, V] int32 = emask, ewt, eobs (O rows each), then bmask,
// bwt, bobs (KB rows each); deltas [O] int32. Writes packed and act
// [B, V] int32. Returns the CUDA error code of the launch (0 = success).
extern "C" int qcss_uf_stencil_full(const int* defect, const int* tables,
                                    const int* deltas, int B, int V, int O,
                                    int KB, int L, int max_rounds,
                                    int* out_packed, int* out_act,
                                    void* stream) {
  if (O < 1 || O > kMaxOffsets || KB < 1 || KB > kMaxBoundary || V < 1 ||
      O + KB > 30)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(6 + O + KB) * V * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      uf_stencil_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    uf_stencil_full_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        defect, tables, deltas, V, O, KB, L, max_rounds, out_packed,
        out_act);
  }
  return (int)cudaGetLastError();
}
