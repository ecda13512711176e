// Stencil union-find decode: one thread block per shot (CUDA C++, sm_90a).
//
// Replaces: qcss_tpu/decode/device_uf_pallas.py make_full_kernel (its
//   pallas_call, driven by decode_stencil_pallas_full). Plain version:
//   qcss_tpu_torch/decode/device_uf.py _stencil_plain. Both return the
//   same packed labels, activity and chunk values, bit for bit.
//
// What it computes, per shot: delta-stepped growth over O stencil offsets
//   and KB boundary slots; label propagation to a fixpoint on packed
//   int32 words (comp << L | lanes), Jacobi sweeps so every sweep reads
//   the previous sweep's labels; cluster parity; activity. Rounds stop
//   when no cluster is active or nothing grew. Label lanes that did not
//   fit in the packed word (NC chunks of up to 30 bits) come out as one
//   forest-path word per vertex and chunk.
//
// What bounds it on this card: not HBM. A shot reads V detector words and
//   the (3 + NC)(O+KB) stencil tables (21 KB at d=11, shared by every shot
//   and so resident in L2), and writes (2 + NC)V words. The work is integer
//   control flow: per round a slack minimum, a propagation fixpoint of
//   (2O+KB) neighbour reads per vertex per sweep, and a parity pass — each
//   step ends at a block barrier. Barrier latency, shared-memory traffic
//   and the depth of the hardest label chain set the time.
//
// Design:
//   * one block per shot, all per-shot state in shared memory: labels
//     (double-buffered for the Jacobi sweeps), activity, defects, the
//     per-root parity counter, per-vertex saturation bits, the O+KB
//     support planes and 2*NC chunk planes — (6+O+KB+2*NC)*V ints, 40 KB
//     at V=721, O=7, KB=1, NC=0;
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
//     boundary slot, a block-wide min;
//   * spilled lanes: the TPU kernel records which candidate each adoption
//     took and, after the last round, XOR-spreads every chunk's edge bits
//     root-to-leaf down that forest. Here the chunk words travel WITH the
//     labels instead (uf_stencil_common.cuh, propagate_labels<true>): on
//     adoption a vertex copies its parent's words XOR the edge's chunk
//     bits. A vertex takes its final root only from a neighbour that
//     already holds it and never adopts again, so the copied words are
//     final and equal the forest-path XORs; the tie-break among equal
//     candidates is the TPU kernel's, which is what the forest depends on.
//     This needs no second fixpoint after the rounds and no `from_` plane,
//     at the price of 2*NC planes of shared memory instead of NC+1.

#include <cuda_runtime.h>

#include "uf_stencil_common.cuh"

namespace {

using namespace qcss;

template <bool kChunks>
__global__ void __launch_bounds__(kStencilThreads)
uf_stencil_full_kernel(const int* __restrict__ defect_in,
                       const int* __restrict__ tab,
                       const int* __restrict__ ctab,
                       const int* __restrict__ deltas_in,
                       int V, int O, int KB, int NC, int L, int max_rounds,
                       int* __restrict__ out_packed,
                       int* __restrict__ out_act,
                       int* __restrict__ out_chunks) {
  extern __shared__ int smem[];
  __shared__ int deltas[kMaxOffsets];
  __shared__ int scratch[33];

  int* cur = smem;                 // [V] labels
  int* nxt = cur + V;              // [V] labels, next sweep
  int* act = nxt + V;              // [V] 0/1
  int* defect = act + V;           // [V] 0/1
  int* cnt = defect + V;           // [V] per-root defect parity
  int* sat = cnt + V;              // [V] saturation bits
  int* sup = sat + V;              // [O, V] then supb [KB, V]
  int* ccur = sup + (O + KB) * V;  // [NC, V] chunk words
  int* cnxt = ccur + NC * V;       // [NC, V] chunk words, next sweep

  const StencilTables t = split_tables(tab, V, O, KB);
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
  if (kChunks)
    for (int i = tid; i < NC * V; i += nt) ccur[i] = 0;
  int active = __syncthreads_or(any_def);

  for (int round = 0; active && round < max_rounds; ++round) {
    // -- grow (delta-stepped), from last round's activity
    const int grew = grow_step(cur, act, sup, sat, t, deltas, V, O, KB, L,
                               nullptr, scratch);

    // -- propagate labels (and chunk words) to the fixpoint
    propagate_labels<kChunks>(cur, nxt, sat, t.eobs, t.bobs, deltas, V, O,
                              KB, L, NC, ccur, cnxt, ctab, scratch);

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
  if (kChunks) {
    const long long plane = (long long)gridDim.x * V;
    for (int c = 0; c < NC; ++c)
      for (int v = tid; v < V; v += nt)
        out_chunks[c * plane + row + v] = ccur[c * V + v];
  }
}

template <bool kChunks>
cudaError_t launch_full(const int* defect, const int* tables,
                        const int* chunk_tables, const int* deltas, int B,
                        int V, int O, int KB, int NC, int L, int max_rounds,
                        int* out_packed, int* out_act, int* out_chunks,
                        size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      uf_stencil_full_kernel<kChunks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (B > 0) {
    uf_stencil_full_kernel<kChunks><<<B, kStencilThreads, smem, stream>>>(
        defect, tables, chunk_tables, deltas, V, O, KB, NC, L, max_rounds,
        out_packed, out_act, out_chunks);
  }
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory, in bytes, of one block of the kernel.
extern "C" long long qcss_uf_stencil_full_smem(int V, int O, int KB, int NC) {
  return (long long)(6 + O + KB + 2 * NC) * V * (long long)sizeof(int);
}

// defect [B, V] int32 (column V-1, the boundary hub, is 0); tables
// [3*O + 3*KB, V] int32 = emask, ewt, eobs (O rows each), then bmask,
// bwt, bobs (KB rows each); chunk_tables [NC, O+KB, V] int32, per chunk
// the edge bits (O rows) and the boundary bits (KB rows), unread when
// NC = 0; deltas [O] int32. Writes packed and act [B, V] int32 and
// chunks [NC, B, V] int32. Returns the CUDA error code of the launch
// (0 = success).
extern "C" int qcss_uf_stencil_full(const int* defect, const int* tables,
                                    const int* chunk_tables,
                                    const int* deltas, int B, int V, int O,
                                    int KB, int NC, int L, int max_rounds,
                                    int* out_packed, int* out_act,
                                    int* out_chunks, void* stream) {
  if (!qcss::stencil_shape_ok(V, O, KB) || NC < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)qcss_uf_stencil_full_smem(V, O, KB, NC);
  const cudaError_t err =
      NC > 0 ? launch_full<true>(defect, tables, chunk_tables, deltas, B, V,
                                 O, KB, NC, L, max_rounds, out_packed,
                                 out_act, out_chunks, smem,
                                 (cudaStream_t)stream)
             : launch_full<false>(defect, tables, chunk_tables, deltas, B, V,
                                  O, KB, NC, L, max_rounds, out_packed,
                                  out_act, out_chunks, smem,
                                  (cudaStream_t)stream);
  return (int)err;
}
