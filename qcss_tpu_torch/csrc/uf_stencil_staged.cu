// The staged forms of the stencil union-find decode: label propagation
// (K3), the activity spread (K4) and one whole growth round (K5), each as
// its own kernel with the per-round state crossing device memory between
// launches (CUDA C++, sm_90a). One thread block per shot.
//
// Replace: qcss_tpu/decode/device_uf_pallas.py make_prop_kernel,
//   make_act_kernel and make_round_kernel (their pallas_calls, driven by
//   decode_stencil_pallas and decode_stencil_pallas_fused). Plain
//   versions: qcss_tpu_torch/decode/device_uf.py _prop_plain, _act_plain,
//   _round_plain; each kernel returns its plain version's result bit for
//   bit. Callers: qcss_tpu_torch/decode/device_uf_staged.py.
//
// What bounds them on this card: device memory, unlike the whole decode
//   in one kernel (uf_stencil_full.cu). Each launch reads and writes
//   whole [B, V] planes — K3 V words and (O+KB)V mask bytes in, V words
//   out; K4 V words and O*V mask bytes in, V words out; K5 (2+O+KB)V
//   words in and (2+O+KB)V out — for a fixpoint of a few sweeps. The
//   sweeps themselves run in shared memory, so a launch costs one pass
//   over its planes plus the barriers of its sweeps.
//
// Design: the block-wide sweeps of uf_stencil_common.cuh
//   (propagate_labels, spread_activity, grow_step), one shot a block; the
//   whole decode in one kernel (uf_stencil_full.cu) runs a warp a shot
//   over lists of live vertices instead. Each kernel loads its shot into
//   shared memory (masks folded into one bit word per vertex), runs the
//   sweeps there and writes the planes back. The TPU kernels' batch
//   tiles, roll-and-mask shifts and int32
//   booleans have no counterpart: a block is one shot, a shift is an
//   index, and K3 and K4 read their masks as the bytes torch stores
//   bools in.

#include <cuda_runtime.h>

#include "uf_stencil_common.cuh"

namespace {

using namespace qcss;

// K3. packed [B, V] int32, satm [B, O, V] and satb [B, KB, V] bytes (0/1)
// -> out [B, V] int32.
__global__ void __launch_bounds__(kStencilThreads)
uf_stencil_prop_kernel(const int* __restrict__ packed_in,
                       const unsigned char* __restrict__ satm,
                       const unsigned char* __restrict__ satb,
                       const int* __restrict__ tab,
                       const int* __restrict__ deltas_in, int V, int O,
                       int KB, int L, int* __restrict__ out) {
  extern __shared__ int smem[];
  __shared__ int deltas[kMaxOffsets];
  __shared__ int scratch[33];
  int* cur = smem;
  int* nxt = cur + V;
  int* sat = nxt + V;

  const StencilTables t = split_tables(tab, V, O, KB);
  const long long shot = blockIdx.x;
  const long long row = shot * V;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  if (tid < O) deltas[tid] = deltas_in[tid];
  for (int v = tid; v < V; v += nt) {
    cur[v] = packed_in[row + v];
    int bits = 0;
    for (int o = 0; o < O; ++o)
      if (satm[(shot * O + o) * V + v]) bits |= 1 << o;
    for (int k = 0; k < KB; ++k)
      if (satb[(shot * KB + k) * V + v]) bits |= 1 << (O + k);
    sat[v] = bits;
  }
  __syncthreads();
  propagate_labels(cur, nxt, sat, t.eobs, t.bobs, deltas, V, O, KB, L,
                   scratch);
  for (int v = tid; v < V; v += nt) out[row + v] = cur[v];
}

// K4. act [B, V] int32 0/1, passes [B, O, V] bytes (0/1) -> out [B, V]
// int32.
__global__ void __launch_bounds__(kStencilThreads)
uf_stencil_act_kernel(const int* __restrict__ act_in,
                      const unsigned char* __restrict__ passes,
                      const int* __restrict__ deltas_in, int V, int O,
                      int* __restrict__ out) {
  extern __shared__ int smem[];
  __shared__ int deltas[kMaxOffsets];
  int* act = smem;
  int* pass = act + V;

  const long long shot = blockIdx.x;
  const long long row = shot * V;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  if (tid < O) deltas[tid] = deltas_in[tid];
  for (int v = tid; v < V; v += nt) {
    act[v] = act_in[row + v] != 0;
    int bits = 0;
    for (int o = 0; o < O; ++o)
      if (passes[(shot * O + o) * V + v]) bits |= 1 << o;
    pass[v] = bits;
  }
  __syncthreads();
  spread_activity(act, pass, deltas, V, O);
  for (int v = tid; v < V; v += nt) out[row + v] = act[v];
}

// K5. packed, seed [B, V] int32; sup [B, O+KB, V] int32 (O edge planes,
// then KB boundary planes) -> out_packed [B, V], out_sup [B, O+KB, V],
// out_grew [B, V] (1 where an edge or slot at v grew).
__global__ void __launch_bounds__(kStencilThreads)
uf_stencil_round_kernel(const int* __restrict__ packed_in,
                        const int* __restrict__ seed_in,
                        const int* __restrict__ sup_in,
                        const int* __restrict__ tab,
                        const int* __restrict__ deltas_in, int V, int O,
                        int KB, int L, int* __restrict__ out_packed,
                        int* __restrict__ out_sup,
                        int* __restrict__ out_grew) {
  extern __shared__ int smem[];
  __shared__ int deltas[kMaxOffsets];
  __shared__ int scratch[33];
  int* cur = smem;
  int* nxt = cur + V;
  int* act = nxt + V;
  int* sat = act + V;  // first the pass bits, then the saturation bits
  int* sup = sat + V;  // [O + KB, V]

  const StencilTables t = split_tables(tab, V, O, KB);
  const long long shot = blockIdx.x;
  const long long row = shot * V;
  const long long sup_row = shot * (O + KB) * V;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  if (tid < O) deltas[tid] = deltas_in[tid];
  for (int v = tid; v < V; v += nt) {
    cur[v] = packed_in[row + v];
    act[v] = seed_in[row + v] != 0;
  }
  for (int i = tid; i < (O + KB) * V; i += nt) sup[i] = sup_in[sup_row + i];
  __syncthreads();

  // 1. activity spread from the parity seeds, over the saturated edges
  //    inside one cluster
  for (int v = tid; v < V; v += nt) {
    const int comp = cur[v] >> L;
    int bits = 0;
    for (int o = 0; o < O; ++o) {
      const int idx = o * V + v;
      const int d = deltas[o];
      if (t.emask[idx] && sup[idx] >= t.ewt[idx] && v + d < V &&
          comp == (cur[v + d] >> L))
        bits |= 1 << o;
    }
    sat[v] = bits;
  }
  __syncthreads();
  spread_activity(act, sat, deltas, V, O);

  // 2. delta-stepped growth; rewrites sat as the saturation bits
  grow_step(cur, act, sup, sat, t, deltas, V, O, KB, L, out_grew + row,
            scratch);

  // 3. label propagation to the fixpoint over the saturated edges
  propagate_labels(cur, nxt, sat, t.eobs, t.bobs, deltas, V, O, KB, L,
                   scratch);

  for (int v = tid; v < V; v += nt) out_packed[row + v] = cur[v];
  for (int i = tid; i < (O + KB) * V; i += nt) out_sup[sup_row + i] = sup[i];
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Each entry point returns the CUDA error code of its launch (0 =
// success). tables [3*O + 3*KB, V] and deltas [O] are the ones of
// qcss_uf_stencil_full.

extern "C" int qcss_stencil_prop(const int* packed, const void* satm,
                                 const void* satb, const int* tables,
                                 const int* deltas, int B, int V, int O,
                                 int KB, int L, int* out, void* stream) {
  if (!qcss::stencil_shape_ok(V, O, KB)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)3 * V * sizeof(int);
  cudaError_t err = allow_smem(uf_stencil_prop_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    uf_stencil_prop_kernel<<<B, kStencilThreads, smem,
                             (cudaStream_t)stream>>>(
        packed, (const unsigned char*)satm, (const unsigned char*)satb,
        tables, deltas, V, O, KB, L, out);
  return (int)cudaGetLastError();
}

extern "C" int qcss_stencil_act(const int* act, const void* passes,
                                const int* deltas, int B, int V, int O,
                                int* out, void* stream) {
  if (!qcss::stencil_shape_ok(V, O, 1)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * V * sizeof(int);
  cudaError_t err = allow_smem(uf_stencil_act_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    uf_stencil_act_kernel<<<B, kStencilThreads, smem,
                            (cudaStream_t)stream>>>(
        act, (const unsigned char*)passes, deltas, V, O, out);
  return (int)cudaGetLastError();
}

extern "C" int qcss_stencil_round(const int* packed, const int* seed,
                                  const int* sup, const int* tables,
                                  const int* deltas, int B, int V, int O,
                                  int KB, int L, int* out_packed,
                                  int* out_sup, int* out_grew,
                                  void* stream) {
  if (!qcss::stencil_shape_ok(V, O, KB)) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(4 + O + KB) * V * sizeof(int);
  cudaError_t err = allow_smem(uf_stencil_round_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0)
    uf_stencil_round_kernel<<<B, kStencilThreads, smem,
                              (cudaStream_t)stream>>>(
        packed, seed, sup, tables, deltas, V, O, KB, L, out_packed, out_sup,
        out_grew);
  return (int)cudaGetLastError();
}
