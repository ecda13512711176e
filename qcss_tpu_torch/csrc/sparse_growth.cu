// Defect-granular union-find decode: one thread block per shot (CUDA C++,
// sm_90a).
//
// Replaces: qcss_tpu/decode/device_sparse.py make_growth_kernel (its
//   pallas_call, whose body is _growth_core), together with the distance
//   fetch of _sparse_decode that ran beside it in XLA. Plain version:
//   qcss_tpu_torch/decode/device_sparse.py _sparse_plain. Both return the
//   same obs and converged, bit for bit, overflow shots included.
//
// What it computes, per shot: the first D fired detectors, compacted to
//   slots in ascending detector order; their [D, D] distance geometry and
//   [D] boundary distance and potentials; delta-stepped ball growth with
//   min-label components (warm-started each event); the observable as the
//   XOR of the defects' potentials, plus for each odd boundary cluster the
//   boundary-side potential of its (bdist, slot)-minimal boundary-touching
//   member. The event cap is the reference's D(D+1)/2+4, counted per shot.
//
// What bounds it on this card: the distance rows. A shot with n defects
//   reads n^2 words of the [V, V] distance table (2 MB at d=11, resident
//   in L2) plus its detector row; everything after that is shared-memory
//   integer work of O(n^2) per event. The reference fetched the geometry
//   into a [B, D, D] tensor in HBM first (151 MB at B=16384, D=48) with a
//   one-hot matmul on the TPU's matrix unit; here each block gathers its
//   own rows, so that tensor never exists.
//
// Design: thread i owns defect slot i (D <= 64, two warps); only the n
//   filled slots take part, which is exact: an empty slot is infinitely
//   far, has no boundary and no potential, so it never saturates, never
//   joins a component and never contributes. Compaction is one warp of
//   ballots over the detector row. Component sweeps are Jacobi (read
//   root, write tmp, pointer-jump) like the reference's. Per-root member
//   counts and boundary touches are shared-memory atomics, in place of the
//   reference's [D, D] equality masks. D need not be a power of two (the
//   reference padded it for the TPU's XOR roll-tree).

#include <cuda_runtime.h>

#include "block_reduce.cuh"

namespace {

using qcss::block_min;

constexpr int kUnreach = 1 << 21;
constexpr int kMaxD = 64;
constexpr int kThreads = 64;

struct Shot {
  int* dm;     // [kMaxD * kMaxD], row stride kMaxD
  int* r;      // [kMaxD] radii
  int* root;   // [kMaxD] component labels
  int* tmp;    // [kMaxD]
  int* cntR;   // [kMaxD] members per root
  int* btR;    // [kMaxD] boundary touch per root
  int n;       // filled slots
  int D;       // d_max
};

// Min-label components of the saturation adjacency r_i + r_j >= dm_ij,
// warm-started from s.root; all threads call it.
__device__ void components(const Shot& s) {
  const int i = threadIdx.x;
  while (true) {
    if (i < s.n) {
      int via = s.D;
      const int ri = s.r[i];
      for (int j = 0; j < s.n; ++j)
        if (ri + s.r[j] >= s.dm[i * kMaxD + j]) via = min(via, s.root[j]);
      s.tmp[i] = min(s.root[i], via);
    }
    __syncthreads();
    int changed = 0;
    if (i < s.n) {
      const int nr = s.tmp[s.tmp[i]];  // pointer jump: root <- root[root]
      changed = nr != s.root[i];
      s.root[i] = nr;
    }
    if (!__syncthreads_or(changed)) break;
  }
}

// (member count, boundary touch) of this thread's cluster.
__device__ void cluster_stats(const Shot& s, int my_bdm, int* cnt, int* bt) {
  const int i = threadIdx.x;
  if (i < s.n) {
    s.cntR[i] = 0;
    s.btR[i] = 0;
  }
  __syncthreads();
  if (i < s.n) {
    atomicAdd(&s.cntR[s.root[i]], 1);
    if (s.r[i] >= my_bdm) atomicOr(&s.btR[s.root[i]], 1);
  }
  __syncthreads();
  *cnt = i < s.n ? s.cntR[s.root[i]] : 0;
  *bt = i < s.n ? s.btR[s.root[i]] : 0;
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
sparse_growth_kernel(const unsigned char* __restrict__ det, int V,
                     const int* __restrict__ dist,
                     const int* __restrict__ bdist,
                     const int* __restrict__ phi,
                     const int* __restrict__ bside, int D, int max_events,
                     int* __restrict__ out_obs, int* __restrict__ out_conv) {
  __shared__ int slot[kMaxD];
  __shared__ int dm[kMaxD * kMaxD];
  __shared__ int r[kMaxD], root[kMaxD], tmp[kMaxD], cntR[kMaxD],
      btR[kMaxD], ai[kMaxD], bsm[kMaxD];
  __shared__ int scratch[33];
  __shared__ int s_count, s_obs;

  const int i = threadIdx.x;
  const long long row = (long long)blockIdx.x * V;

  // -- compaction: warp 0 ballots over the detector row
  if (i < 32) {
    int base = 0;
    for (int v0 = 0; v0 < V; v0 += 32) {
      const int v = v0 + i;
      const int bit = v < V ? (det[row + v] & 1) : 0;
      const unsigned m = __ballot_sync(0xffffffffu, bit);
      const int pos = base + __popc(m & ((1u << i) - 1u));
      if (bit && pos < D) slot[pos] = v;
      base += __popc(m);
    }
    if (i == 0) {
      s_count = base;
      s_obs = 0;
    }
  }
  __syncthreads();
  const int count = s_count;
  const int n = count < D ? count : D;
  const bool mine = i < n;

  // -- geometry of this thread's slot
  int my_bdm = kUnreach, my_phi = 0;
  if (mine) {
    const int vi = slot[i];
    my_bdm = bdist[vi];
    my_phi = phi[vi];
    bsm[i] = bside[vi];
    r[i] = 0;
    root[i] = i;
    const int* drow = dist + (long long)vi * V;
    for (int j = 0; j < n; ++j)
      dm[i * kMaxD + j] = j == i ? kUnreach : drow[slot[j]];
  }
  __syncthreads();

  Shot s{dm, r, root, tmp, cntR, btR, n, D};
  int cnt, bt;
  bool cont = n > 0;
  for (int ev = 0; cont; ++ev) {
    components(s);
    cluster_stats(s, my_bdm, &cnt, &bt);
    const int my_ai = mine && (cnt & 1) && !bt;
    if (mine) ai[i] = my_ai;
    __syncthreads();
    // next events: pair saturation and boundary arrival
    int local = kUnreach;
    if (mine) {
      const int ri = r[i];
      for (int j = 0; j < n; ++j) {
        const int dij = dm[i * kMaxD + j];
        const int rate = my_ai + ai[j];
        const int need = dij - ri - r[j];
        if (need > 0 && rate > 0 && dij < kUnreach)
          local = min(local, rate == 2 ? (need + 1) >> 1 : need);
      }
      const int bneed = my_bdm - ri;
      if (my_ai && bneed > 0 && my_bdm < kUnreach) local = min(local, bneed);
    }
    const int delta = block_min(local, scratch);
    const int any_ai = __syncthreads_or(my_ai);
    const bool grow = any_ai && delta < kUnreach;
    if (grow && my_ai) r[i] += delta;
    cont = grow && ev + 1 < max_events;
    __syncthreads();
  }

  // -- final cluster structure + observable extraction
  components(s);
  cluster_stats(s, my_bdm, &cnt, &bt);
  // boundary-connecting member of each cluster: min (bdist, slot) among
  // members whose ball reached the boundary
  if (mine) tmp[i] = 0x7fffffff;
  __syncthreads();
  if (mine) {
    const int bkey = r[i] >= my_bdm ? my_bdm : kUnreach;
    atomicMin(&tmp[root[i]], bkey * D + i);
  }
  __syncthreads();
  int unfinished = 0;
  if (mine) {
    const bool odd = cnt & 1;
    int term = my_phi;
    if (root[i] == i && odd && bt) term ^= bsm[tmp[i] % D];
    atomicXor(&s_obs, term);
    unfinished = odd && !bt;
  }
  const int any_unfinished = __syncthreads_or(unfinished);
  if (i == 0) {
    out_obs[blockIdx.x] = s_obs;
    out_conv[blockIdx.x] = count <= D && !any_unfinished;
  }
}

}  // namespace

// det [B, V] uint8 (bit 0 = fired); dist [V, V], bdist/phi/bside [V]
// int32; D = d_max <= 64. Writes obs [B] int32 and converged [B] int32
// (0/1). Returns the CUDA error code of the launch (0 = success).
extern "C" int qcss_sparse_growth(const unsigned char* det, const int* dist,
                                  const int* bdist, const int* phi,
                                  const int* bside, int B, int V, int D,
                                  int max_events, int* out_obs,
                                  int* out_conv, void* stream) {
  if (D < 1 || D > kMaxD || V < 1) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    sparse_growth_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
        det, V, dist, bdist, phi, bside, D, max_events, out_obs, out_conv);
  }
  return (int)cudaGetLastError();
}
