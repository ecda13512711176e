// Defect-granular union-find decode (K2): a warp a shot, CUDA C++ for
// sm_90a.
//
// Replaces: qcss_tpu/decode/device_sparse.py make_growth_kernel (its
//   pallas_call, whose body is _growth_core), together with the defect
//   compaction and distance fetch of _sparse_decode that ran beside it in
//   XLA. Plain version: qcss_tpu_torch/decode/device_sparse.py
//   _sparse_plain. Both return the same obs and converged, bit for bit,
//   overflow shots included.
//
// What it computes, per shot: the first D fired detectors, compacted to
//   slots in ascending detector order; their [D, D] distance geometry and
//   [D] boundary distance and potentials; delta-stepped ball growth with
//   min-label components (warm-started each event); the observable as the
//   XOR of the defects' potentials, plus for each odd boundary cluster the
//   boundary-side potential of its (bdist, slot)-minimal boundary-touching
//   member. The event cap max_events is counted per shot (the reference's
//   batch-wide loop stops a shot's growth at its first event that grows
//   nothing, where the state is a fixpoint, and at the same cap).
//
// What bounds it on this card: the latency of each shot's chain of
//   sweeps and events, and the gather of its distances. A shot with n
//   defects (at d=11, B=16384: 20 on average, up to 45) reads its
//   detector row and n^2 entries of the [V, V] distance table (2 MB at
//   d=11, resident in L2, each entry a 32-byte sector of L2 traffic), then
//   runs O(n^2) integer tests per event. Bytes from device memory bound
//   the batch at ~0.004 ms and the pair tests it needs (n^2 an event
//   search, and one saturation mask build a shot) at ~0.013 ms on an
//   H100; a block a shot with one thread a slot (the form before this
//   one) spent ~27x that in 9+ block barriers an event, 64-way strided
//   shared-memory reads of the distances and a second warp that only met
//   barriers.
//
// Design: a warp a shot, kWarps shots a block, persistent warps that take
//   the next shot from a global counter (a shot's work goes as events x
//   n^2 and has a long tail, so a fixed shot-to-warp map would wait on its
//   slowest warp). Lane L owns slots L and L + 32 (D <= 64) and keeps their
//   radius, label, boundary distance, potential and boundary side in
//   registers; only the n filled slots take part, which is exact: an empty
//   slot is infinitely far, has no boundary and no potential, so it never
//   saturates, never joins a component and never contributes.
//   * Compaction by the whole warp: the detector row (any address, any
//     row stride) is read as a ragged head of bytes, 16-byte loads of 16
//     detectors a lane, and a ragged tail; fired bits are ranked by a
//     shuffle scan of their popcounts and the first D go to a per-warp
//     slot list in shared memory.
//   * Distances: the shot's [n, n] block of the table is gathered once into
//     shared memory TRANSPOSED, dm[j * D + i] = dist(v_i, v_j), so in every
//     sweep and event the 32 lanes (slots i) read 32 consecutive entries of
//     column j: no bank conflict (9.2 KB a shot at d_max = 48).
//   * Saturation masks instead of distance passes in the sweeps: each lane
//     keeps, per slot, the 64-bit mask of slots it is saturated with
//     (r_i + r_j >= dm_ij). One pass over the distances builds it; after
//     that a pair saturates at a growth exactly when its event step equals
//     the growth delta (no step is smaller), so the event search keeps the
//     mask of the pairs at its minimum and ORs it in when that minimum is
//     the delta. (Radii at 2^20 or more could saturate pairs at UNREACH;
//     the masks are then computed anew.) Component sweeps are Jacobi with
//     pointer jumping as in the reference, each label the minimum over the
//     slot's mask bits read by __shfl_sync: a sweep costs the largest
//     degree in the warp, not n. The fixpoint is the minimum slot of each
//     saturation component and it is unique, so the labels are the
//     reference's. A shot of n defects costs one pass of n^2 tests an
//     event (the event search) where the reference's form cost one a
//     sweep as well (~2 sweeps an event at d=11).
//   * Cluster statistics without shared-memory atomics: with n <= 32 a
//     cluster's member mask is __match_any_sync(root) (count = popcount,
//     boundary touch = the mask meets the ballot of boundary-saturated
//     slots); with two slots a lane the same masks come from six ballots
//     of each label register's bits.
//   * The event delta is __reduce_min_sync over the lanes' minima; the
//     (bdist, slot)-minimal boundary member of each odd boundary cluster
//     is a __reduce_min_sync of bkey * D + slot over its members, cluster
//     by cluster in ascending root order.
//   D need not be a power of two (the reference padded it for the TPU's
//   XOR roll-tree). No block barrier anywhere: warps share nothing.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "residency.cuh"

namespace {

constexpr int kUnreach = 1 << 21;
constexpr int kMaxD = 64;
constexpr int kWarps = 4;  // shots (warps) a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGather = 8;  // distance loads a lane keeps in flight

// Bytes of one warp's shared memory: the slot list, then dm [D * D] int32.
__host__ __device__ constexpr long long warp_bytes(int D) {
  return 4LL * kMaxD + ((long long)D * D * 4 + 15) / 16 * 16;
}

// Rank the set bits of `bits` (bit k: detector base + k) after `carry`
// earlier ones, in lane order, and list the first D in sv. Returns the
// warp's count of set bits.
__device__ __forceinline__ int emit(unsigned bits, int base, int carry,
                                   int D, int* sv, int lane) {
  const int c = __popc(bits);
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  int rank = carry + incl - c;
  while (bits) {
    const int b = __ffs(bits) - 1;
    bits &= bits - 1;
    if (rank < D) sv[rank] = base + b;
    ++rank;
  }
  return __shfl_sync(kFull, incl, 31);
}

// Bit 0 of each of the 4 bytes of w, byte k at bit k.
__device__ __forceinline__ unsigned byte_bits(unsigned w) {
  return ((w & 0x01010101u) * 0x10204080u) >> 28;
}

// The fired detectors of one row, the first D in sv; returns their count.
__device__ __forceinline__ int compact(
    const unsigned char* __restrict__ row, int V, int D, int* sv, int lane) {
  const int mis = (int)(reinterpret_cast<uintptr_t>(row) & 15);
  const int head = min(V, (16 - mis) & 15);
  const int body = (V - head) >> 4;
  const int tail0 = head + 16 * body;
  int count = emit(lane < head ? __ldg(row + lane) & 1u : 0u, lane, 0, D, sv,
                   lane);
  const uint4* chunks = reinterpret_cast<const uint4*>(row + head);
  for (int c0 = 0; c0 < body; c0 += 32) {
    const int c = c0 + lane;
    unsigned bits = 0u;
    if (c < body) {
      const uint4 v = __ldg(chunks + c);
      bits = byte_bits(v.x) | byte_bits(v.y) << 4 | byte_bits(v.z) << 8 |
             byte_bits(v.w) << 12;
    }
    count += emit(bits, head + 16 * c, count, D, sv, lane);
  }
  const int t = tail0 + lane;
  count += emit(t < V ? __ldg(row + t) & 1u : 0u, t, count, D, sv, lane);
  return count;
}

// A value of slot j (uniform j < 64) held in register a (j < 32) or b.
__device__ __forceinline__ int slot_val(int a, int b, int j) {
  return __shfl_sync(kFull, j < 32 ? a : b, j & 31);
}

// Lanes whose label register `root` (valid where v) equals a, from the
// ballots of the label's six bits.
__device__ __forceinline__ unsigned label_mask(const unsigned* bits,
                                               unsigned valid, int a) {
  unsigned m = valid;
#pragma unroll
  for (int k = 0; k < 6; ++k) m &= (a >> k) & 1 ? bits[k] : ~bits[k];
  return m;
}

// Radii at or past this could make r_i + r_j reach UNREACH; below it the
// saturation masks follow the growth events alone (see `grow`).
constexpr int kRadiusGuard = kUnreach / 2;

struct Slots {
  bool v0, v1;       // filled
  int r0, r1;        // radii
  int root0, root1;  // component labels
  int bdm0, bdm1;    // boundary distances
  // saturation masks: bit j of sat<k><h> is r_i + r_j >= dm_ij for slot
  // i = lane + 32 k and slot j = 32 h + bit
  unsigned sat00, sat01, sat10, sat11;
};

// Set bit j (uniform j < 64) of the two-word mask (lo, hi).
__device__ __forceinline__ void set_bit(unsigned& lo, unsigned& hi, int j,
                                        bool on) {
  const unsigned b = on ? 1u << (j & 31) : 0u;
  if (j < 32) {
    lo |= b;
  } else {
    hi |= b;
  }
}

// The saturation masks of the filled slots from the current radii.
__device__ __forceinline__ void saturation(Slots& s, const int* dm, int n,
                                           int D, int lane) {
  s.sat00 = s.sat01 = s.sat10 = s.sat11 = 0u;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const int rj = slot_val(s.r0, s.r1, j);
    set_bit(s.sat00, s.sat01, j,
            s.v0 && s.r0 + rj >= dm[j * D + lane]);
    if (n > 32)
      set_bit(s.sat10, s.sat11, j,
              s.v1 && s.r1 + rj >= dm[j * D + lane + 32]);
  }
}

// The label of the next saturated neighbour in the mask (lo, hi), removed
// from it, or INT_MAX when it is empty; every lane calls it.
__device__ __forceinline__ int next_label(unsigned& lo, unsigned& hi,
                                          const Slots& s) {
  int j = -1;
  if (lo) {
    j = __ffs(lo) - 1;
    lo &= lo - 1;
  } else if (hi) {
    j = 32 + __ffs(hi) - 1;
    hi &= hi - 1;
  }
  const int a = __shfl_sync(kFull, s.root0, j & 31);
  const int b = __shfl_sync(kFull, s.root1, j & 31);
  return j < 0 ? INT_MAX : j < 32 ? a : b;
}

// Min-label components of the saturation adjacency, warm-started from the
// current labels: Jacobi sweeps as the reference's, each taking the
// minimum label over a slot's saturated neighbours (its mask's set bits,
// read by shuffle), then a pointer jump.
__device__ __forceinline__ void components(Slots& s, int n) {
  while (true) {
    int via0 = INT_MAX, via1 = INT_MAX;
    unsigned m00 = s.sat00, m01 = s.sat01, m10 = s.sat10, m11 = s.sat11;
    while (__any_sync(kFull, m00 | m01 | m10 | m11)) {
      via0 = min(via0, next_label(m00, m01, s));
      if (n > 32) via1 = min(via1, next_label(m10, m11, s));
    }
    const int new0 = min(s.root0, via0);
    const int new1 = min(s.root1, via1);
    // pointer jump: root <- new[new]
    int nr0 = new0, nr1 = new1;
    {
      const int a = __shfl_sync(kFull, new0, new0 & 31);
      const int b = __shfl_sync(kFull, new1, new0 & 31);
      nr0 = new0 < 32 ? a : b;
    }
    if (n > 32) {
      const int a = __shfl_sync(kFull, new0, new1 & 31);
      const int b = __shfl_sync(kFull, new1, new1 & 31);
      nr1 = new1 < 32 ? a : b;
    }
    const bool changed = (s.v0 && nr0 != s.root0) || (s.v1 && nr1 != s.root1);
    if (s.v0) s.root0 = nr0;
    if (s.v1) s.root1 = nr1;
    if (!__any_sync(kFull, changed)) return;
  }
}

// (member count, boundary touch) of each slot's cluster.
__device__ __forceinline__ void cluster_stats(const Slots& s, int n, int lane,
                                              int& cnt0, int& cnt1, bool& bt0,
                                              bool& bt1) {
  const unsigned sat0 = __ballot_sync(kFull, s.v0 && s.r0 >= s.bdm0);
  if (n <= 32) {
    const unsigned m = __match_any_sync(kFull, s.v0 ? s.root0 : kMaxD + lane);
    cnt0 = __popc(m);
    bt0 = (m & sat0) != 0u;
    cnt1 = 0;
    bt1 = false;
    return;
  }
  const unsigned sat1 = __ballot_sync(kFull, s.v1 && s.r1 >= s.bdm1);
  const unsigned val0 = __ballot_sync(kFull, s.v0);
  const unsigned val1 = __ballot_sync(kFull, s.v1);
  unsigned b0[6], b1[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    b0[k] = __ballot_sync(kFull, (s.root0 >> k) & 1);
    b1[k] = __ballot_sync(kFull, (s.root1 >> k) & 1);
  }
  const unsigned m00 = label_mask(b0, val0, s.root0);
  const unsigned m01 = label_mask(b1, val1, s.root0);
  const unsigned m10 = label_mask(b0, val0, s.root1);
  const unsigned m11 = label_mask(b1, val1, s.root1);
  cnt0 = __popc(m00) + __popc(m01);
  bt0 = ((m00 & sat0) | (m01 & sat1)) != 0u;
  cnt1 = __popc(m10) + __popc(m11);
  bt1 = ((m10 & sat0) | (m11 & sat1)) != 0u;
}

__device__ __forceinline__ void decode_shot(
    const unsigned char* __restrict__ row, int V,
    const int* __restrict__ dist, const int* __restrict__ bdist,
    const int* __restrict__ phi, const int* __restrict__ bside, int D,
    int max_events, int* sv, int* dm, int lane, int& obs_out,
    int& conv_out) {
  const int count = compact(row, V, D, sv, lane);
  __syncwarp();
  const int n = min(count, D);
  if (n == 0) {
    obs_out = 0;
    conv_out = 1;
    return;
  }
  const int s0 = lane, s1 = lane + 32;
  Slots s;
  s.v0 = s0 < n;
  s.v1 = s1 < n;
  const int vi0 = s.v0 ? sv[s0] : 0;
  const int vi1 = s.v1 ? sv[s1] : 0;
  s.bdm0 = s.v0 ? __ldg(bdist + vi0) : kUnreach;
  s.bdm1 = s.v1 ? __ldg(bdist + vi1) : kUnreach;
  const int phi0 = s.v0 ? __ldg(phi + vi0) : 0;
  const int phi1 = s.v1 ? __ldg(phi + vi1) : 0;
  const int bs0 = s.v0 ? __ldg(bside + vi0) : 0;
  const int bs1 = s.v1 ? __ldg(bside + vi1) : 0;
  {
    // kGather loads of each lane in flight before their stores
    const int* row0 = dist + (long long)vi0 * V;
    const int* row1 = dist + (long long)vi1 * V;
    for (int j0 = 0; j0 < n; j0 += kGather) {
      int d0[kGather], d1[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int j = j0 + u;
        const int vj = j < n ? sv[j] : 0;
        d0[u] = j < n && s.v0 && j != s0 ? __ldg(row0 + vj) : kUnreach;
        d1[u] = j < n && s.v1 && j != s1 ? __ldg(row1 + vj) : kUnreach;
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int j = j0 + u;
        if (j < n && s.v0) dm[j * D + s0] = d0[u];
        if (j < n && s.v1) dm[j * D + s1] = d1[u];
      }
    }
  }
  __syncwarp();
  s.r0 = s.r1 = 0;
  s.root0 = s0;
  s.root1 = s1;
  saturation(s, dm, n, D, lane);
  int cnt0, cnt1;
  bool bt0, bt1;
  bool cont = true;
  for (int ev = 0; cont; ++ev) {
    components(s, n);
    cluster_stats(s, n, lane, cnt0, cnt1, bt0, bt1);
    const bool ai0 = s.v0 && (cnt0 & 1) && !bt0;
    const bool ai1 = s.v1 && (cnt1 & 1) && !bt1;
    // next events: pair saturation and boundary arrival; tie[k] keeps the
    // pairs of slot k whose step equals its minimum so far
    int loc0 = kUnreach, loc1 = kUnreach;
    unsigned tie00 = 0u, tie01 = 0u, tie10 = 0u, tie11 = 0u;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int rj = slot_val(s.r0, s.r1, j);
      const int aj = slot_val(ai0, ai1, j);
      if (s.v0) {
        const int d = dm[j * D + s0];
        const int rate = ai0 + aj;
        const int need = d - s.r0 - rj;
        if (need > 0 && rate > 0 && d < kUnreach) {
          const int st = rate == 2 ? (need + 1) >> 1 : need;
          if (st < loc0) {
            loc0 = st;
            tie00 = tie01 = 0u;
          }
          set_bit(tie00, tie01, j, st == loc0);
        }
      }
      if (n > 32 && s.v1) {
        const int d = dm[j * D + s1];
        const int rate = ai1 + aj;
        const int need = d - s.r1 - rj;
        if (need > 0 && rate > 0 && d < kUnreach) {
          const int st = rate == 2 ? (need + 1) >> 1 : need;
          if (st < loc1) {
            loc1 = st;
            tie10 = tie11 = 0u;
          }
          set_bit(tie10, tie11, j, st == loc1);
        }
      }
    }
    int local = min(loc0, loc1);
    if (ai0 && s.bdm0 - s.r0 > 0 && s.bdm0 < kUnreach)
      local = min(local, s.bdm0 - s.r0);
    if (ai1 && s.bdm1 - s.r1 > 0 && s.bdm1 < kUnreach)
      local = min(local, s.bdm1 - s.r1);
    const int delta = __reduce_min_sync(kFull, local);
    const bool grow = __any_sync(kFull, ai0 || ai1) && delta < kUnreach;
    if (grow) {
      if (ai0) s.r0 += delta;
      if (ai1) s.r1 += delta;
      // A pair saturates at this growth iff its step equals delta (every
      // step is at least delta), unless radii near UNREACH can saturate
      // unreachable pairs: then the masks are computed anew.
      if (__any_sync(kFull, (s.v0 && s.r0 >= kRadiusGuard) ||
                                (s.v1 && s.r1 >= kRadiusGuard))) {
        saturation(s, dm, n, D, lane);
      } else {
        if (loc0 == delta) {
          s.sat00 |= tie00;
          s.sat01 |= tie01;
        }
        if (loc1 == delta) {
          s.sat10 |= tie10;
          s.sat11 |= tie11;
        }
      }
    }
    cont = grow && ev + 1 < max_events;
  }

  // -- final cluster structure + observable extraction
  components(s, n);
  cluster_stats(s, n, lane, cnt0, cnt1, bt0, bt1);
  int obs = (int)__reduce_xor_sync(kFull, (unsigned)(phi0 ^ phi1));
  // odd clusters that touch the boundary, by their root slot
  unsigned todo0 =
      __ballot_sync(kFull, s.v0 && s.root0 == s0 && (cnt0 & 1) && bt0);
  unsigned todo1 =
      __ballot_sync(kFull, s.v1 && s.root1 == s1 && (cnt1 & 1) && bt1);
  const int key0 = (s.v0 && s.r0 >= s.bdm0 ? s.bdm0 : kUnreach) * D + s0;
  const int key1 = (s.v1 && s.r1 >= s.bdm1 ? s.bdm1 : kUnreach) * D + s1;
  while (todo0 | todo1) {
    int rt;
    if (todo0) {
      rt = __ffs(todo0) - 1;
      todo0 &= todo0 - 1;
    } else {
      rt = 32 + __ffs(todo1) - 1;
      todo1 &= todo1 - 1;
    }
    // its boundary-connecting member: min (bdist, slot) among members
    // whose ball reached the boundary
    const int mmin = __reduce_min_sync(
        kFull, min(s.v0 && s.root0 == rt ? key0 : INT_MAX,
                   s.v1 && s.root1 == rt ? key1 : INT_MAX));
    obs ^= slot_val(bs0, bs1, (mmin % D + D) % D);  // the floor mod
  }
  const bool unfinished = __any_sync(
      kFull, (s.v0 && (cnt0 & 1) && !bt0) || (s.v1 && (cnt1 & 1) && !bt1));
  obs_out = obs;
  conv_out = count <= D && !unfinished;
}

__global__ void __launch_bounds__(kWarps * 32) sparse_growth_kernel(
    const unsigned char* __restrict__ det, long long row_stride, int V,
    const int* __restrict__ dist, const int* __restrict__ bdist,
    const int* __restrict__ phi, const int* __restrict__ bside, int B, int D,
    int max_events, int* __restrict__ counter, int* __restrict__ out_obs,
    int* __restrict__ out_conv) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* sv = reinterpret_cast<int*>(smem + warp * warp_bytes(D));
  int* dm = sv + kMaxD;
  // shots from the counter: the one being decoded and, in flight, the next
  int shot = 0;
  if (lane == 0) shot = atomicAdd(counter, 1);
  shot = __shfl_sync(kFull, shot, 0);
  while (shot < B) {
    int next = 0;
    if (lane == 0) next = atomicAdd(counter, 1);
    int obs, conv;
    decode_shot(det + (long long)shot * row_stride, V, dist, bdist, phi,
                    bside, D, max_events, sv, dm, lane, obs, conv);
    if (lane == 0) {
      out_obs[shot] = obs;
      out_conv[shot] = conv;
    }
    __syncwarp();  // the next shot overwrites sv and dm
    shot = __shfl_sync(kFull, next, 0);
  }
}

struct Plan {
  int warps;  // shots a block at once
  int threads;
  long long smem;
};

Plan plan_k2(int D) { return {kWarps, 32 * kWarps, kWarps * warp_bytes(D)}; }

}  // namespace

// The launch plan of K2 at d_max = D: out[0] shots a block at once
// (warps), out[1] threads a block, out[2] dynamic shared memory a block,
// out[3] the blocks the card holds at once (the persistent grid's cap),
// out[4] registers a thread. Returns the CUDA error code (0 = success).
extern "C" int qcss_sparse_growth_config(int D, long long* res) {
  if (D < 1 || D > kMaxD) return (int)cudaErrorInvalidValue;
  const Plan p = plan_k2(D);
  const qcss::Instance k = qcss::instance<sparse_growth_kernel>();
  int blocks = 0, regs = 0;
  cudaError_t err = qcss::resident_blocks(k, p.threads, p.smem, &blocks);
  if (err == cudaSuccess) err = qcss::registers(k, &regs);
  if (err != cudaSuccess) return (int)err;
  const long long vals[] = {p.warps, p.threads, p.smem, blocks, regs};
  std::copy(vals, vals + 5, res);
  return 0;
}

// det: B rows of V bytes (bit 0 = fired), row r at det + r * row_stride
// (any alignment); dist [V, V], bdist/phi/bside [V] int32; D = d_max <= 64;
// counter: one int32 of scratch (zeroed here, on the stream). Writes obs
// [B] int32 and converged [B] int32 (0/1). Returns the CUDA error code of
// the launch (0 = success).
extern "C" int qcss_sparse_growth(const unsigned char* det,
                                  long long row_stride, const int* dist,
                                  const int* bdist, const int* phi,
                                  const int* bside, int B, int V, int D,
                                  int max_events, int* counter,
                                  int* out_obs, int* out_conv, void* stream) {
  if (D < 1 || D > kMaxD || V < 1 || B < 0 || row_stride < V)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_k2(D);
  const qcss::Instance k = qcss::instance<sparse_growth_kernel>();
  int blocks = 0;
  cudaError_t err = qcss::resident_blocks(k, p.threads, p.smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)std::min<long long>((B + kWarps - 1) / kWarps, blocks);
  void* args[] = {&det, &row_stride, &V, &dist, &bdist, &phi, &bside,
                  &B, &D, &max_events, &counter, &out_obs, &out_conv};
  err = cudaLaunchKernel(k.fn, dim3(grid), dim3(p.threads), args,
                         (size_t)p.smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
