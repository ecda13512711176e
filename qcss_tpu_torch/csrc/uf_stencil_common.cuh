// Device code shared by the stencil union-find kernels (uf_stencil_full.cu,
// uf_stencil_staged.cu): the limits, the edge-word forms, the launch plan
// of a persistent block that stages the graph's tables beside its shots,
// and the warp-wide pieces of a shot's state.
//
// A shot has V vertices with the boundary hub at V-1, O stencil offsets
// (edge (o, v) joins v and v + deltas[o]) and KB boundary slots per
// vertex. Labels are packed int32 words, comp << L | lanes. The kernels
// that run a warp a shot keep `sat[v]` as a bit word: bit 2o the edge to
// v + d_o, bit 2o+1 the edge to v - d_o, bit 2O+k boundary slot k, so a
// vertex's candidates are the set bits of one word.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace qcss {

constexpr int kBig = 1 << 30;
constexpr int kMaxOffsets = 10;
constexpr int kMaxBoundary = 4;
constexpr unsigned kFull = 0xffffffffu;
// shots (warps) a block of the whole-decode kernel
constexpr int kMaxShotsPerBlock = 16;
// dynamic shared memory a block may ask for, leaving room for the static
constexpr size_t kMaxDynamicSmem = 232448 - 256;
// The narrow edge word holds weights 0..kNarrowMaxWeight and label bits
// below bit L <= kNarrowMaxShift (StencilGraph.kernel_words uses the same
// limits).
constexpr int kNarrowMaxWeight = 255;
constexpr int kNarrowMaxShift = 23;

// One word per edge and boundary slot holding its presence, weight and
// label bits. Narrow: `(wt + 1) << L | obs`, 0 for no edge. Wide: int2
// {obs, wt or -1}.
template <bool kWide>
struct EdgeForm;

template <>
struct EdgeForm<false> {
  using Word = unsigned;
  using Sup = unsigned char;
  __device__ static Word make(bool present, int wt, int obs, int L) {
    return present ? ((unsigned)(wt + 1) << L) | (unsigned)obs : 0u;
  }
  // whether make() holds this edge exactly
  __device__ static bool fits(bool present, int wt, int obs, int L) {
    return L <= kNarrowMaxShift &&
           (!present || (wt >= 0 && wt <= kNarrowMaxWeight && obs >= 0 &&
                         obs < (1 << L)));
  }
  __device__ static bool present(Word w, int L) { return (w >> L) != 0u; }
  __device__ static int weight(Word w, int L) { return (int)(w >> L) - 1; }
  __device__ static int obs(Word w, int L) {
    return (int)(w & ((1u << L) - 1u));
  }
};

template <>
struct EdgeForm<true> {
  using Word = int2;
  using Sup = int;
  __device__ static bool present(Word w, int) { return w.y >= 0; }
  __device__ static int weight(Word w, int) { return w.y; }
  __device__ static int obs(Word w, int) { return w.x; }
};

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// How a persistent launch lays out a block's shared memory: the tables
// first (when allowed and they fit beside one shot; else the kernel reads
// them from device memory), then as many shots as fit, up to max_shots.
// shots_per_block is 0 when one shot does not fit.
struct Plan {
  int shots_per_block;
  size_t smem;
  bool tables_in_smem;
  size_t shot_bytes;
};

inline Plan plan_shots(size_t shot_bytes, size_t tab_bytes, bool tables_ok,
                       int max_shots) {
  Plan p{};
  p.shot_bytes = shot_bytes;
  if (shot_bytes > kMaxDynamicSmem) return p;
  p.tables_in_smem = tables_ok && tab_bytes + shot_bytes <= kMaxDynamicSmem;
  const size_t avail = kMaxDynamicSmem - (p.tables_in_smem ? tab_bytes : 0);
  p.shots_per_block =
      (int)std::min<size_t>((size_t)max_shots, avail / shot_bytes);
  p.smem = (p.tables_in_smem ? tab_bytes : 0) +
           (size_t)p.shots_per_block * shot_bytes;
  return p;
}

// Stages n table words in shared memory, one pass by the whole block:
// dst[i] = make(i). The caller syncs the block before reading them.
template <class Word, class Make>
__device__ __forceinline__ void stage_words(Word* dst, int n, Make make) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = make(i);
}

__device__ __forceinline__ void set_bit(unsigned* bits, int x) {
  atomicOr(&bits[x >> 5], 1u << (x & 31));
}

// Appends the set bits of bits[0, nw) to `list` in ascending order and
// clears them; returns how many. With `mbits`, the bits not yet in mbits
// are also appended to `mem` (the member list, length *nm) and set there.
// Called by the whole warp.
__device__ __forceinline__ int compact_bits(unsigned* bits, int nw,
                                            uint16_t* list, unsigned* mbits,
                                            uint16_t* mem, int* nm) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int w0 = 0; w0 < nw; w0 += 32) {
    const int w = w0 + lane;
    unsigned word = 0u;
    if (w < nw) {
      word = bits[w];
      if (word) bits[w] = 0u;
    }
    unsigned fresh = 0u;
    if (mbits && word) {
      fresh = word & ~mbits[w];
      if (fresh) mbits[w] |= fresh;
    }
    int c = __popc(word);
    int cf = __popc(fresh);
    int incl = c, inclf = cf;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      const int tf = __shfl_up_sync(kFull, inclf, off);
      if (lane >= off) {
        incl += t;
        inclf += tf;
      }
    }
    int pos = n + incl - c;
    for (unsigned m = word; m; m &= m - 1u)
      list[pos++] = (uint16_t)((w << 5) + __ffs(m) - 1);
    n += __shfl_sync(kFull, incl, 31);
    if (mbits) {
      int posf = *nm + inclf - cf;
      for (unsigned m = fresh; m; m &= m - 1u)
        mem[posf++] = (uint16_t)((w << 5) + __ffs(m) - 1);
      *nm += __shfl_sync(kFull, inclf, 31);
    }
  }
  __syncwarp();
  return n;
}

// Checks shared by the launchers: the limits above, and the bit word.
inline bool stencil_shape_ok(int V, int O, int KB) {
  return O >= 1 && O <= kMaxOffsets && KB >= 1 && KB <= kMaxBoundary &&
         V >= 1 && O + KB <= 30;
}

}  // namespace qcss
