// The staged forms of the stencil union-find decode: label propagation
// (K3), the activity spread (K4) and one whole growth round (K5), each its
// own kernel, with the per-round state crossing device memory between
// launches (CUDA C++, sm_90a).
//
// Replace: qcss_tpu/decode/device_uf_pallas.py make_prop_kernel,
//   make_act_kernel and make_round_kernel (their pallas_calls, driven by
//   decode_stencil_pallas and decode_stencil_pallas_fused). Plain
//   versions: qcss_tpu_torch/decode/device_uf.py _prop_plain, _act_plain,
//   _round_plain; each kernel returns its plain version's result bit for
//   bit. Callers: qcss_tpu_torch/decode/device_uf_staged.py.
//
// What bounds them on this card: each launch moves whole [B, V] planes —
//   K3 reads V label words and (O+KB)V mask bytes and writes V words; K5
//   reads and writes (2+O+KB)V words (seed and grew included); K4 reads V
//   words and O*V pass bytes and writes V words — while the work a shot
//   needs is small: at d=11 only 2-4% of the vertices have a saturated
//   edge. Each runs a warp a shot over lists of those vertices, so device
//   memory sets its time as long as enough shots stream at once to hide
//   each shot's chain of dependent steps.
//
// Design of K3 and K5 (K1's, uf_stencil_full.cu, applied to whole states):
//   * a warp a shot, as many shots a block as shared memory holds (up to
//     20 for K3, 16 for K5: their registers), persistent blocks, one
//     block an SM. Sweeps synchronise with __syncwarp,
//     reductions are __reduce_min_sync / __any_sync: no block barrier
//     after the tables are staged;
//   * the tables staged once a block (when they fit beside one shot): K3
//     the label bits of every edge and slot (a byte each when L <= 8),
//     K5 K1's narrow words
//     (presence, weight and label bits in one word) when every present
//     weight and label fits them, as the block finds while staging; else
//     each reads the int32 tables in device memory;
//   * K3's label row is asked of L2 one shot ahead (a bulk prefetch by
//     lane 0: the warp's first shot's at the launch, its next shot's once
//     the current shot's input is in), so that row's DRAM round trip
//     overlaps the shot before's propagation. Nothing more is: K3's masks
//     ahead, and any part of K5's input ahead (its rows, its supports,
//     with or without an evict-last hint), made both slower;
//   * the input planes are read as the 16-byte granules that cover them,
//     3 (K3) or 2 (K5, its label and seed rows together) a lane issued
//     before any is used: more in flight only queue in the L1 that shared
//     memory leaves. K5 streams the supports through to
//     out_sup and folds their saturation (emask and sup >= ewt) into the
//     sat words as they pass; K3 folds its mask bytes the same way;
//   * members: every vertex with a sat bit, and K5's seeds, as a 16-bit
//     list built by one warp prefix over a bit set. The contract does not
//     say the input labels are a fixpoint of the input saturation, so the
//     first sweep visits every member; later sweeps the frontier (the
//     neighbours over saturated edges of a vertex that changed, every slot
//     holder when the hub changed, the hub when a slot holder changed).
//     Jacobi sweeps: new labels go to `nxt` and are copied into `cur` only
//     after the whole frontier was read;
//   * K5: activity spreads from the seeds over the members, in place (the
//     closure is monotone); growth visits the active members, an edge with
//     both ends active grown from its low end, the shot's slack one warp
//     min; the grown edges' supports are rewritten in out_sup (the warp
//     wrote the plane; __syncwarp orders the writes), unclamped as the
//     plain version leaves them; `grew` is a bit set, written as a row.
//
// Design of K4 (the same scheme on its smaller state, no tables):
//   * a warp a shot, 16 shots a block, two blocks an SM (its registers:
//     kActBlocks in the launch bounds), persistent blocks; a shot's state
//     is V pass words, the act and mark bit sets and a 16-bit frontier
//     list (~6.3 bytes a vertex);
//   * the act row and then the pass bytes (one contiguous O*V run) read
//     as one sequence of the 16-byte granules that cover them, 3 a lane a
//     batch, each next batch's loads issued before the current one is
//     folded, and the next shot's first batch before this shot's spread:
//     the fold and the spread overlap round trips. Every nonzero act word
//     is a seed; all-zero pass granules cost a test, and each set byte
//     (o, v) of the others is folded into the pass words of v and v + d_o
//     (one division a granule). Folding a granule's bytes in one lane
//     while the next batch's loads wait made the shots with passes 10-30%
//     slower, and no other form tried was faster (deeper batches, three
//     blocks an SM at 40 registers, the next shot asked of L2, a TMA ring
//     of bulk copies into shared memory);
//   * the spread breadth first from the seeds: a frontier list a step
//     (compact_bits), a vertex activated once, by the lane whose atomicOr
//     set its bit. Each passing edge is looked at from its active end
//     only, so a shot costs its active vertices' edges, not V a sweep;
//   * the row out as 0/1 words (the plain version returns act != 0); then
//     the pass words cleared whole in 16-byte stores, which at d=11 costs
//     less than keeping a member bit set (two more shared atomics a set
//     byte, all of a granule's on one word), and the act bits.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "uf_stencil_common.cuh"

namespace {

using namespace qcss;

// 16-byte granules a lane has in flight at once, per kernel: more only
// queue in the L1 that shared memory leaves (K4 keeps two batches of
// kActLoad in registers: at 4 it is out of them)
constexpr int kPropLoad = 3;
constexpr int kRoundLoad = 2;
constexpr int kActLoad = 3;
// shots (warps) a block: K3's registers let 20 share an SM, K5's 16
constexpr int kPropShots = 20;
constexpr int kRoundShots = 16;
// K4: shots (warps) a block and blocks an SM its launch bounds ask for
constexpr int kActShots = 16;
constexpr int kActBlocks = 2;

// Where a shot's time goes: with QCSS_STAGED_PHASES defined (only
// `staged_bench --phases` builds it), lane 0 of every warp adds the clock
// cycles of each phase of its shots to phase_cycles: K3's phases 0-3, K4's
// 4-7, K5's 8-13 (qcss_stencil_phases reads and clears them).
#ifdef QCSS_STAGED_PHASES
__device__ unsigned long long phase_cycles[16];
#define PHASE_START long long phase_t0 = clock64()
#define PHASE(i)                                                  \
  do {                                                            \
    if ((threadIdx.x & 31) == 0) {                                \
      const long long t_ = clock64();                             \
      atomicAdd(&phase_cycles[i], (unsigned long long)(t_ - phase_t0)); \
      phase_t0 = t_;                                              \
    }                                                             \
  } while (0)
#else
#define PHASE_START
#define PHASE(i)
#endif

// Byte offsets of one shot's state in shared memory (K3; K5 adds act and
// the grew bits).
struct ShotLayout {
  size_t cur, nxt, sat, mem, fr, mbits, mark, grew, act, bytes;
};

__host__ __device__ inline ShotLayout shot_layout(int V, bool round) {
  const size_t v = (size_t)V;
  const size_t nw = (size_t)(V + 31) / 32;
  ShotLayout s;
  size_t o = 0;
  s.cur = o;   o = align16(o + 4 * v);                    // [V] labels
  s.nxt = o;   o = align16(o + 4 * v);                    // [V] next sweep
  s.sat = o;   o = align16(o + 4 * v);                    // [V] sat bits
  s.mem = o;   o = align16(o + 2 * v);                    // member list
  s.fr = o;    o = align16(o + 2 * v);                    // frontier list
  s.mbits = o; o = align16(o + 4 * nw);                   // member bits
  s.mark = o;  o = align16(o + 4 * nw);                   // frontier bits
  s.grew = o;  o = round ? align16(o + 4 * nw) : o;       // grew bits
  s.act = o;   o = round ? align16(o + v) : o;            // [V] 0/1
  s.bytes = o;
  return s;
}

// Byte offsets of one shot's state of K4 in shared memory.
struct ActLayout {
  size_t pass, act, mark, fr, bytes;
};

__host__ __device__ inline ActLayout act_layout(int V) {
  const size_t v = (size_t)V;
  const size_t nw = (size_t)(V + 31) / 32;
  ActLayout s;
  size_t o = 0;
  s.pass = o;  o = align16(o + 4 * v);                    // [V] pass bits
  s.act = o;   o = align16(o + 4 * nw);                   // act bits
  s.mark = o;  o = align16(o + 4 * nw);                   // frontier bits
  s.fr = o;    o = align16(o + 2 * v);                    // frontier list
  s.bytes = o;
  return s;
}

// An edge or boundary slot as growth reads it. The tables index edges as
// o * V + v ([O, V]) and slots as k * V + v ([KB, V]).
struct Edge {
  bool present;
  int wt;
};

// K3's tables: the label bits of the edges and of the slots, as int32 or,
// staged when L <= 8, as bytes.
template <class W>
struct ObsTables {
  const W* e;
  const W* b;
  __device__ int eobs(int i) const { return e[i]; }
  __device__ int bobs(int i) const { return b[i]; }
};

// K5's tables staged in shared memory as narrow words.
struct NarrowTables {
  using F = EdgeForm<false>;
  const unsigned* e;
  const unsigned* b;
  int L;
  __device__ Edge edge(int i) const {
    const unsigned w = e[i];
    return {F::present(w, L), F::weight(w, L)};
  }
  __device__ Edge slot(int i) const {
    const unsigned w = b[i];
    return {F::present(w, L), F::weight(w, L)};
  }
  __device__ int eobs(int i) const { return F::obs(e[i], L); }
  __device__ int bobs(int i) const { return F::obs(b[i], L); }
};

// K5's tables as the wrappers pass them, in device memory: [3*O + 3*KB,
// V] int32 = emask, ewt, eobs (O rows each), then bmask, bwt, bobs (KB
// rows each).
struct PlaneTables {
  const int *emask, *ewt, *eo, *bmask, *bwt, *bo;
  __device__ PlaneTables(const int* tab, int V, int O, int KB)
      : emask(tab), ewt(tab + O * V), eo(tab + 2 * O * V),
        bmask(tab + 3 * O * V), bwt(bmask + KB * V), bo(bwt + KB * V) {}
  __device__ Edge edge(int i) const {
    return {__ldg(emask + i) != 0, __ldg(ewt + i)};
  }
  __device__ Edge slot(int i) const {
    return {__ldg(bmask + i) != 0, __ldg(bwt + i)};
  }
  __device__ int eobs(int i) const { return __ldg(eo + i); }
  __device__ int bobs(int i) const { return __ldg(bo + i); }
};

// Entry i of the int32 tables (the O*V edges, then the slots), and
// whether it fits K5's narrow word. K5 stages narrow words only when every
// entry fits; its launch plan (qcss_stencil_staged_config) asks the same of
// the same tables, through narrow_check_kernel.
struct TableEntry {
  Edge e;
  int obs;
  __device__ bool narrow(int L) const {
    return EdgeForm<false>::fits(e.present, e.wt, obs, L);
  }
};

__device__ __forceinline__ TableEntry table_entry(const PlaneTables& pt,
                                                  int i, int OV) {
  return i < OV ? TableEntry{pt.edge(i), pt.eobs(i)}
                : TableEntry{pt.slot(i - OV), pt.bobs(i - OV)};
}

// Clears *fit unless every entry of the tables fits the narrow word.
__global__ void narrow_check_kernel(const int* __restrict__ tab, int V, int O,
                                    int KB, int L, int* fit) {
  const PlaneTables pt(tab, V, O, KB);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < (O + KB) * V;
       i += gridDim.x * blockDim.x)
    if (!table_entry(pt, i, O * V).narrow(L)) *fit = 0;
}

// One 16-byte granule of an input plane, read for streaming.
__device__ __forceinline__ int4 load16(const int4* p) { return __ldg(p); }

// Asks L2 for the 16-byte granules that cover [p, p + bytes), in bulk
// prefetches of up to 32 KB that nothing waits on (one lane issues them).
__device__ __forceinline__ void prefetch_l2(const void* p, long long bytes) {
  uintptr_t a = (uintptr_t)p & ~(uintptr_t)15;
  const uintptr_t e = ((uintptr_t)p + (uintptr_t)bytes + 15) & ~(uintptr_t)15;
  for (; a < e; a += 32768) {
    const unsigned n = (unsigned)min((uintptr_t)32768, e - a);
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(a),
                 "r"(n)
                 : "memory");
  }
}

// The whole warp visits src[0, n): f(j, src[j]) for every j, in no set
// order. It reads the 16-byte granules that cover the row, kLoad a lane
// issued before any is used, so a row of up to 128 * kLoad words is one
// round trip; the words of the first and last granule outside the row lie
// in the same 16 bytes as words of the row (so in memory that exists) and
// are ignored. With `dst`, every word is also stored to dst[j]: a whole
// granule at once where `vec` (dst lies as src does modulo 16) and the
// granule is whole, else a word at a time.
template <int kLoad, class F>
__device__ __forceinline__ void stream_words(const int* __restrict__ src,
                                             int* __restrict__ dst,
                                             long long n, bool vec, F f) {
  const int lane = threadIdx.x & 31;
  const int head = (int)(((uintptr_t)src & 15) >> 2);
  const int4* s4 = reinterpret_cast<const int4*>(src - head);
  const long long m = (head + n + 3) >> 2;
  for (long long g = 0; g < m; g += 32 * kLoad) {
    int4 x[kLoad];
#pragma unroll
    for (int k = 0; k < kLoad; ++k) {
      const long long i = g + 32 * k + lane;
      if (i < m) x[k] = load16(s4 + i);
    }
#pragma unroll
    for (int k = 0; k < kLoad; ++k) {
      const long long i = g + 32 * k + lane;
      if (i >= m) continue;
      const long long j = 4 * i - head;
      const int w[4] = {x[k].x, x[k].y, x[k].z, x[k].w};
      const bool whole = j >= 0 && j + 4 <= n;
      if (dst && vec && whole) *reinterpret_cast<int4*>(dst + j) = x[k];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!whole && (j + c < 0 || j + c >= n)) continue;
        if (dst && !(vec && whole)) dst[j + c] = w[c];
        f(j + c, w[c]);
      }
    }
  }
}

// stream_words over two rows of n words at once, both rows' granules in
// the same round trip: fa(j, a[j]) and fb(j, b[j]) for every j.
template <int kLoad, class FA, class FB>
__device__ __forceinline__ void stream_pair(const int* __restrict__ a,
                                            const int* __restrict__ b,
                                            long long n, FA fa, FB fb) {
  const int lane = threadIdx.x & 31;
  const int ha = (int)(((uintptr_t)a & 15) >> 2);
  const int hb = (int)(((uintptr_t)b & 15) >> 2);
  const int4* a4 = reinterpret_cast<const int4*>(a - ha);
  const int4* b4 = reinterpret_cast<const int4*>(b - hb);
  const long long ma = (ha + n + 3) >> 2;
  const long long mb = (hb + n + 3) >> 2;
  for (long long g = 0; g < max(ma, mb); g += 32 * kLoad) {
    int4 x[kLoad], y[kLoad];
#pragma unroll
    for (int k = 0; k < kLoad; ++k) {
      const long long i = g + 32 * k + lane;
      if (i < ma) x[k] = load16(a4 + i);
      if (i < mb) y[k] = load16(b4 + i);
    }
#pragma unroll
    for (int k = 0; k < kLoad; ++k) {
      const long long i = g + 32 * k + lane;
      const int wa[4] = {x[k].x, x[k].y, x[k].z, x[k].w};
      const int wb[4] = {y[k].x, y[k].y, y[k].z, y[k].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long ja = 4 * i - ha + c;
        const long long jb = 4 * i - hb + c;
        if (i < ma && ja >= 0 && ja < n) fa(ja, wa[c]);
        if (i < mb && jb >= 0 && jb < n) fb(jb, wb[c]);
      }
    }
  }
}

// The whole warp visits the nonzero bytes of src[0, n): f(j) for each, in
// no set order, reading 16-byte granules as stream_words does; all-zero
// granules are skipped whole.
template <int kLoad, class F>
__device__ __forceinline__ void stream_flags(
    const unsigned char* __restrict__ src, long long n, F f) {
  const int lane = threadIdx.x & 31;
  const int head = (int)((uintptr_t)src & 15);
  const int4* s4 = reinterpret_cast<const int4*>(src - head);
  const long long m = (head + n + 15) >> 4;
  for (long long g = 0; g < m; g += 32 * kLoad) {
    int4 x[kLoad];
#pragma unroll
    for (int k = 0; k < kLoad; ++k) {
      const long long i = g + 32 * k + lane;
      if (i < m) x[k] = load16(s4 + i);
    }
#pragma unroll
    for (int k = 0; k < kLoad; ++k) {
      const long long i = g + 32 * k + lane;
      if (i >= m || !(x[k].x | x[k].y | x[k].z | x[k].w)) continue;
      const long long j = 16 * i - head;
      const unsigned w[4] = {(unsigned)x[k].x, (unsigned)x[k].y,
                             (unsigned)x[k].z, (unsigned)x[k].w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        for (unsigned b = w[q]; b;) {
          const int byte = (__ffs(b) - 1) >> 3;
          const long long jb = j + 4 * q + byte;
          if (jb >= 0 && jb < n) f(jb);
          b &= ~(0xffu << (8 * byte));
        }
    }
  }
}

// K4's input of one shot as one sequence of 16-byte granules: the ones
// that cover its act row (V words), then the ones that cover its pass
// bytes (O*V), each run read from its own 16-byte aligned start.
struct ShotRun {
  const int4* a4;
  const int4* p4;
  int ha, hp;  // words (act) and bytes (passes) before each run's start
  long long ma, m;
  __device__ ShotRun(const int* a, int V, const unsigned char* p, int OV) {
    ha = (int)(((uintptr_t)a & 15) >> 2);
    a4 = reinterpret_cast<const int4*>(a - ha);
    ma = (ha + (long long)V + 3) >> 2;
    hp = (int)((uintptr_t)p & 15);
    p4 = reinterpret_cast<const int4*>(p - hp);
    m = ma + ((hp + (long long)OV + 15) >> 4);
  }
  // this lane's kLoad granules of the batch that starts at granule g
  template <int kLoad>
  __device__ __forceinline__ void load(long long g, int4* z) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < kLoad; ++k) {
      const long long i = g + 32 * k + lane;
      z[k] = i < ma  ? load16(a4 + i)
             : i < m ? load16(p4 + (i - ma))
                     : make_int4(0, 0, 0, 0);
    }
  }
};

// The whole warp streams shot r's run, kLoad granules a lane a batch, its
// first batch already loaded into x: each next batch's loads are issued
// before the current batch is folded, so a fold overlaps the next round
// trip, and after the last batch the next shot's first (when has_next) is
// loaded into x, in flight while this shot's spread and row out run.
// fa(j) for every nonzero act word j; fp(o, v) for every set pass byte
// (o, v), found from one division a nonzero granule; all-zero granules
// cost a test.
template <int kLoad, class FA, class FP>
__device__ __forceinline__ void stream_shot(const ShotRun& r,
                                            const ShotRun& next,
                                            bool has_next, int4* x, int V,
                                            int OV, FA fa, FP fp) {
  const int lane = threadIdx.x & 31;
  constexpr int kBatch = 32 * kLoad;
  int4 y[kLoad];
  for (long long g = 0; g < r.m; g += kBatch) {
    if (g + kBatch < r.m)
      r.load<kLoad>(g + kBatch, y);
    else if (has_next)
      next.load<kLoad>(0, y);
#pragma unroll
    for (int k = 0; k < kLoad; ++k) {
      const long long i = g + 32 * k + lane;
      const unsigned w[4] = {(unsigned)x[k].x, (unsigned)x[k].y,
                             (unsigned)x[k].z, (unsigned)x[k].w};
      if (!(w[0] | w[1] | w[2] | w[3]) || i >= r.m) continue;
      if (i < r.ma) {
        const long long j = 4 * i - r.ha;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (w[c] && j + c >= 0 && j + c < V) fa((int)(j + c));
        continue;
      }
      const long long j0 = 16 * (i - r.ma) - r.hp;  // the granule's byte 0
      const int b0 = j0 < 0 ? (int)-j0 : 0;          // its first in the run
      const int o0 = (int)(j0 + b0) / V;
      const int v0 = (int)(j0 + b0) - o0 * V;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        for (unsigned b = w[q]; b;) {
          const int off = 4 * q + ((__ffs(b) - 1) >> 3);
          b &= ~(0xffu << (8 * (off & 3)));
          if (off < b0 || j0 + off >= OV) continue;
          int o = o0, v = v0 + off - b0;
          while (v >= V) {  // a granule may span rows
            v -= V;
            ++o;
          }
          fp(o, v);
        }
    }
#pragma unroll
    for (int k = 0; k < kLoad; ++k) x[k] = y[k];
  }
}

// The whole warp writes dst[j] = g(j) for j in [0, n), a 16-byte granule
// at once where it lies whole in the row, else a word at a time.
template <class G>
__device__ __forceinline__ void write_words(int* __restrict__ dst,
                                            long long n, G g) {
  const int lane = threadIdx.x & 31;
  const int head = (int)(((uintptr_t)dst & 15) >> 2);
  const long long m = (head + n + 3) >> 2;
  for (long long i = lane; i < m; i += 32) {
    const long long j = 4 * i - head;
    if (j >= 0 && j + 4 <= n) {
      *reinterpret_cast<int4*>(dst + j) =
          make_int4(g(j), g(j + 1), g(j + 2), g(j + 3));
    } else {
      for (int c = 0; c < 4; ++c)
        if (j + c >= 0 && j + c < n) dst[j + c] = g(j + c);
    }
  }
}

// Label propagation to the fixpoint over the sat words, by the whole warp:
// Jacobi sweeps, the first over every member (mem[0, nM)), each later one
// over the frontier the sweep before marked. A vertex adopts the smallest
// candidate among its saturated neighbours and the hub, and only if that
// lowers its comp; the hub adopts the minimum over every saturated slot
// under the same rule (after its own candidates, if it has saturated
// edges). `fr` and `mark` (clear on entry and on return) hold the
// frontier.
template <class T>
__device__ __forceinline__ void propagate(int* cur, int* nxt,
                                          const unsigned* sat, const T& t,
                                          const int* deltas, int V, int O,
                                          int L, const uint16_t* mem, int nM,
                                          uint16_t* fr, unsigned* mark,
                                          int nw) {
  const int lane = threadIdx.x & 31;
  const int bn = V - 1;
  const uint16_t* list = mem;
  int nF = nM;
  bool hubF = true;
  while (nF > 0 || hubF) {
    const int hv = cur[bn];
    bool bn_in = false;
    for (int i = lane; i < nF; i += 32) {
      const int v = list[i];
      const int pv = cur[v];
      int cand = kBig;
      for (unsigned m = sat[v]; m; m &= m - 1u) {
        const int b = __ffs(m) - 1;
        int c;
        if (b < 2 * O) {
          const int o = b >> 1;
          const int d = deltas[o];
          c = (b & 1) ? (cur[v - d] ^ t.eobs(o * V + v - d))
                      : (cur[v + d] ^ t.eobs(o * V + v));
        } else {
          c = hv ^ t.bobs((b - 2 * O) * V + v);
        }
        cand = min(cand, c);
      }
      nxt[v] = (cand >> L) < (pv >> L) ? cand : pv;
      bn_in |= v == bn;
    }
    bool adopt_b = false;
    int hub = kBig;
    if (hubF) {
      int hl = kBig;
      for (int i = lane; i < nM; i += 32) {
        const int v = mem[i];
        for (unsigned m = sat[v] >> (2 * O); m; m &= m - 1u)
          hl = min(hl, cur[v] ^ t.bobs((__ffs(m) - 1) * V + v));
      }
      hub = __reduce_min_sync(kFull, hl);
      adopt_b = (hub >> L) < (hv >> L);
    }
    bn_in = __any_sync(kFull, bn_in);
    __syncwarp();
    if (adopt_b && bn_in) {  // the hub's own candidates lose to its slots
      if (lane == 0) nxt[bn] = hub;
      __syncwarp();
    }
    bool hub_next = false;
    bool bn_changed = false;
    for (int i = lane; i < nF; i += 32) {
      const int v = list[i];
      const int n = nxt[v];
      if (n == cur[v]) continue;
      cur[v] = n;
      const unsigned sb = sat[v];
      for (unsigned m = sb & ((1u << (2 * O)) - 1u); m; m &= m - 1u) {
        const int b = __ffs(m) - 1;
        const int d = deltas[b >> 1];
        set_bit(mark, (b & 1) ? v - d : v + d);
      }
      hub_next |= (sb >> (2 * O)) != 0u;
      bn_changed |= v == bn;
    }
    if (adopt_b && !bn_in && lane == 0) cur[bn] = hub;
    bn_changed = __any_sync(kFull, bn_changed) || (adopt_b && !bn_in);
    if (bn_changed) {
      // the hub's new label reaches its neighbours and every slot holder;
      // and a hub that took its slots' minimum over its own candidates
      // must weigh those again against its new label
      const unsigned sh = sat[bn];
      if (lane == 0 && sh) set_bit(mark, bn);
      for (unsigned m = sh & ((1u << (2 * O)) - 1u); m; m &= m - 1u) {
        const int b = __ffs(m) - 1;
        const int d = deltas[b >> 1];
        if (lane == 0) set_bit(mark, (b & 1) ? bn - d : bn + d);
      }
      for (int i = lane; i < nM; i += 32) {
        const int v = mem[i];
        if (sat[v] >> (2 * O)) set_bit(mark, v);
      }
    }
    hubF = __any_sync(kFull, hub_next) || bn_changed;
    __syncwarp();
    nF = compact_bits(mark, nw, fr, nullptr, nullptr, nullptr);
    list = fr;
  }
}

// The label row of one shot of K3, asked of L2 by lane 0 when the shot
// exists. Its mask planes are not, nor is any of K5's input: each was
// slower when timed asked ahead.
__device__ __forceinline__ void prefetch_label_row(const int* packed_in,
                                                   long long shot,
                                                   long long B, int V) {
  if ((threadIdx.x & 31) == 0 && shot < B)
    prefetch_l2(packed_in + shot * V, 4LL * V);
}

// Label propagation over the warp's shots (K3's body), with the label
// bits in form T. Each shot's label row was asked of L2 before: the first
// shot's at the launch, every next one's once the shot before is in.
template <class T>
__device__ __forceinline__ void prop_shots(
    const T& t, const int* __restrict__ packed_in,
    const unsigned char* __restrict__ satm,
    const unsigned char* __restrict__ satb, const int* deltas, long long B,
    int V, int O, int KB, int L, unsigned char* base, const ShotLayout& lay,
    int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int OV = O * V;
  const int nw = (V + 31) >> 5;
  int* cur = reinterpret_cast<int*>(base + lay.cur);
  int* nxt = reinterpret_cast<int*>(base + lay.nxt);
  unsigned* sat = reinterpret_cast<unsigned*>(base + lay.sat);
  uint16_t* mem = reinterpret_cast<uint16_t*>(base + lay.mem);
  uint16_t* fr = reinterpret_cast<uint16_t*>(base + lay.fr);
  unsigned* mark = reinterpret_cast<unsigned*>(base + lay.mark);

  const long long stride = (long long)gridDim.x * nwarps;
  for (long long shot = (long long)blockIdx.x * nwarps + warp; shot < B;
       shot += stride) {
    const long long row = shot * V;
    PHASE_START;
    // -- the shot in: labels, then the masks folded into sat words
    stream_words<kPropLoad>(packed_in + row, nullptr, V, true,
                            [&](long long j, int x) { cur[j] = x; });
    PHASE(0);
    stream_flags<kPropLoad>(satm + shot * OV, OV, [&](long long j) {
      const int o = (int)j / V;
      const int v = (int)j - o * V;
      const int d = deltas[o];
      if (v + d < V) {
        atomicOr(&sat[v], 1u << (2 * o));
        atomicOr(&sat[v + d], 1u << (2 * o + 1));
        set_bit(mark, v);
        set_bit(mark, v + d);
      }
    });
    stream_flags<kPropLoad>(satb + shot * KB * V, (long long)KB * V,
                            [&](long long j) {
      const int k = (int)j / V;
      const int v = (int)j - k * V;
      atomicOr(&sat[v], 1u << (2 * O + k));
      set_bit(mark, v);
    });
    __syncwarp();
    prefetch_label_row(packed_in, shot + stride, B, V);
    const int nM = compact_bits(mark, nw, mem, nullptr, nullptr, nullptr);
    PHASE(1);

    propagate(cur, nxt, sat, t, deltas, V, O, L, mem, nM, fr, mark, nw);
    PHASE(2);

    write_words(out + row, V, [&](long long j) { return cur[j]; });
    for (int i = lane; i < nM; i += 32) sat[mem[i]] = 0u;
    __syncwarp();
    PHASE(3);
  }
}

// K3. packed [B, V] int32, satm [B, O, V] and satb [B, KB, V] bytes (0/1)
// -> out [B, V] int32. A saturated edge (o, v) with v + d_o >= V has no
// neighbour to offer and is dropped, as the plain version never adopts
// through it.
__global__ void __launch_bounds__(kPropShots * 32, 1)
uf_stencil_prop_kernel(const int* __restrict__ packed_in,
                       const unsigned char* __restrict__ satm,
                       const unsigned char* __restrict__ satb,
                       const int* __restrict__ tab,
                       const int* __restrict__ deltas_in, long long B,
                       int V, int O, int KB, int L, bool tables_in_smem,
                       int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int deltas[kMaxOffsets];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int OV = O * V;
  const int nw = (V + 31) >> 5;

  // -- this warp's first label row asked of L2; the label bits of the edges
  //    and slots, once per block
  prefetch_label_row(packed_in,
                     (long long)blockIdx.x * (blockDim.x >> 5) + warp, B, V);
  if (threadIdx.x < O) deltas[threadIdx.x] = deltas_in[threadIdx.x];
  const ObsTables<int> planes{tab + 2 * OV, tab + 3 * OV + 2 * KB * V};
  const bool bytes = tables_in_smem && L <= 8;
  if (tables_in_smem) {
    auto make = [&](int i) { return i < OV ? planes.e[i] : planes.b[i - OV]; };
    if (bytes)
      stage_words(smem, (O + KB) * V,
                  [&](int i) { return (unsigned char)make(i); });
    else
      stage_words(reinterpret_cast<int*>(smem), (O + KB) * V, make);
  }
  __syncthreads();
  const size_t tab_bytes =
      tables_in_smem ? align16((size_t)(O + KB) * V * (bytes ? 1 : 4)) : 0;

  // -- this warp's shot state; sat and mark are clean between shots
  const ShotLayout lay = shot_layout(V, false);
  unsigned char* base = smem + tab_bytes + (size_t)warp * lay.bytes;
  unsigned* sat = reinterpret_cast<unsigned*>(base + lay.sat);
  unsigned* mark = reinterpret_cast<unsigned*>(base + lay.mark);
  for (int v = lane; v < V; v += 32) sat[v] = 0u;
  for (int w = lane; w < nw; w += 32) mark[w] = 0u;
  __syncwarp();

  if (bytes)
    prop_shots(ObsTables<unsigned char>{smem, smem + OV}, packed_in, satm,
               satb, deltas, B, V, O, KB, L, base, lay, out);
  else if (tables_in_smem)
    prop_shots(ObsTables<int>{reinterpret_cast<int*>(smem),
                              reinterpret_cast<int*>(smem) + OV},
               packed_in, satm, satb, deltas, B, V, O, KB, L, base, lay, out);
  else
    prop_shots(planes, packed_in, satm, satb, deltas, B, V, O, KB, L, base,
               lay, out);
}

// K4. act [B, V] int32 (any nonzero word active), passes [B, O, V] bytes
// (0/1) -> out [B, V] int32 0/1. A shot a warp: the act row's nonzero
// words are the seeds (act and mark bits); the set pass bytes (stream_shot)
// fold into pass words (bit 2o the edge to v + d_o, 2o+1 the edge to
// v - d_o; a pass with no vertex at v + d_o is dropped, as the plain
// version's shifts drop it); activity then spreads from the seeds breadth
// first, a frontier list a step, each newly active vertex claimed by the
// lane whose atomicOr set its bit. The OR-closure is unique, so the order
// is free. Out as 0/1 words; the pass words and act bits are cleared
// between shots (the mark bits are clear after the last step).
__global__ void __launch_bounds__(kActShots * 32, kActBlocks)
uf_stencil_act_kernel(const int* __restrict__ act_in,
                      const unsigned char* __restrict__ passes,
                      const int* __restrict__ deltas_in, long long B, int V,
                      int O, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int deltas[kMaxOffsets];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int OV = O * V;
  const int nw = (V + 31) >> 5;
  if (threadIdx.x < O) deltas[threadIdx.x] = deltas_in[threadIdx.x];
  __syncthreads();

  // -- this warp's shot state; pass words and bit sets are clean between
  //    shots
  const ActLayout lay = act_layout(V);
  unsigned char* base = smem + (size_t)warp * lay.bytes;
  unsigned* pass = reinterpret_cast<unsigned*>(base + lay.pass);
  unsigned* act = reinterpret_cast<unsigned*>(base + lay.act);
  unsigned* mark = reinterpret_cast<unsigned*>(base + lay.mark);
  uint16_t* fr = reinterpret_cast<uint16_t*>(base + lay.fr);
  uint4* pass4 = reinterpret_cast<uint4*>(pass);
  for (int i = lane; i < (V + 3) >> 2; i += 32)
    pass4[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int w = lane; w < nw; w += 32) act[w] = mark[w] = 0u;
  __syncwarp();

  // -- the warp's first shot's first batch in flight
  const long long stride = (long long)gridDim.x * nwarps;
  const long long first = (long long)blockIdx.x * nwarps + warp;
  int4 x[kActLoad];
  if (first < B)
    ShotRun(act_in + first * V, V, passes + first * OV, OV)
        .load<kActLoad>(0, x);
  for (long long shot = first; shot < B; shot += stride) {
    const long long row = shot * V;
    const long long nx = shot + stride < B ? shot + stride : shot;
    PHASE_START;
    // -- the act row (every nonzero word a seed: the first frontier) and
    //    the pass bytes, folded into pass words
    stream_shot<kActLoad>(
        ShotRun(act_in + row, V, passes + shot * OV, OV),
        ShotRun(act_in + nx * V, V, passes + nx * OV, OV), nx != shot, x,
        V, OV,
        [&](int j) {
          set_bit(act, j);
          set_bit(mark, j);
        },
        [&](int o, int v) {
          const int d = deltas[o];
          if (v + d < V) {
            atomicOr(&pass[v], 1u << (2 * o));
            atomicOr(&pass[v + d], 1u << (2 * o + 1));
          }
        });
    PHASE(4);
    __syncwarp();
    int nF = compact_bits(mark, nw, fr, nullptr, nullptr, nullptr);
    PHASE(5);

    // -- the spread, a frontier a step: the inactive ends of a frontier
    //    vertex's passing edges become active and form the next frontier
    while (nF > 0) {
      for (int i = lane; i < nF; i += 32) {
        const int u = fr[i];
        for (unsigned m = pass[u]; m; m &= m - 1u) {
          const int b = __ffs(m) - 1;
          const int d = deltas[b >> 1];
          const int w = (b & 1) ? u - d : u + d;
          const unsigned bit = 1u << (w & 31);
          if (!(act[w >> 5] & bit) && !(atomicOr(&act[w >> 5], bit) & bit))
            set_bit(mark, w);
        }
      }
      __syncwarp();
      nF = compact_bits(mark, nw, fr, nullptr, nullptr, nullptr);
    }
    PHASE(6);

    write_words(out + row, V, [&](long long j) {
      return (int)((act[j >> 5] >> (j & 31)) & 1u);
    });
    __syncwarp();
    // -- leave the state clean: the pass words (all of them, in 16-byte
    //    stores: cheaper than a member bit set a pass byte), the act bits
    for (int i = lane; i < (V + 3) >> 2; i += 32)
      pass4[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int w = lane; w < nw; w += 32) act[w] = 0u;
    __syncwarp();
    PHASE(7);
  }
}

// One growth round of the warp's shots (K5's body), with the tables in
// form T. A present edge (o, v) has v + d_o < V, as every stencil graph's
// has.
template <class T>
__device__ __forceinline__ void round_shots(
    const T& t, const int* __restrict__ packed_in,
    const int* __restrict__ seed_in, const int* __restrict__ sup_in,
    const int* deltas, long long B, int V, int O, int KB, int L, int minw,
    bool vec, unsigned char* base, const ShotLayout& lay,
    int* __restrict__ out_packed, int* __restrict__ out_sup,
    int* __restrict__ out_grew) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int bn = V - 1;
  const int OV = O * V;
  const int nw = (V + 31) >> 5;
  const unsigned edge_bits = (1u << (2 * O)) - 1u;

  int* cur = reinterpret_cast<int*>(base + lay.cur);
  int* nxt = reinterpret_cast<int*>(base + lay.nxt);
  unsigned* sat = reinterpret_cast<unsigned*>(base + lay.sat);
  uint16_t* mem = reinterpret_cast<uint16_t*>(base + lay.mem);
  uint16_t* fr = reinterpret_cast<uint16_t*>(base + lay.fr);
  unsigned* mbits = reinterpret_cast<unsigned*>(base + lay.mbits);
  unsigned* mark = reinterpret_cast<unsigned*>(base + lay.mark);
  unsigned* grew = reinterpret_cast<unsigned*>(base + lay.grew);
  unsigned char* act = base + lay.act;

  const long long stride = (long long)gridDim.x * nwarps;
  for (long long shot = (long long)blockIdx.x * nwarps + warp; shot < B;
       shot += stride) {
    const long long row = shot * V;
    const long long srow = shot * (O + KB) * V;
    const int* sup = sup_in + srow;
    PHASE_START;

    // -- the shot in: labels; seeds (active, members); the supports
    //    through to out_sup, their saturation folded into the sat words
    stream_pair<kRoundLoad>(
        packed_in + row, seed_in + row, V,
        [&](long long j, int x) { cur[j] = x; },
        [&](long long j, int x) {
          if (x) {
            act[j] = 1;
            set_bit(mark, (int)j);
          }
        });
    PHASE(8);
    stream_words<kRoundLoad>(sup, out_sup + srow, (long long)(O + KB) * V,
                             vec,
                 [&](long long j, int s) {
      if (s < minw) return;  // below every present weight
      const int r = (int)j / V;
      const int v = (int)j - r * V;
      if (r < O) {
        const Edge e = t.edge((int)j);
        const int d = deltas[r];
        if (e.present && s >= e.wt && v + d < V) {
          atomicOr(&sat[v], 1u << (2 * r));
          atomicOr(&sat[v + d], 1u << (2 * r + 1));
          set_bit(mark, v);
          set_bit(mark, v + d);
        }
      } else {
        const Edge e = t.slot((int)j - OV);
        if (e.present && s >= e.wt) {
          atomicOr(&sat[v], 1u << (2 * O + r - O));
          set_bit(mark, v);
        }
      }
    });
    __syncwarp();
    PHASE(9);
    int nM = 0;
    compact_bits(mark, nw, fr, mbits, mem, &nM);

    // -- activity from the seeds over the saturated edges inside one
    //    cluster, in place
    while (true) {
      bool changed = false;
      for (int i = lane; i < nM; i += 32) {
        const int u = mem[i];
        if (act[u]) continue;
        const int cu = cur[u] >> L;
        for (unsigned m = sat[u] & edge_bits; m; m &= m - 1u) {
          const int b = __ffs(m) - 1;
          const int d = deltas[b >> 1];
          const int w = (b & 1) ? u - d : u + d;
          if (act[w] && (cur[w] >> L) == cu) {
            act[u] = 1;
            changed = true;
            break;
          }
        }
      }
      __syncwarp();
      if (!__any_sync(kFull, changed)) break;
    }

    PHASE(10);
    // -- growth, delta-stepped, over the active members. Pass 1 finds each
    //    member's growable edges (bit 2o: edge (o, u); 2o+1: edge (o, u -
    //    d), grown from u when u - d is not active; 2O+k: slot k) and the
    //    slack, every load of an offset issued up front (indices clamped
    //    into the shot); the masks wait in `nxt` by member position. Pass 2
    //    grows them.
    const int hub_comp = cur[bn] >> L;
    int local = INT_MAX;
    for (int i = lane; i < nM; i += 32) {
      const int u = mem[i];
      unsigned gm = 0u;
      if (act[u]) {
        const int cu = cur[u] >> L;
        const unsigned su = sat[u];
#pragma unroll
        for (int o = 0; o < kMaxOffsets; ++o) {
          if (o < O) {
            const int d = deltas[o];
            const bool up_in = u + d < V;
            const int p = up_in ? u + d : bn;
            const int q = u >= d ? u - d : 0;
            const Edge ed = t.edge(o * V + u);  // edge (o, u): u -- u + d
            const Edge eq = t.edge(o * V + q);  // edge (o, u - d)
            const int cp = up_in ? cur[p] >> L : -1;
            const int cq = cur[q] >> L;
            const int ap = up_in ? act[p] : 0;
            const int aq = act[q];
            const int sd = __ldg(sup + o * V + u);
            const int sq = __ldg(sup + o * V + q);
            if (ed.present && !((su >> (2 * o)) & 1u) && sd < ed.wt &&
                cu != cp) {
              const int inc = 1 + ap;  // ceil((wt - sup) / inc), inc 1 or 2
              local = min(local, (ed.wt - sd + inc - 1) / inc);
              gm |= 1u << (2 * o);
            }
            if (u >= d && !aq && eq.present &&
                !((su >> (2 * o + 1)) & 1u) && sq < eq.wt && cu != cq) {
              local = min(local, eq.wt - sq);
              gm |= 1u << (2 * o + 1);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kMaxBoundary; ++k) {
          if (k < KB) {
            const Edge eb = t.slot(k * V + u);
            const int sb = __ldg(sup + OV + k * V + u);
            if (eb.present && !((su >> (2 * O + k)) & 1u) && sb < eb.wt &&
                cu != hub_comp) {
              local = min(local, eb.wt - sb);
              gm |= 1u << (2 * O + k);
            }
          }
        }
      }
      nxt[i] = (int)gm;
    }
    const int slack = __reduce_min_sync(kFull, local);
    int delta = slack > 1 ? slack : 1;
    if (delta >= kBig) delta = 1;
    __syncwarp();
    for (int i = lane; i < nM; i += 32) {
      const unsigned gm = (unsigned)nxt[i];
      if (!gm) continue;
      const int u = mem[i];
      for (unsigned m = gm; m; m &= m - 1u) {
        const int b = __ffs(m) - 1;
        const bool slot = b >= 2 * O;
        const int r = slot ? b - O : b >> 1;  // edge o or O + k
        const int d = slot ? 0 : deltas[r];
        const int lo = (b & 1) && !slot ? u - d : u;
        const int inc =
            slot || (b & 1) ? 1 : 1 + (u + d < V ? (int)act[u + d] : 0);
        const int idx = r * V + lo;
        const int w = slot ? t.slot(idx - OV).wt : t.edge(idx).wt;
        const int s = __ldg(sup + idx) + inc * delta;
        out_sup[srow + idx] = s;
        set_bit(grew, lo);
        if (s < w) continue;
        if (slot) {
          atomicOr(&sat[u], 1u << b);
          set_bit(mark, u);
        } else if (lo + d < V) {
          atomicOr(&sat[lo], 1u << (2 * r));
          atomicOr(&sat[lo + d], 1u << (2 * r + 1));
          set_bit(mark, lo);
          set_bit(mark, lo + d);
        }
      }
    }
    __syncwarp();
    // the ends of newly saturated edges join the members
    compact_bits(mark, nw, fr, mbits, mem, &nM);
    write_words(out_grew + row, V, [&](long long j) {
      return (int)((grew[j >> 5] >> (j & 31)) & 1u);
    });

    PHASE(11);
    // -- label propagation to the fixpoint over the new saturation
    propagate(cur, nxt, sat, t, deltas, V, O, L, mem, nM, fr, mark, nw);
    PHASE(12);

    write_words(out_packed + row, V, [&](long long j) { return cur[j]; });
    // -- leave the state clean: only members changed
    for (int i = lane; i < nM; i += 32) {
      const int v = mem[i];
      sat[v] = 0u;
      act[v] = 0;
    }
    for (int w = lane; w < nw; w += 32) {
      mbits[w] = 0u;
      grew[w] = 0u;
    }
    __syncwarp();
    PHASE(13);
  }
}

// K5. packed, seed [B, V] int32; sup [B, O+KB, V] int32 (O edge planes,
// then KB boundary planes) -> out_packed [B, V], out_sup [B, O+KB, V],
// out_grew [B, V] (1 where an edge or slot at v grew).
__global__ void __launch_bounds__(kRoundShots * 32, 1)
uf_stencil_round_kernel(const int* __restrict__ packed_in,
                        const int* __restrict__ seed_in,
                        const int* __restrict__ sup_in,
                        const int* __restrict__ tab,
                        const int* __restrict__ deltas_in, long long B,
                        int V, int O, int KB, int L, bool tables_in_smem,
                        int* __restrict__ out_packed,
                        int* __restrict__ out_sup,
                        int* __restrict__ out_grew) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int deltas[kMaxOffsets];
  __shared__ int minw;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int OV = O * V;
  const int nw = (V + 31) >> 5;

  // -- the tables, once per block: narrow words when every edge fits
  //    them, and the least present weight (supports below it saturate
  //    nothing)
  if (threadIdx.x < O) deltas[threadIdx.x] = deltas_in[threadIdx.x];
  if (threadIdx.x == 0) minw = INT_MAX;
  __syncthreads();
  const PlaneTables pt(tab, V, O, KB);
  unsigned* words = reinterpret_cast<unsigned*>(smem);
  int lw = INT_MAX;
  bool fits = tables_in_smem;
  for (int i = threadIdx.x; i < (O + KB) * V; i += blockDim.x) {
    const TableEntry t = table_entry(pt, i, OV);
    if (t.e.present) lw = min(lw, t.e.wt);
    if (tables_in_smem) {
      fits = fits && t.narrow(L);
      words[i] = EdgeForm<false>::make(t.e.present, t.e.wt, t.obs, L);
    }
  }
  lw = __reduce_min_sync(kFull, lw);
  if (lane == 0) atomicMin(&minw, lw);
  const bool narrow = __syncthreads_and(fits) != 0;
  const size_t tab_bytes =
      tables_in_smem ? align16((size_t)(O + KB) * V * 4) : 0;
  const int least = minw;

  // -- this warp's shot state; sat, act, mbits, mark and grew are clean
  //    between shots
  const ShotLayout lay = shot_layout(V, true);
  unsigned char* base = smem + tab_bytes + (size_t)warp * lay.bytes;
  unsigned* sat = reinterpret_cast<unsigned*>(base + lay.sat);
  unsigned char* act = base + lay.act;
  unsigned* mbits = reinterpret_cast<unsigned*>(base + lay.mbits);
  unsigned* mark = reinterpret_cast<unsigned*>(base + lay.mark);
  unsigned* grew = reinterpret_cast<unsigned*>(base + lay.grew);
  for (int v = lane; v < V; v += 32) {
    sat[v] = 0u;
    act[v] = 0;
  }
  for (int w = lane; w < nw; w += 32) {
    mbits[w] = 0u;
    mark[w] = 0u;
    grew[w] = 0u;
  }
  __syncwarp();

  // the supports stream 16 bytes at a time when in and out lie alike
  const bool vec = ((uintptr_t)sup_in & 15) == ((uintptr_t)out_sup & 15);
  if (narrow)
    round_shots(NarrowTables{words, words + OV, L}, packed_in, seed_in,
                sup_in, deltas, B, V, O, KB, L, least, vec, base, lay,
                out_packed, out_sup, out_grew);
  else
    round_shots(pt, packed_in, seed_in, sup_in, deltas, B, V, O, KB, L,
                least, vec, base, lay, out_packed, out_sup, out_grew);
}

// The launch plans of K3, K5 and K4: the tables staged when they fit beside
// one shot (K3's label bits a byte an edge and slot when L <= 8, else an
// int32; K5's narrow words only when L allows them).
Plan plan_prop(int V, int O, int KB, int L) {
  return plan_shots(shot_layout(V, false).bytes,
                    align16((size_t)(O + KB) * V * (L <= 8 ? 1 : 4)), true,
                    kPropShots);
}

Plan plan_round(int V, int O, int KB, int L) {
  return plan_shots(shot_layout(V, true).bytes,
                    align16((size_t)(O + KB) * V * 4),
                    L <= kNarrowMaxShift, kRoundShots);
}

// K4's: no tables, as many shots as fit up to kActShots.
Plan plan_act(int V) {
  return plan_shots(act_layout(V).bytes, 0, false, kActShots);
}

// Blocks of kernel K the card holds at once with plan p, after opting K in
// to the plan's shared memory (the kernels have static shared memory too,
// so they opt in to no more than they ask for).
template <auto K>
cudaError_t resident(const Plan& p, int* per_sm, int* sms) {
  const void* k = reinterpret_cast<const void*>(K);
  int dev = 0;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, k, p.shots_per_block * 32, p.smem);
  return err;
}

// A persistent launch of a warp-a-shot kernel: as many blocks as the card
// holds at once, no more than the shots need.
template <auto K>
cudaError_t launch_persistent(const Plan& p, long long B, void** args,
                              void* stream) {
  if (p.shots_per_block == 0) return cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  cudaError_t err = resident<K>(p, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  if (B == 0) return cudaGetLastError();
  const long long need = (B + p.shots_per_block - 1) / p.shots_per_block;
  const int grid =
      (int)std::min<long long>(need, (long long)sms * std::max(per_sm, 1));
  err = cudaLaunchKernel(reinterpret_cast<const void*>(K), dim3(grid),
                         dim3(p.shots_per_block * 32), args, p.smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The launch plan of K3 (kernel 3), K4 (kernel 4) or K5 (kernel 5) at a
// graph's shape: out[0] shots (warps) per block, out[1] dynamic shared
// memory per block in bytes, out[2] the form the kernel reads its tables
// in (0 the int32 tables in device memory, 1 K3's label bytes staged in
// shared memory, 2 K3's label words staged, 3 K5's narrow words staged, 4
// none: K4 reads no tables), out[3] bytes of
// one shot's state, out[4] registers per thread, out[5] resident blocks
// per SM. K5 stages narrow words only when every entry of its tables fits
// them: with `tables` (the int32 tables on the card) the form is the one
// K5 takes for them, found as K5 finds it (narrow_check_kernel, then a
// wait for the card); without, the one it takes when they fit. Returns the
// CUDA error code (0 = success); out[0] is 0 when one shot's state does
// not fit in a block, or V is past the 16-bit lists (65536).
extern "C" int qcss_stencil_staged_config(int kernel, int V, int O, int KB,
                                          int L, const int* tables,
                                          long long* out) {
  if (!qcss::stencil_shape_ok(V, O, KB) || kernel < 3 || kernel > 5)
    return (int)cudaErrorInvalidValue;
  Plan p = kernel == 3   ? plan_prop(V, O, KB, L)
           : kernel == 4 ? plan_act(V)
                         : plan_round(V, O, KB, L);
  if (V > 65536) p.shots_per_block = 0;  // past the 16-bit lists
  out[0] = p.shots_per_block;
  out[1] = (long long)p.smem;
  out[2] = kernel == 4 ? 4 : !p.tables_in_smem ? 0 : kernel == 5 ? 3
           : L <= 8 ? 1 : 2;
  out[3] = (long long)p.shot_bytes;
  out[4] = out[5] = 0;
  if (p.shots_per_block == 0) return 0;
  cudaError_t err = cudaSuccess;
  if (kernel == 5 && p.tables_in_smem && tables) {
    int* fit = nullptr;
    const int one = 1;
    int narrow = 0;
    err = cudaMalloc(&fit, sizeof(int));
    if (err == cudaSuccess)
      err = cudaMemcpy(fit, &one, sizeof(int), cudaMemcpyHostToDevice);
    if (err == cudaSuccess) {
      narrow_check_kernel<<<(int)std::min<long long>(
                                ((long long)(O + KB) * V + 255) / 256, 1024),
                            256>>>(tables, V, O, KB, L, fit);
      err = cudaGetLastError();
    }
    if (err == cudaSuccess)
      err = cudaMemcpy(&narrow, fit, sizeof(int), cudaMemcpyDeviceToHost);
    if (fit) cudaFree(fit);
    if (err != cudaSuccess) return (int)err;
    if (!narrow) out[2] = 0;
  }
  int per_sm = 0, sms = 0;
  err = kernel == 3   ? resident<uf_stencil_prop_kernel>(p, &per_sm, &sms)
        : kernel == 4 ? resident<uf_stencil_act_kernel>(p, &per_sm, &sms)
                      : resident<uf_stencil_round_kernel>(p, &per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  const void* k = kernel == 3   ? (const void*)uf_stencil_prop_kernel
                  : kernel == 4 ? (const void*)uf_stencil_act_kernel
                                : (const void*)uf_stencil_round_kernel;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, k);
  out[4] = attr.numRegs;
  out[5] = per_sm;
  return (int)err;
}

// Each entry point returns the CUDA error code of its launch (0 =
// success). tables [3*O + 3*KB, V] and deltas [O] are the ones of
// qcss_uf_stencil_full.

extern "C" int qcss_stencil_prop(const int* packed, const void* satm,
                                 const void* satb, const int* tables,
                                 const int* deltas, int B, int V, int O,
                                 int KB, int L, int* out, void* stream) {
  if (!qcss::stencil_shape_ok(V, O, KB) || V > 65536 || B < 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_prop(V, O, KB, L);
  long long Bl = B;
  bool staged = p.tables_in_smem;
  const unsigned char* sm = (const unsigned char*)satm;
  const unsigned char* sb = (const unsigned char*)satb;
  void* args[] = {(void*)&packed, (void*)&sm, (void*)&sb, (void*)&tables,
                  (void*)&deltas, (void*)&Bl, (void*)&V, (void*)&O,
                  (void*)&KB, (void*)&L, (void*)&staged, (void*)&out};
  return (int)launch_persistent<uf_stencil_prop_kernel>(p, Bl, args, stream);
}

extern "C" int qcss_stencil_act(const int* act, const void* passes,
                                const int* deltas, int B, int V, int O,
                                int* out, void* stream) {
  if (!qcss::stencil_shape_ok(V, O, 1) || V > 65536 || B < 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_act(V);
  long long Bl = B;
  const unsigned char* pa = (const unsigned char*)passes;
  void* args[] = {(void*)&act, (void*)&pa, (void*)&deltas, (void*)&Bl,
                  (void*)&V, (void*)&O, (void*)&out};
  return (int)launch_persistent<uf_stencil_act_kernel>(p, Bl, args, stream);
}

extern "C" int qcss_stencil_round(const int* packed, const int* seed,
                                  const int* sup, const int* tables,
                                  const int* deltas, int B, int V, int O,
                                  int KB, int L, int* out_packed,
                                  int* out_sup, int* out_grew,
                                  void* stream) {
  if (!qcss::stencil_shape_ok(V, O, KB) || V > 65536 || B < 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_round(V, O, KB, L);
  long long Bl = B;
  bool staged = p.tables_in_smem;
  void* args[] = {(void*)&packed, (void*)&seed, (void*)&sup,
                  (void*)&tables, (void*)&deltas, (void*)&Bl, (void*)&V,
                  (void*)&O, (void*)&KB, (void*)&L, (void*)&staged,
                  (void*)&out_packed, (void*)&out_sup, (void*)&out_grew};
  return (int)launch_persistent<uf_stencil_round_kernel>(p, Bl, args,
                                                         stream);
}

#ifdef QCSS_STAGED_PHASES
// Copies the 16 phase counters to out (host memory) and clears them.
extern "C" int qcss_stencil_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, phase_cycles,
                                         sizeof(phase_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[16] = {};
  return (int)cudaMemcpyToSymbol(phase_cycles, zero, sizeof(zero));
}
#endif
