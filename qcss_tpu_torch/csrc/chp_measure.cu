// Fused multi-qubit CHP Z-measurement of a packed stabilizer tableau (K9),
// CUDA C++ for sm_90a.
//
// Replaces: qcss_tpu/sim/pallas_measure.py _measure_many_fused_t (body
//   _measure_kernel, entry point measure_many_fused). Plain version:
//   qcss_tpu_torch/sim/tableau_packed.py measure_many, the scan of
//   measure_z; given the same collapse bits the kernel returns the same
//   outcomes, x, z and r, bit for bit.
//
// Layout: x, z [B, 2n, W] 32-bit words in int32 storage (the port's
//   PackedTableau: bit q % 32 of word q / 32, read as unsigned here, so
//   bit 31 behaves as in the reference's uint32), r [B, 2n] uint8 signs,
//   qubits [M] int32, rand [B, M] uint8 collapse bits drawn outside the
//   kernel. Outputs: the new x, z, r and the outcomes [B, M] uint8.
//
// Per measured qubit q (the reference's algorithm):
//   * pivot: the first (lowest-index) stabilizer row with bit q set — the
//     scan's argmax tie-break;
//   * random: every other row with bit q set does the rowsum with the
//     pivot, g = popc(plus) - popc(minus) and r = ((2r + 2pr + g) & 3)
//     >> 1 (& 3 is the floor mod 4 of the reference's %, as g may be
//     negative); destabilizer p - n takes the old pivot row and the pivot
//     row becomes Z_q with the shot's collapse bit, which is the outcome;
//   * deterministic (no pivot): the stabilizer rows n + l whose
//     destabilizer l has bit q set are multiplied in ascending l; the
//     outcome is ((base + 2 pair) & 3) >> 1 with base = sum (2r +
//     popc(x & z)) and pair the parity of sum popc(x & prefix), prefix the
//     XOR of the earlier selected rows' z words.
//
// What bounds it on this card: device memory for the tableau, which
//   crosses it once each way (577 MB at n = 363, B = 4096: 0.17 ms at
//   3.35 TB/s), and otherwise the latency of the 32 dependent measurements
//   of a shot: a measurement touches about 10 of the 2n rows (the ladder
//   state), so its time is a chain of shared-memory reads, a reduction and
//   one rowsum, not arithmetic. The form before this one (a block of up to
//   256 threads a shot, one thread a row, 5 block barriers a random
//   measurement and 3W + 6 a deterministic one, rows at stride W in
//   shared memory) spent that chain in barriers and bank conflicts.
//
// Design: the shot's tableau sits in shared memory WORD-MAJOR, word w of
//   row i at [w * S + i] with S = 2n, so lanes that test the measured bit
//   of neighbouring rows read neighbouring words (no bank conflict). A
//   thread (form 1: a lane) owns row PAIRS: destabilizer l and stabilizer
//   n + l for l = t, t + T, ..., so the owner of the pivot p also owns
//   p - n. Global
//   memory is copied in and out in 16-byte pieces where the shot's words
//   are 16-byte aligned (nW even and aligned tensors), else in 4-byte
//   pieces; the transpose happens between registers and shared memory.
//   The wrapper chooses one of three forms by n and W (`plan_k9`):
//
//   Form 1, W <= 4 (n <= 128): a warp per shot, kWarps1 shots a block,
//     persistent warps walking the batch; no block barrier at all. The
//     measured bit of each 32-row chunk is a ballot; the pivot is the
//     first set bit of the first non-zero stabilizer ballot (ascending
//     chunks, __ffs). The rows to update (ballots minus p and p - n) are
//     ranked across the ballots, and lane j takes the rowsums of ranks j,
//     j + 32, ...: ~10 rowsums a measurement run on ~10 lanes at once
//     whoever owns the rows. Every lane holds the pivot row in registers
//     before any row is written (__syncwarp). The deterministic product
//     runs chunk by chunk over the selected rows: an inclusive XOR scan
//     with __shfl_up_sync per word, the chunk's total carried to the next,
//     and the phase summed with __reduce_add_sync.
//   Form 2, W >= 5 while the tableau fits in the 227 KB of a block (n <=
//     659): a block of kThreads2 threads a shot, persistent blocks, three
//     resident an SM at n = 363 (74 KB each), two block barriers a
//     measurement. Each measurement also prepares the next one: for every
//     row it notes the row's bit at the NEXT measured qubit (a flag byte)
//     and lists the rows that have it (a shared-memory atomic a warp
//     places them), and the warps' minima of the stabilizers so noted give
//     the next pivot. So a random measurement starts with its targets
//     listed, and spreads them over the whole block: in phase A one thread
//     a (target, word) item XORs the pivot's word in (read in place; no
//     one writes the pivot row in phase A) and adds its phase term mod 4
//     to the target's byte (at most 21 terms of 3: no carry between
//     bytes), and the item of the next qubit's word notes the row's new
//     bit; meanwhile the pair owners note the rows the measurement leaves
//     as they are. The ladder state's ~12 targets are neighbouring rows:
//     a warp, or a thread, taking its own rows' rowsums set the pace of
//     the block. Barrier; in phase B a thread a target sets its sign from
//     its byte, and W threads move the pivot row to p - n and write Z_q
//     into p. Barrier. A deterministic measurement runs thread (w, c) over
//     word w of a contiguous chunk c of the rows: the pair parity within
//     the chunk from its running XOR of z, and the chunk's XOR of x and
//     of z; after the barrier W threads combine the chunks (parity is
//     linear: chunk c adds popc(its x XOR & the z XOR of the chunks before
//     it)), so no word is scanned across the block by shuffles; a second
//     barrier carries the phase sum with the next pivot. A second buffer
//     to prefetch the next shot was left out on purpose: at n = 363 it
//     would leave one block (one shot) an SM where three resident blocks
//     overlap one shot's copies with two others' measurements. Each block
//     asks L2 for its next shot's tableau while it measures this one
//     (~2% faster at n = 363 on an H100; in form 1 the same made n = 121
//     ~4% slower, so form 1 does not).
//   Form 3, larger tableaus: a block a shot working on its output buffers
//     in device memory, row-major (the form that came before, kept as it
//     was for n >= 660).
//   The TPU kernel's lane transpose, one-hot selects, roll-based prefix
//   and compute-both-branches have no counterpart; any B is taken.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "block_reduce.cuh"
#include "residency.cuh"

namespace {

using qcss::kMaxSmem;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps1 = 4;      // form 1: shots (warps) a block
constexpr int kThreads2 = 256;  // form 2: threads a block
constexpr int kWarps2 = kThreads2 / 32;
constexpr int kThreads3 = 256;  // form 3: the most threads a block

__host__ __device__ constexpr long long round_up4(long long v) {
  return (v + 3) / 4 * 4;
}

// Words of one shot in form 1 or 2: X and Z word-major at stride S = 2n,
// then the 2n sign bytes, rounded to whole 16-byte pieces.
__host__ __device__ constexpr long long shot_words(int n, int W) {
  return round_up4(2LL * W * (2 * n) + (2 * n + 3) / 4);
}

// Words of one warp in form 1: its shot, then the list of rows to update
// (a byte a row, 2n <= 256).
__host__ __device__ constexpr long long warp1_words(int n, int W) {
  return shot_words(n, W) + round_up4((2 * n + 3) / 4);
}

// Form 2's header words: the warps' minima and sums, double-buffered,
// and three list counters (and a word of padding).
__host__ __device__ constexpr long long header2_words() {
  return 4LL * kWarps2 + 4;
}

// Form 2's words: the header, the shot, the row flags [2][2n] bytes, the
// target lists [2][2n] 16-bit rows and the rowsums' phase bytes [2n].
__host__ __device__ constexpr long long block2_words(int n, int W) {
  return header2_words() + shot_words(n, W) + round_up4((4 * n + 3) / 4) +
         round_up4((8 * n + 3) / 4) + round_up4((2 * n + 3) / 4);
}

// -- copies between the global row-major [2n, W] words and the shared
//    word-major [W][S] words of one shot, by `threads` threads ------------

template <int kCnt>
__device__ __forceinline__ void put_words(unsigned* X, int S, int W, int e,
                                          const unsigned (&v)[kCnt]) {
  int row = e / W;
  int w = e - row * W;
#pragma unroll
  for (int k = 0; k < kCnt; ++k) {
    X[w * S + row] = v[k];
    if (++w == W) {
      w = 0;
      ++row;
    }
  }
}

template <int kCnt>
__device__ __forceinline__ void get_words(const unsigned* X, int S, int W,
                                          int e, unsigned (&v)[kCnt]) {
  int row = e / W;
  int w = e - row * W;
#pragma unroll
  for (int k = 0; k < kCnt; ++k) {
    v[k] = X[w * S + row];
    if (++w == W) {
      w = 0;
      ++row;
    }
  }
}

// The copies issue two pieces' loads a thread before their stores, so
// that several loads of each thread are in flight.
__device__ __forceinline__ void copy_in(const unsigned* __restrict__ xg,
                        const unsigned* __restrict__ zg,
                        const unsigned char* __restrict__ rg, unsigned* X,
                        unsigned* Z, unsigned char* R, int n, int W, bool vec,
                        int t, int threads) {
  const int two_n = 2 * n;
  const int tw = two_n * W;
  const int S = two_n;
  if (vec) {
    const uint4* x4 = reinterpret_cast<const uint4*>(xg);
    const uint4* z4 = reinterpret_cast<const uint4*>(zg);
    const int pieces = tw / 4;
    for (int c = t; c < pieces; c += 2 * threads) {
      const int c2 = c + threads;
      const uint4 a = __ldg(x4 + c);
      const uint4 b = __ldg(z4 + c);
      uint4 a2 = a, b2 = b;
      if (c2 < pieces) {
        a2 = __ldg(x4 + c2);
        b2 = __ldg(z4 + c2);
      }
      put_words(X, S, W, 4 * c, {a.x, a.y, a.z, a.w});
      put_words(Z, S, W, 4 * c, {b.x, b.y, b.z, b.w});
      if (c2 < pieces) {
        put_words(X, S, W, 4 * c2, {a2.x, a2.y, a2.z, a2.w});
        put_words(Z, S, W, 4 * c2, {b2.x, b2.y, b2.z, b2.w});
      }
    }
  } else {
    for (int e = t; e < tw; e += threads) {
      put_words<1>(X, S, W, e, {__ldg(xg + e)});
      put_words<1>(Z, S, W, e, {__ldg(zg + e)});
    }
  }
  for (int i = t; i < two_n; i += threads) R[i] = __ldg(rg + i);
}

__device__ __forceinline__ void copy_out(const unsigned* X, const unsigned* Z,
                         const unsigned char* R, unsigned* __restrict__ xg,
                         unsigned* __restrict__ zg,
                         unsigned char* __restrict__ rg, int n, int W,
                         bool vec, int t, int threads) {
  const int two_n = 2 * n;
  const int tw = two_n * W;
  const int S = two_n;
  if (vec) {
    uint4* x4 = reinterpret_cast<uint4*>(xg);
    uint4* z4 = reinterpret_cast<uint4*>(zg);
    for (int c = t; c < tw / 4; c += threads) {
      unsigned va[4], vb[4];
      get_words(X, S, W, 4 * c, va);
      get_words(Z, S, W, 4 * c, vb);
      x4[c] = make_uint4(va[0], va[1], va[2], va[3]);
      z4[c] = make_uint4(vb[0], vb[1], vb[2], vb[3]);
    }
  } else {
    for (int e = t; e < tw; e += threads) {
      unsigned a[1], b[1];
      get_words(X, S, W, e, a);
      get_words(Z, S, W, e, b);
      xg[e] = a[0];
      zg[e] = b[0];
    }
  }
  for (int i = t; i < two_n; i += threads) rg[i] = R[i];
}

// The measured qubits and a shot's collapse bits, 32 measurements at a
// time in one register a lane (lane j holds measurement 32c + j of chunk
// c), so that no measurement waits on a load from device memory.
struct Window {
  int q_cur, q_next;  // qubits of chunks c and c + 1
  int b_cur;          // collapse bits of chunk c

  __device__ __forceinline__ void load(const int* __restrict__ qubits,
                       const unsigned char* __restrict__ bits, int M,
                       int m0, int lane) {
    q_cur = m0 + lane < M ? __ldg(qubits + m0 + lane) : 0;
    q_next = m0 + 32 + lane < M ? __ldg(qubits + m0 + 32 + lane) : 0;
    b_cur = m0 + lane < M ? __ldg(bits + m0 + lane) : 0;
  }
  // at each m with m % 32 == 0, m > 0
  __device__ __forceinline__ void advance(const int* __restrict__ qubits,
                          const unsigned char* __restrict__ bits, int M,
                          int m, int lane) {
    q_cur = q_next;
    q_next = m + 32 + lane < M ? __ldg(qubits + m + 32 + lane) : 0;
    b_cur = m + lane < M ? __ldg(bits + m + lane) : 0;
  }
  __device__ int qubit(int m) const {
    return __shfl_sync(0xffffffffu, q_cur, m & 31);
  }
  // the qubit of measurement m + 1
  __device__ int next_qubit(int m) const {
    const int a = __shfl_sync(0xffffffffu, q_cur, (m + 1) & 31);
    const int b = __shfl_sync(0xffffffffu, q_next, 0);
    return ((m + 1) & 31) ? a : b;
  }
  __device__ int bit(int m) const {
    return __shfl_sync(0xffffffffu, b_cur, m & 31);
  }
};

// Ask L2 for one shot's tableau (x, z, r), 128-byte lines split over the
// block's threads.
__device__ __forceinline__ void prefetch_shot(const unsigned* x,
                                              const unsigned* z,
                                              const unsigned char* r,
                                              long long tw, int two_n,
                                              int tid, int threads) {
  for (long long o = 128LL * tid; o < 4 * tw; o += 128LL * threads) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(
        reinterpret_cast<const char*>(x) + o));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(
        reinterpret_cast<const char*>(z) + o));
  }
  for (int o = 128 * tid; o < two_n; o += 128 * threads)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(r + o));
}

// g-sum contribution of one word pair, and the rowsum's XOR in place.
__device__ __forceinline__ int rowsum_word(unsigned x1, unsigned z1,
                                           unsigned& x2, unsigned& z2) {
  const unsigned plus = (x1 & z1 & z2 & ~x2) | (x1 & ~z1 & x2 & z2) |
                        (~x1 & z1 & x2 & ~z2);
  const unsigned minus = (x1 & z1 & x2 & ~z2) | (x1 & ~z1 & ~x2 & z2) |
                         (~x1 & z1 & x2 & z2);
  x2 ^= x1;
  z2 ^= z1;
  return __popc(plus) - __popc(minus);
}

__device__ __forceinline__ unsigned warp_incl_xor(unsigned v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v ^= t;
  }
  return v;
}

// ---------------------------------------------------------------------------
// Form 1: a warp a shot (W <= 4, n <= 32 W)
// ---------------------------------------------------------------------------

template <int W>
__global__ void __launch_bounds__(kWarps1 * 32) chp_measure_warp_kernel(
    const unsigned* __restrict__ x_in, const unsigned* __restrict__ z_in,
    const unsigned char* __restrict__ r_in, const int* __restrict__ qubits,
    const unsigned char* __restrict__ rand, long long B, int n, int M,
    bool vec, unsigned* __restrict__ x_out, unsigned* __restrict__ z_out,
    unsigned char* __restrict__ r_out, unsigned char* __restrict__ out) {
  constexpr int K = W;  // 32-row chunks of each half: n <= 32 W
  extern __shared__ __align__(16) unsigned smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int two_n = 2 * n;
  const int S = two_n;
  const long long tw = (long long)two_n * W;
  const int nk = (n + 31) >> 5;
  unsigned* X = smem + warp * warp1_words(n, W);
  unsigned* Z = X + W * S;
  unsigned char* R = reinterpret_cast<unsigned char*>(Z + W * S);
  unsigned char* list =
      reinterpret_cast<unsigned char*>(X + shot_words(n, W));
  const unsigned lt = (1u << lane) - 1u;  // the lanes below this one

  for (long long shot = (long long)blockIdx.x * kWarps1 + warp; shot < B;
       shot += (long long)gridDim.x * kWarps1) {
    copy_in(x_in + shot * tw, z_in + shot * tw, r_in + shot * two_n, X, Z, R,
            n, W, vec, lane, 32);
    Window win;
    win.load(qubits, rand + shot * M, M, 0, lane);
    __syncwarp();
    for (int m = 0; m < M; ++m) {
      if (m && !(m & 31)) win.advance(qubits, rand + shot * M, M, m, lane);
      const int q = win.qubit(m);
      const int wq = q >> 5;
      const unsigned bq = 1u << (q & 31);
      const unsigned* Xq = X + wq * S;
      unsigned dmask[K], smask[K];  // rows l and n + l with bit q, by chunk
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int l = 32 * k + lane;
        const bool in = k < nk && l < n;
        dmask[k] = __ballot_sync(kFull, in && (Xq[l] & bq));
        smask[k] = __ballot_sync(kFull, in && (Xq[n + l] & bq));
      }
      int p = -1;
#pragma unroll
      for (int k = K - 1; k >= 0; --k)
        if (smask[k]) p = n + 32 * k + __ffs(smask[k]) - 1;
      int outcome;
      const int bit = win.bit(m);
      if (p >= 0) {  // random
        unsigned px[W], pz[W];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          px[w] = X[w * S + p];
          pz[w] = Z[w * S + p];
        }
        const int pr = R[p];
        // rank the rows to update (destabilizer chunks, then stabilizer;
        // not p - n and p) into the warp's list, each by its owner lane
        const int kp = (p - n) >> 5;
        const unsigned bp = ~(1u << ((p - n) & 31));
        int cnt = 0;
#pragma unroll
        for (int h = 0; h < 2 * K; ++h) {
          unsigned mk = h < K ? dmask[h] : smask[h - K];
          if (h % K == kp) mk &= bp;
          if (!mk) continue;  // warp-uniform: most chunks have no target
          if ((mk >> lane) & 1u)
            list[cnt + __popc(mk & lt)] =
                (unsigned char)((h < K ? 0 : n) + 32 * (h % K) + lane);
          cnt += __popc(mk);
        }
        __syncwarp();  // the list, and every lane holds the pivot row
        for (int j = lane; j < cnt; j += 32) {
          const int i = list[j];
          int g = 0;
#pragma unroll
          for (int w = 0; w < W; ++w) {
            unsigned x2 = X[w * S + i], z2 = Z[w * S + i];
            g += rowsum_word(px[w], pz[w], x2, z2);
            X[w * S + i] = x2;
            Z[w * S + i] = z2;
          }
          R[i] = (unsigned char)(((2 * R[i] + 2 * pr + g) & 3) >> 1);
        }
        // lane w moves word w of the pivot row to p - n and writes Z_q
        if (lane < W) {
          X[lane * S + p - n] = X[lane * S + p];
          Z[lane * S + p - n] = Z[lane * S + p];
          X[lane * S + p] = 0u;
          Z[lane * S + p] = lane == wq ? bq : 0u;
        }
        if (lane == 0) {
          R[p - n] = (unsigned char)pr;
          R[p] = (unsigned char)bit;
        }
        outcome = bit;
      } else {  // deterministic: stabilizer n + l selected by dmask
        int base = 0;
        unsigned pair = 0u;
        unsigned carry[W];
#pragma unroll
        for (int w = 0; w < W; ++w) carry[w] = 0u;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (!dmask[k]) continue;  // warp-uniform
          const int l = 32 * k + lane;
          const bool sel = (dmask[k] >> lane) & 1u;
          int y = 0;
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const unsigned zv = sel ? Z[w * S + n + l] : 0u;
            const unsigned xv = sel ? X[w * S + n + l] : 0u;
            const unsigned incl = warp_incl_xor(zv, lane);
            pair ^= __popc(xv & (incl ^ zv ^ carry[w])) & 1u;
            y += __popc(xv & zv);
            carry[w] ^= __shfl_sync(kFull, incl, 31);
          }
          if (sel) base += 2 * R[n + l] + y;
        }
        // 2 * pair mod 4 needs only pair's parity, summed per lane
        const int total = __reduce_add_sync(kFull, base + 2 * (int)pair);
        outcome = (total & 3) >> 1;
      }
      if (lane == 0) out[shot * M + m] = (unsigned char)outcome;
      __syncwarp();
    }
    copy_out(X, Z, R, x_out + shot * tw, z_out + shot * tw,
             r_out + shot * two_n, n, W, vec, lane, 32);
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Form 2: a block a shot, one barrier a random measurement
// ---------------------------------------------------------------------------

// Form 2's state besides the tableau, per block: the warps' candidate
// minima and phase sums (double-buffered by measurement parity), three
// list counters, the row flags F[2][2n] (each row's bit at a measured
// qubit), the target lists L[2][2n] (the rows with that bit), each
// double-buffered by parity, and the rowsums' phase sums mod 4, a byte a
// target.
struct Block2 {
  int* redmin;    // [2][kWarps2]
  int* redsum;    // [2][kWarps2]
  int* count;     // [3]
  unsigned char* flag;   // [2][2n]
  unsigned short* list;  // [2][2n]
  unsigned* gsum;        // [2n] bytes, packed four to a word
};

// Record, for the next measurement, whether rows ra and rb (each where
// its valid flag is set) have their bit there (ba, bb): their flags, and
// the rows that have it appended to the target list. One shared-memory
// atomic a warp places them; every lane calls it.
__device__ __forceinline__ void note_rows(const Block2& st, int buf, int S,
                                          int slot, int ra, bool va,
                                          bool ba, int rb, bool vb, bool bb,
                                          int lane) {
  if (va) st.flag[buf * S + ra] = (unsigned char)ba;
  if (vb) st.flag[buf * S + rb] = (unsigned char)bb;
  const unsigned ma = __ballot_sync(kFull, va && ba);
  const unsigned mb = __ballot_sync(kFull, vb && bb);
  if (!(ma | mb)) return;  // warp-uniform
  int base = 0;
  if (lane == 0) base = atomicAdd(st.count + slot, __popc(ma) + __popc(mb));
  base = __shfl_sync(kFull, base, 0);
  const unsigned lt = (1u << lane) - 1u;
  unsigned short* out = st.list + buf * S + base;
  if (va && ba) out[__popc(ma & lt)] = (unsigned short)ra;
  if (vb && bb) out[__popc(ma) + __popc(mb & lt)] = (unsigned short)rb;
}

__global__ void __launch_bounds__(kThreads2) chp_measure_block_kernel(
    const unsigned* __restrict__ x_in, const unsigned* __restrict__ z_in,
    const unsigned char* __restrict__ r_in, const int* __restrict__ qubits,
    const unsigned char* __restrict__ rand, long long B, int n, int W, int M,
    bool vec, unsigned* __restrict__ x_out, unsigned* __restrict__ z_out,
    unsigned char* __restrict__ r_out, unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) unsigned smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int two_n = 2 * n;
  const int S = two_n;
  const long long tw = (long long)two_n * W;
  const int KP = (n + kThreads2 - 1) / kThreads2;  // row pairs a thread
  // the deterministic product's chunks: thread (w, c) = (tid % W, tid / W)
  // takes word w of the rows [c * CL, (c + 1) * CL); their results, two
  // words a (chunk, word), sit in the unused target list
  const int C = min(kThreads2 / W, max(1, n / (2 * W)));
  const int CL = (n + C - 1) / C;
  Block2 st;
  st.redmin = reinterpret_cast<int*>(smem);
  st.redsum = st.redmin + 2 * kWarps2;
  st.count = st.redsum + 2 * kWarps2;
  unsigned* X = smem + header2_words();
  unsigned* Z = X + W * S;
  unsigned char* R = reinterpret_cast<unsigned char*>(Z + W * S);
  st.flag = reinterpret_cast<unsigned char*>(X + shot_words(n, W));
  st.list = reinterpret_cast<unsigned short*>(
      X + shot_words(n, W) + round_up4((4 * n + 3) / 4));
  st.gsum = X + shot_words(n, W) + round_up4((4 * n + 3) / 4) +
            round_up4((8 * n + 3) / 4);

  for (long long shot = blockIdx.x; shot < B; shot += gridDim.x) {
    copy_in(x_in + shot * tw, z_in + shot * tw, r_in + shot * two_n, X, Z, R,
            n, W, vec, tid, kThreads2);
    const long long next = shot + gridDim.x;
    if (next < B)
      prefetch_shot(x_in + next * tw, z_in + next * tw, r_in + next * two_n,
                    tw, two_n, tid, kThreads2);
    Window win;
    win.load(qubits, rand + shot * M, M, 0, lane);
    if (tid < 3) st.count[tid] = 0;
    for (int i = tid; i < (two_n + 3) / 4; i += kThreads2) st.gsum[i] = 0u;
    __syncthreads();
    // every row's bit at the first measured qubit: flags, list, pivot
    int p = INT_MAX;
    if (M > 0) {
      const int q0 = win.qubit(0);
      const int w0 = q0 >> 5;
      const unsigned b0 = 1u << (q0 & 31);
      int cand = INT_MAX;
      for (int k = 0; k < KP; ++k) {
        const int l = k * kThreads2 + tid;
        const bool in = l < n;
        const bool sb = in && (X[w0 * S + n + l] & b0);
        note_rows(st, 0, S, 0, l, in, in && (X[w0 * S + l] & b0), n + l, in,
                  sb, lane);
        if (sb) cand = min(cand, n + l);
      }
      cand = __reduce_min_sync(kFull, cand);
      if (lane == 0) st.redmin[warp] = cand;
      __syncthreads();
      for (int w = 0; w < kWarps2; ++w) p = min(p, st.redmin[w]);
    }
    for (int m = 0; m < M; ++m) {
      if (m && !(m & 31)) win.advance(qubits, rand + shot * M, M, m, lane);
      const int q = win.qubit(m);
      const int wq = q >> 5;
      const unsigned bq = 1u << (q & 31);
      const bool next = m + 1 < M;
      const int q1 = win.next_qubit(m);
      const int wq1 = q1 >> 5;
      const unsigned bq1 = next ? 1u << (q1 & 31) : 0u;
      const int cur = m & 1, nxt = cur ^ 1;  // flag and list buffers
      const int slot = (m + 1) % 3;          // the next list's counter
      const int ntargets = st.count[m % 3];
      if (tid == 0) st.count[(m + 2) % 3] = 0;  // read last in phase m - 1
      const int bit = win.bit(m);
      int cand = INT_MAX;
      if (p != INT_MAX) {  // random: two barriers
        const int pr = R[p];
        const int pl = p - n;  // the pivot's pair
        // phase A. The owners note the rows this measurement leaves as
        // they are (p - n takes the pivot row's bits, p has none left).
        for (int k = 0; k < KP; ++k) {
          const int l = k * kThreads2 + tid;
          const bool in = l < n;
          const bool ka = in && !st.flag[cur * S + l];
          const bool kb = in && l != pl && !st.flag[cur * S + n + l];
          const bool ba = in && (l == pl ? (X[wq1 * S + p] & bq1)
                                         : ka && (X[wq1 * S + l] & bq1));
          const bool sb = kb && (X[wq1 * S + n + l] & bq1);
          note_rows(st, nxt, S, slot, l, ka || l == pl, ba, n + l,
                    kb || l == pl, sb, lane);
          if (sb) cand = min(cand, n + l);
        }
        // The targets' rowsums, one (target, word) item a thread: the
        // words XORed in place, the phase sum mod 4 into the target's
        // byte, and the item of word wq1 notes the row's new bit.
        for (int e = tid; e < ntargets * W; e += kThreads2) {
          const int j = e / W;
          const int w = e - j * W;
          const int row = st.list[cur * S + j];
          if (row == p || row == pl) continue;
          unsigned x2 = X[w * S + row], z2 = Z[w * S + row];
          const int g = rowsum_word(X[w * S + p], Z[w * S + p], x2, z2);
          X[w * S + row] = x2;
          Z[w * S + row] = z2;
          atomicAdd(st.gsum + (j >> 2), (unsigned)(g & 3) << (8 * (j & 3)));
          if (w == wq1) {
            const bool nb = (x2 & bq1) != 0u;
            st.flag[nxt * S + row] = (unsigned char)nb;
            if (nb) {
              st.list[nxt * S + atomicAdd(st.count + slot, 1)] =
                  (unsigned short)row;
              if (row >= n) cand = min(cand, row);
            }
          }
        }
        cand = __reduce_min_sync(kFull, cand);
        if (lane == 0) st.redmin[nxt * kWarps2 + warp] = cand;
        __syncthreads();
        // phase B: the targets' signs, the pivot row to p - n and Z_q to p
        unsigned char* gb = reinterpret_cast<unsigned char*>(st.gsum);
        for (int j = tid; j < ntargets; j += kThreads2) {
          const int row = st.list[cur * S + j];
          if (row != p && row != pl)
            R[row] =
                (unsigned char)(((2 * R[row] + 2 * pr + gb[j]) & 3) >> 1);
          gb[j] = 0;  // for the next measurement's sums (after the barrier)
        }
        for (int w = tid; w < W; w += kThreads2) {
          X[w * S + pl] = X[w * S + p];
          Z[w * S + pl] = Z[w * S + p];
          X[w * S + p] = 0u;
          Z[w * S + p] = w == wq ? bq : 0u;
        }
        if (tid == 0) {
          R[pl] = (unsigned char)pr;
          R[p] = (unsigned char)bit;
          out[shot * M + m] = (unsigned char)bit;
        }
        __syncthreads();
      } else {
        // deterministic: the product of the stabilizers n + l whose
        // destabilizer l has bit q (flag set), in ascending l. Phase A:
        // thread (w, c) runs word w over chunk c: its rows' phase terms,
        // its exclusive XOR prefix of z and the pair parity within the
        // chunk; the chunk's XOR of z and of x for the combine. The owners
        // note every row's bit at the next qubit.
        int part = 0;
        unsigned* cz = reinterpret_cast<unsigned*>(st.list + cur * S);
        unsigned* cx = cz + C * W;
        if (tid < C * W) {
          const int w = tid % W;
          const int c = tid / W;
          unsigned pre = 0u, xacc = 0u, par = 0u;
          for (int l = c * CL; l < min(n, (c + 1) * CL); ++l) {
            if (!st.flag[cur * S + l]) continue;
            const unsigned xv = X[w * S + n + l], zv = Z[w * S + n + l];
            par ^= __popc(xv & pre) & 1u;
            pre ^= zv;
            xacc ^= xv;
            part += __popc(xv & zv) + (w == 0 ? 2 * R[n + l] : 0);
          }
          part += 2 * (int)par;
          cz[c * W + w] = pre;
          cx[c * W + w] = xacc;
        }
        for (int k = 0; k < KP; ++k) {
          const int l = k * kThreads2 + tid;
          const bool in = l < n;
          const bool sb = in && (X[wq1 * S + n + l] & bq1);
          note_rows(st, nxt, S, slot, l, in, in && (X[wq1 * S + l] & bq1),
                    n + l, in, sb, lane);
          if (sb) cand = min(cand, n + l);
        }
        __syncthreads();
        // phase B: word w's pairs across chunks (parity is linear: chunk c
        // adds popc(its x XOR & the z prefix of the chunks before it))
        if (tid < W) {
          unsigned pz = 0u, par = 0u;
          for (int c = 0; c < C; ++c) {
            par ^= __popc(cx[c * W + tid] & pz) & 1u;
            pz ^= cz[c * W + tid];
          }
          part += 2 * (int)par;
        }
        cand = __reduce_min_sync(kFull, cand);
        part = __reduce_add_sync(kFull, part);
        if (lane == 0) {
          st.redmin[nxt * kWarps2 + warp] = cand;
          st.redsum[nxt * kWarps2 + warp] = part;
        }
        __syncthreads();
        if (tid == 0) {
          int total = 0;
          for (int w = 0; w < kWarps2; ++w)
            total += st.redsum[nxt * kWarps2 + w];
          out[shot * M + m] = (unsigned char)((total & 3) >> 1);
        }
      }
      int np = INT_MAX;
      for (int w = 0; w < kWarps2; ++w)
        np = min(np, st.redmin[nxt * kWarps2 + w]);
      p = np;
    }
    __syncthreads();
    copy_out(X, Z, R, x_out + shot * tw, z_out + shot * tw,
             r_out + shot * two_n, n, W, vec, tid, kThreads2);
    __syncthreads();  // before the next shot's copy overwrites the tableau
  }
}

// ---------------------------------------------------------------------------
// Form 3: a block a shot in device memory (tableaus past 227 KB)
// ---------------------------------------------------------------------------

// Exclusive XOR prefix of v over the block's threads in thread order.
// Every thread must call it; blockDim.x is a multiple of 32.
__device__ __forceinline__ unsigned block_excl_xor_scan(unsigned v,
                                                        unsigned* totals) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned incl = warp_incl_xor(v, lane);
  if (lane == 31) totals[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned t = lane < nwarps ? totals[lane] : 0u;
    const unsigned s = warp_incl_xor(t, lane);
    if (lane < nwarps) totals[lane] = s ^ t;
  }
  __syncthreads();
  const unsigned r = incl ^ v ^ totals[warp];
  __syncthreads();
  return r;
}

// shared-memory words of form 3: block reductions (33 ints) at 0, the
// warp totals of the prefix scan (32 words) at kScanTotals, the staged
// pivot row at kHeaderWords
constexpr int kScanTotals = 40;
constexpr int kHeaderWords = 72;

__global__ void __launch_bounds__(kThreads3) chp_measure_global_kernel(
    const unsigned* __restrict__ x_in, const unsigned* __restrict__ z_in,
    const unsigned char* __restrict__ r_in, const int* __restrict__ qubits,
    const unsigned char* __restrict__ rand, int n, int W, int M,
    unsigned* x_out, unsigned* z_out, unsigned char* r_out,
    unsigned char* __restrict__ out) {
  extern __shared__ unsigned smem3[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int two_n = 2 * n;
  const int tw = two_n * W;
  const long long shot = blockIdx.x;
  int* red = reinterpret_cast<int*>(smem3);
  unsigned* totals = smem3 + kScanTotals;
  unsigned* px = smem3 + kHeaderWords;  // staged pivot row
  unsigned* pz = px + W;
  unsigned* X = x_out + shot * tw;
  unsigned* Z = z_out + shot * tw;
  unsigned char* R = r_out + shot * two_n;
  for (int i = tid; i < tw; i += T) {
    X[i] = x_in[shot * tw + i];
    Z[i] = z_in[shot * tw + i];
  }
  for (int i = tid; i < two_n; i += T) R[i] = r_in[shot * two_n + i];
  __syncthreads();

  // the deterministic branch's scan: thread tid owns stabilizer rows
  // n + [l0, l1), contiguous and in thread order
  const int chunk = (n + T - 1) / T;
  const int l0 = min(n, tid * chunk);
  const int l1 = min(n, l0 + chunk);

  for (int m = 0; m < M; ++m) {
    const int q = qubits[m];
    const int wq = q >> 5;
    const unsigned bq = 1u << (q & 31);
    int cand = INT_MAX;
    for (int i = n + tid; i < two_n; i += T) {
      if (X[i * W + wq] & bq) {
        cand = i;
        break;
      }
    }
    const int p = qcss::block_min(cand, red);
    int outcome;
    if (p != INT_MAX) {  // random outcome
      const int bit = rand[shot * M + m];
      for (int w = tid; w < W; w += T) {
        px[w] = X[p * W + w];
        pz[w] = Z[p * W + w];
      }
      if (tid == 0) red[0] = R[p];
      __syncthreads();
      const int pr = red[0];
      for (int i = tid; i < two_n; i += T) {
        unsigned* xi = X + i * W;
        unsigned* zi = Z + i * W;
        if (i == p - n) {
          for (int w = 0; w < W; ++w) {
            xi[w] = px[w];
            zi[w] = pz[w];
          }
          R[i] = (unsigned char)pr;
        } else if (i == p) {
          for (int w = 0; w < W; ++w) {
            xi[w] = 0u;
            zi[w] = w == wq ? bq : 0u;
          }
          R[i] = (unsigned char)bit;
        } else if (xi[wq] & bq) {
          int g = 0;
          for (int w = 0; w < W; ++w) {
            unsigned x2 = xi[w], z2 = zi[w];
            g += rowsum_word(px[w], pz[w], x2, z2);
            xi[w] = x2;
            zi[w] = z2;
          }
          R[i] = (unsigned char)(((2 * R[i] + 2 * pr + g) & 3) >> 1);
        }
      }
      outcome = bit;
      __syncthreads();
    } else {  // deterministic: stabilizer n + l selected by destabilizer l
      int base = 0;
      int pair = 0;
      for (int l = l0; l < l1; ++l) {
        if (X[l * W + wq] & bq) {
          const unsigned* xl = X + (n + l) * W;
          const unsigned* zl = Z + (n + l) * W;
          int y = 0;
          for (int w = 0; w < W; ++w) y += __popc(xl[w] & zl[w]);
          base += 2 * R[n + l] + y;
        }
      }
      for (int w = 0; w < W; ++w) {
        unsigned local = 0u;
        for (int l = l0; l < l1; ++l)
          if (X[l * W + wq] & bq) local ^= Z[(n + l) * W + w];
        unsigned run = block_excl_xor_scan(local, totals);
        for (int l = l0; l < l1; ++l) {
          if (X[l * W + wq] & bq) {
            pair += __popc(X[(n + l) * W + w] & run);
            run ^= Z[(n + l) * W + w];
          }
        }
      }
      // 2 * pair mod 4 needs only pair's parity, summed per thread
      const int total = qcss::block_sum(base + 2 * (pair & 1), red);
      outcome = (total & 3) >> 1;
    }
    if (tid == 0) out[shot * M + m] = (unsigned char)outcome;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// How K9 lays out a launch; shared by the launcher and the config query.
struct Plan {
  int form;   // 1: a warp a shot, 2: a block a shot in shared memory,
              // 3: a block a shot in device memory; 0: not taken
  int shots;  // shots a block at once
  int threads;
  long long smem;
};

// form: 0 chooses (W <= 4: form 1; else form 2 while the tableau fits in
// a block's shared memory; else form 3); 1-3 ask for one, which is not
// taken (form 0) where it cannot run. Form 2 needs n >= 2W: its
// deterministic product keeps 2 C W words (C >= 1 chunks) in a target
// list of n words.
Plan plan_k9(int n, int W, int form) {
  Plan p{0, 0, 0, 0};
  const long long smem2 = 4 * block2_words(n, W);
  const bool fits2 = smem2 <= kMaxSmem && n >= 2 * W;
  if (form == 0) form = W <= 4 ? 1 : fits2 ? 2 : 3;
  if (form == 1 && W <= 4) {
    p = {1, kWarps1, 32 * kWarps1, 4 * kWarps1 * warp1_words(n, W)};
  } else if (form == 2 && fits2) {
    p = {2, 1, kThreads2, smem2};
  } else if (form == 3) {
    const int threads =
        std::min(kThreads3, std::max(32, (2 * n + 31) / 32 * 32));
    p = {3, 1, threads, 4LL * (kHeaderWords + 2LL * W)};
  }
  return p;
}

qcss::Instance k9_instance(const Plan& p, int W) {
  if (p.form == 1) {
    switch (W) {
      case 1: return qcss::instance<chp_measure_warp_kernel<1>>();
      case 2: return qcss::instance<chp_measure_warp_kernel<2>>();
      case 3: return qcss::instance<chp_measure_warp_kernel<3>>();
      default: return qcss::instance<chp_measure_warp_kernel<4>>();
    }
  }
  if (p.form == 2) return qcss::instance<chp_measure_block_kernel>();
  return qcss::instance<chp_measure_global_kernel>();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The launch plan of K9 for n qubits at W words a row (form as for
// qcss_chp_measure): out[0] the form (1-3), out[1] shots a block at once,
// out[2] threads a block, out[3] dynamic shared memory a block, out[4] the
// blocks the card holds at once (the persistent grid's cap; form 3 launches
// a block a shot), out[5] registers a thread. Returns the CUDA error code
// (0 = success; cudaErrorInvalidValue where the form is not taken).
extern "C" int qcss_chp_measure_config(int n, int W, int form,
                                       long long* res) {
  if (n < 1 || W < (n + 31) / 32 || form < 0 || form > 3)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_k9(n, W, form);
  if (p.form == 0) return (int)cudaErrorInvalidValue;
  const qcss::Instance k = k9_instance(p, W);
  int blocks = 0, regs = 0;
  cudaError_t err = qcss::resident_blocks(k, p.threads, p.smem, &blocks);
  if (err == cudaSuccess) err = qcss::registers(k, &regs);
  if (err != cudaSuccess) return (int)err;
  const long long vals[] = {p.form, p.shots, p.threads, p.smem, blocks, regs};
  std::copy(vals, vals + 6, res);
  return 0;
}

// x, z [B, 2n, W] int32 words, r [B, 2n] uint8, qubits [M] int32 in
// [0, n), rand [B, M] uint8 -> x_out, z_out [B, 2n, W], r_out [B, 2n],
// out [B, M] uint8. form: 0 to let the plan choose, 1-3 to ask for one
// (timing); a form that cannot run these shapes is refused. Returns the
// CUDA error code of the launch (0 = success).
extern "C" int qcss_chp_measure(const int* x, const int* z,
                                const unsigned char* r, const int* qubits,
                                const unsigned char* rand, long long B,
                                int n, int W, int M, int form, int* x_out,
                                int* z_out, unsigned char* r_out,
                                unsigned char* out, void* stream) {
  if (n < 1 || W < (n + 31) / 32 || M < 0 || B < 0 || B > 0x7fffffffLL ||
      form < 0 || form > 3)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_k9(n, W, form);
  if (p.form == 0) return (int)cudaErrorInvalidValue;
  const qcss::Instance k = k9_instance(p, W);
  int blocks = 0;
  cudaError_t err = qcss::resident_blocks(k, p.threads, p.smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned* xu = reinterpret_cast<const unsigned*>(x);
  const unsigned* zu = reinterpret_cast<const unsigned*>(z);
  unsigned* xo = reinterpret_cast<unsigned*>(x_out);
  unsigned* zo = reinterpret_cast<unsigned*>(z_out);
  // 16-byte pieces where every shot's words start on a 16-byte boundary
  const bool vec = (2LL * n * W) % 4 == 0 && aligned16(x) && aligned16(z) &&
                   aligned16(x_out) && aligned16(z_out);
  if (p.form == 1) {
    const long long grid =
        std::min<long long>((B + kWarps1 - 1) / kWarps1, blocks);
    void* args[] = {&xu, &zu, &r, &qubits, &rand, &B, &n, &M, (void*)&vec,
                    &xo, &zo, &r_out, &out};
    err = cudaLaunchKernel(k.fn, dim3((unsigned)grid), dim3(p.threads), args,
                           (size_t)p.smem, s);
  } else if (p.form == 2) {
    const long long grid = std::min<long long>(B, blocks);
    void* args[] = {&xu, &zu, &r, &qubits, &rand, &B, &n, &W, &M,
                    (void*)&vec, &xo, &zo, &r_out, &out};
    err = cudaLaunchKernel(k.fn, dim3((unsigned)grid), dim3(p.threads), args,
                           (size_t)p.smem, s);
  } else {
    chp_measure_global_kernel<<<(unsigned)B, p.threads, p.smem, s>>>(
        xu, zu, r, qubits, rand, n, W, M, xo, zo, r_out, out);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
