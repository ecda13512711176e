// Bit-packed GF(2) kernels: syndrome extraction, its transposed
// packed-out form, and the fused syndrome -> LUT -> residual decode
// (CUDA C++, sm_90a).
//
// Replaces: qcss_tpu/ops/pallas_gf2.py syndromes_packed_pallas (K6),
//   syndromes_packed_pallas_t (K7) and decode_residual_packed_pallas (K8).
//   Plain versions: qcss_tpu_torch/ops/cuda_gf2.py *_plain; each kernel
//   returns the same words or bits, bit for bit.
//
// Words are 32-bit patterns in int32 storage (the port's packed words;
//   bit i of word w is column 32w+i) and are read as unsigned here, so a
//   word with bit 31 set behaves as the reference's uint32.
//
// What bounds them on this card: memory. Each shot reads W words and
//   writes R bytes (K6), ceil(R/32) words (K7) or W words (K8); the
//   arithmetic is a few integer operations per (shot, row, word), so K7
//   at d=11 is bound by those, K8 with many rows by its popcounts (16 a
//   clock per SM) and K6 with many rows also by its shared-memory
//   instructions (row loads and a byte store per shot and row). The TPU
//   kernels tiled the batch through VMEM (B % tile_b == 0); here any B is
//   taken and the ragged end is masked.
//
// Design of K6 and K8: persistent blocks, several shots a thread.
//   A launch has as many blocks as the card holds at once (the SM count
//   times the resident blocks an SM takes, read once per kernel instance
//   and cached). Each block stages the check rows (K8: and the LUT, up to
//   the 227 KB a block may opt in to) in shared memory once, then walks
//   tiles of the batch: tile t is shots [t*T, (t+1)*T), and thread i of
//   the block owns the groups i, i + lanes, ..., of G shots each, G the
//   fewest shots whose words fill whole 16-byte vectors (W = 1: 4, W = 2:
//   2, W = 3: 4, W = 4: 1). A group is loaded with 128-bit read-only
//   loads, so consecutive threads read consecutive vectors, and the next
//   tile's groups are loaded before the current tile is computed, which
//   keeps 32-48 bytes a thread in flight. Each check row is read once
//   per thread, a shared-memory broadcast, and serves all of the
//   thread's shots; K8 builds its big-endian index by shift-or, row 0
//   the most significant bit, and XORs the LUT row into the words.
//   K6 writes its [B, R] bytes through shared memory: a tile owns a
//   contiguous run of T*R output bytes, which the block copies out with
//   16-byte stores (no division by R per element); at R = 1 a thread
//   stores a group's G flags with one store.
//   Template instances for W = 1..4 take 16-byte aligned inputs and
//   outputs. Wider checks, and any input or output that is not 16-byte
//   aligned (a view such as words[1:]), take the generic instance: one
//   shot a thread, words read with 4-byte loads in chunks of kChunk
//   (parity is linear, so the chunks' partial parities XOR together).
//
// Design of K7: a thread owns 2-4 shots of the transposed [W, B] input,
//   so reads of E_T[w, b] and writes of S_T[rw, b] coalesce along b. Its
//   bound is the integer work (W LOP3s, a popcount and the bit's
//   placement per shot and row), so the shots' words are loaded into
//   registers once (template instances for W = 1..8; wider checks in
//   chunks of 8 words) and each check row, a shared-memory broadcast,
//   serves all of the thread's shots: W loads a shot, not R*W.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "residency.cuh"

namespace {

using qcss::Instance;
using qcss::instance;
using qcss::kMaxSmem;

constexpr int kThreads = 256;
// K7 stages its check rows in shared memory up to this size; above it it
// reads them from device memory (through L1/L2)
constexpr int kSmemBytes = 48 * 1024;
// K7 keeps up to this many words of a shot in registers; wider checks
// run in chunks of it (the generic instance)
constexpr int kK7MaxWords = 8;
// the generic instances of K6 and K8 hold this many words of a shot in
// registers at a time
constexpr int kChunk = 4;

// Shots of a group: the fewest whose kW words a shot fill whole 16-byte
// vectors (kW = 0, the generic instance: one shot).
__host__ __device__ constexpr int group_shots(int kW) {
  return kW == 0 ? 1 : kW % 4 == 0 ? 1 : kW % 2 == 0 ? 2 : 4;
}

// Groups a thread holds per tile: 32 bytes of words when a group has 16
// (W = 1, 2, 4), one group of 48 at W = 3, one shot in the generic form.
__host__ __device__ constexpr int groups_per_thread(int kW) {
  return kW == 0 || kW == 3 ? 1 : 2;
}

__host__ __device__ constexpr long long round_up4(long long n) {
  return (n + 3) / 4 * 4;
}

__device__ __forceinline__ unsigned parity(unsigned x) {
  return (unsigned)__popc(x) & 1u;
}

// The G*kW words of the group whose first shot is shot0; words of shots
// at or past B read as zero. A whole group takes 16-byte read-only loads
// (e 16-byte aligned; G*kW is a multiple of 4), a ragged one 4-byte loads.
template <int kW>
__device__ __forceinline__ void load_group(const unsigned* __restrict__ e,
                                           long long shot0, long long B,
                                           unsigned* w) {
  constexpr int N = group_shots(kW) * kW;
  const unsigned* p = e + shot0 * kW;
  if (shot0 + group_shots(kW) <= B) {
#pragma unroll
    for (int v = 0; v < N / 4; ++v) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + v);
      w[4 * v] = q.x;
      w[4 * v + 1] = q.y;
      w[4 * v + 2] = q.z;
      w[4 * v + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      w[i] = shot0 + i / kW < B ? __ldg(p + i) : 0u;
  }
}

// The group's kW words a shot to out, as load_group reads them.
template <int kW>
__device__ __forceinline__ void store_group(unsigned* __restrict__ out,
                                            long long shot0, long long B,
                                            const unsigned* w) {
  constexpr int N = group_shots(kW) * kW;
  unsigned* p = out + shot0 * kW;
  if (shot0 + group_shots(kW) <= B) {
#pragma unroll
    for (int v = 0; v < N / 4; ++v)
      reinterpret_cast<uint4*>(p)[v] =
          make_uint4(w[4 * v], w[4 * v + 1], w[4 * v + 2], w[4 * v + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (shot0 + i / kW < B) p[i] = w[i];
  }
}

// Copy n words to shared memory (all threads of the block).
__device__ __forceinline__ void copy_words(unsigned* dst,
                                           const unsigned* __restrict__ src,
                                           long long n) {
  for (long long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Copy a tile's n output bytes from shared memory (16-byte aligned) to
// dst: 16-byte stores when dst is aligned, then the ragged end in bytes.
__device__ __forceinline__ void copy_out(unsigned char* __restrict__ dst,
                                         const unsigned char* src,
                                         long long n) {
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const long long nv = n / 16;
    for (long long i = threadIdx.x; i < nv; i += blockDim.x)
      reinterpret_cast<uint4*>(dst)[i] =
          reinterpret_cast<const uint4*>(src)[i];
    done = nv * 16;
  }
  for (long long i = done + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
}

// K6, W = kW (1..4), 16-byte aligned e and out. Shared memory: the check
// rows (when h_in_smem), then the tile's [T, R] output bytes, T = lanes *
// S; threads at or past `lanes` only help with the copy out.
template <int kW>
__global__ void __launch_bounds__(kThreads)
syndromes_packed_kernel(const unsigned* __restrict__ e,
                        const unsigned* __restrict__ h, long long B, int R,
                        bool h_in_smem, int lanes,
                        unsigned char* __restrict__ out) {
  constexpr int G = group_shots(kW), NG = groups_per_thread(kW);
  constexpr int N = G * kW;
  extern __shared__ uint4 smem_v[];  // 16-byte aligned
  unsigned* smem = reinterpret_cast<unsigned*>(smem_v);
  const long long hw = h_in_smem ? round_up4((long long)R * kW) : 0;
  if (h_in_smem) copy_words(smem, h, (long long)R * kW);
  const unsigned* hs = h_in_smem ? smem : h;
  unsigned char* ts = reinterpret_cast<unsigned char*>(smem + hw);
  __syncthreads();
  const long long T = (long long)lanes * G * NG;
  const long long ntiles = (B + T - 1) / T;
  const int i = threadIdx.x;
  const bool mine = i < lanes;
  unsigned cur[NG][N], nxt[NG][N];
  long long tile = blockIdx.x;
  if (mine)
#pragma unroll
    for (int g = 0; g < NG; ++g)
      load_group<kW>(e, tile * T + ((long long)g * lanes + i) * G, B,
                     cur[g]);
  for (; tile < ntiles; tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (mine && next < ntiles)
#pragma unroll
      for (int g = 0; g < NG; ++g)
        load_group<kW>(e, next * T + ((long long)g * lanes + i) * G, B,
                       nxt[g]);
    if (R == 1) {
      // one flag a shot: a group's G flags go out in one store
      if (mine) {
        unsigned hv[kW];
#pragma unroll
        for (int w = 0; w < kW; ++w) hv[w] = hs[w];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const long long shot0 = tile * T + ((long long)g * lanes + i) * G;
          unsigned f = 0u;
#pragma unroll
          for (int s = 0; s < G; ++s) {
            unsigned acc = 0u;
#pragma unroll
            for (int w = 0; w < kW; ++w) acc ^= cur[g][s * kW + w] & hv[w];
            f |= parity(acc) << (8 * s);
          }
          if (shot0 + G <= B) {
            if (G == 4)
              *reinterpret_cast<unsigned*>(out + shot0) = f;
            else if (G == 2)
              *reinterpret_cast<unsigned short*>(out + shot0) =
                  (unsigned short)f;
            else
              out[shot0] = (unsigned char)f;
          } else {
#pragma unroll
            for (int s = 0; s < G; ++s)
              if (shot0 + s < B) out[shot0 + s] = (unsigned char)(f >> 8 * s);
          }
        }
      }
    } else {
      if (mine)
        for (int r = 0; r < R; ++r) {
          unsigned hv[kW];
#pragma unroll
          for (int w = 0; w < kW; ++w) hv[w] = hs[r * kW + w];
#pragma unroll
          for (int g = 0; g < NG; ++g)
#pragma unroll
            for (int s = 0; s < G; ++s) {
              unsigned acc = 0u;
#pragma unroll
              for (int w = 0; w < kW; ++w) acc ^= cur[g][s * kW + w] & hv[w];
              ts[(((long long)g * lanes + i) * G + s) * R + r] =
                  (unsigned char)parity(acc);
            }
        }
      __syncthreads();
      copy_out(out + tile * T * R, ts, (B - tile * T < T ? B - tile * T : T) * R);
      __syncthreads();
    }
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int w = 0; w < N; ++w) cur[g][w] = nxt[g][w];
  }
}

// K6, any W and alignment: one shot a thread (T = lanes), its words in
// chunks of kChunk; each chunk's partial parities are XORed into the
// tile's output bytes in shared memory.
__global__ void __launch_bounds__(kThreads)
syndromes_packed_generic_kernel(const unsigned* __restrict__ e,
                                const unsigned* __restrict__ h, long long B,
                                int W, int R, bool h_in_smem, int lanes,
                                unsigned char* __restrict__ out) {
  extern __shared__ uint4 smem_v[];  // 16-byte aligned
  unsigned* smem = reinterpret_cast<unsigned*>(smem_v);
  const long long hw = h_in_smem ? round_up4((long long)R * W) : 0;
  if (h_in_smem) copy_words(smem, h, (long long)R * W);
  const unsigned* hs = h_in_smem ? smem : h;
  unsigned char* ts = reinterpret_cast<unsigned char*>(smem + hw);
  __syncthreads();
  const long long T = lanes;
  const long long ntiles = (B + T - 1) / T;
  const int i = threadIdx.x;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long b = tile * T + i;
    if (i < lanes && b < B) {
      const unsigned* eb = e + b * W;
      unsigned char* tb = ts + (long long)i * R;
      for (int w0 = 0; w0 < W; w0 += kChunk) {
        unsigned ew[kChunk];
#pragma unroll
        for (int w = 0; w < kChunk; ++w)
          ew[w] = w0 + w < W ? __ldg(eb + w0 + w) : 0u;
        for (int r = 0; r < R; ++r) {
          unsigned acc = 0u;
#pragma unroll
          for (int w = 0; w < kChunk; ++w)
            if (w0 + w < W) acc ^= ew[w] & hs[(long long)r * W + w0 + w];
          const unsigned char bit = (unsigned char)parity(acc);
          tb[r] = w0 == 0 ? bit : (unsigned char)(tb[r] ^ bit);
        }
      }
    }
    __syncthreads();
    copy_out(out + tile * T * R, ts, (B - tile * T < T ? B - tile * T : T) * R);
    __syncthreads();
  }
}

// K8, W = kW (1..4), 16-byte aligned e and out. Shared memory: the check
// rows, then the LUT when lut_in_smem (else its rows are gathered from
// device memory through the read-only path).
template <int kW>
__global__ void __launch_bounds__(kThreads)
decode_residual_packed_kernel(const unsigned* __restrict__ e,
                              const unsigned* __restrict__ h,
                              const unsigned* __restrict__ lut, long long B,
                              int R, bool lut_in_smem,
                              unsigned* __restrict__ out) {
  constexpr int G = group_shots(kW), NG = groups_per_thread(kW);
  constexpr int N = G * kW;
  extern __shared__ uint4 smem_v[];  // 16-byte aligned
  unsigned* smem = reinterpret_cast<unsigned*>(smem_v);
  const long long hw = round_up4((long long)R * kW);
  copy_words(smem, h, (long long)R * kW);
  if (lut_in_smem) copy_words(smem + hw, lut, (long long)kW << R);
  const unsigned* ls = smem + hw;
  __syncthreads();
  const long long T = (long long)kThreads * G * NG;
  const long long ntiles = (B + T - 1) / T;
  const int i = threadIdx.x;
  unsigned cur[NG][N], nxt[NG][N];
  long long tile = blockIdx.x;
#pragma unroll
  for (int g = 0; g < NG; ++g)
    load_group<kW>(e, tile * T + ((long long)g * kThreads + i) * G, B,
                   cur[g]);
  for (; tile < ntiles; tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < ntiles)
#pragma unroll
      for (int g = 0; g < NG; ++g)
        load_group<kW>(e, next * T + ((long long)g * kThreads + i) * G, B,
                       nxt[g]);
    unsigned idx[NG][G];
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int s = 0; s < G; ++s) idx[g][s] = 0u;
    for (int r = 0; r < R; ++r) {
      unsigned hv[kW];
#pragma unroll
      for (int w = 0; w < kW; ++w) hv[w] = smem[r * kW + w];
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int s = 0; s < G; ++s) {
          unsigned acc = 0u;
#pragma unroll
          for (int w = 0; w < kW; ++w) acc ^= cur[g][s * kW + w] & hv[w];
          idx[g][s] = (idx[g][s] << 1) | parity(acc);
        }
    }
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      unsigned res[N];
#pragma unroll
      for (int s = 0; s < G; ++s) {
        const long long row = (long long)idx[g][s] * kW;
#pragma unroll
        for (int w = 0; w < kW; ++w)
          res[s * kW + w] = cur[g][s * kW + w] ^
                            (lut_in_smem ? ls[row + w] : __ldg(lut + row + w));
      }
      store_group<kW>(out, tile * T + ((long long)g * kThreads + i) * G, B,
                      res);
    }
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int w = 0; w < N; ++w) cur[g][w] = nxt[g][w];
  }
}

// K8, any W and alignment: one shot a thread, its words in chunks of
// kChunk; the index bits of each chunk are XORed into the index.
__global__ void __launch_bounds__(kThreads)
decode_residual_packed_generic_kernel(const unsigned* __restrict__ e,
                                      const unsigned* __restrict__ h,
                                      const unsigned* __restrict__ lut,
                                      long long B, int W, int R,
                                      bool h_in_smem, bool lut_in_smem,
                                      unsigned* __restrict__ out) {
  extern __shared__ uint4 smem_v[];  // 16-byte aligned
  unsigned* smem = reinterpret_cast<unsigned*>(smem_v);
  const long long hw = h_in_smem ? round_up4((long long)R * W) : 0;
  if (h_in_smem) copy_words(smem, h, (long long)R * W);
  if (lut_in_smem) copy_words(smem + hw, lut, (long long)W << R);
  const unsigned* hs = h_in_smem ? smem : h;
  const unsigned* ls = lut_in_smem ? smem + hw : lut;
  __syncthreads();
  const long long ntiles = (B + kThreads - 1) / kThreads;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long b = tile * kThreads + threadIdx.x;
    if (b >= B) continue;
    const unsigned* eb = e + b * W;
    unsigned idx = 0u;
    unsigned ew[kChunk];
    for (int w0 = 0; w0 < W; w0 += kChunk) {
#pragma unroll
      for (int w = 0; w < kChunk; ++w)
        ew[w] = w0 + w < W ? __ldg(eb + w0 + w) : 0u;
      for (int r = 0; r < R; ++r) {
        unsigned acc = 0u;
#pragma unroll
        for (int w = 0; w < kChunk; ++w)
          if (w0 + w < W) acc ^= ew[w] & hs[(long long)r * W + w0 + w];
        idx ^= parity(acc) << (R - 1 - r);
      }
    }
    // a shot of at most kChunk words is still in registers; a wider one
    // is read again (from L1) for its residual
    const unsigned* corr = ls + (long long)idx * W;
    if (W <= kChunk) {
#pragma unroll
      for (int w = 0; w < kChunk; ++w)
        if (w < W) out[b * W + w] = ew[w] ^ corr[w];
    } else {
      for (int w = 0; w < W; ++w) out[b * W + w] = __ldg(eb + w) ^ corr[w];
    }
  }
}

// Copy n words to shared memory if they fit; returns the pointer to read.
__device__ __forceinline__ const unsigned* stage(const unsigned* src,
                                                 long long n,
                                                 unsigned* smem, bool fits) {
  if (!fits) return src;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) smem[i] = src[i];
  __syncthreads();
  return smem;
}

// K7. Thread t of a block owns kShots shots, b = base + j * blockDim.x +
// t (j < kShots), so loads of E_T[w, b] and stores of S_T[rw, b] coalesce
// along b. The shots' words sit in registers: kWC words a shot, read once
// when W <= kWC, else once per (output word, chunk of kWC words). Each
// check row is read once per thread, from shared memory as a broadcast,
// and serves all kShots shots; the 32 rows of an output word are unrolled.
// Rows past R and words past W read as zero, so their parity bits are 0.
template <int kWC, int kShots>
__global__ void __launch_bounds__(kThreads)
syndromes_packed_t_kernel(const unsigned* __restrict__ e_t,
                          const unsigned* __restrict__ h, long long B,
                          int W, int R, bool h_in_smem,
                          unsigned* __restrict__ out) {
  extern __shared__ unsigned smem[];
  const unsigned* hs = stage(h, (long long)R * W, smem, h_in_smem);
  const long long base =
      (long long)blockIdx.x * blockDim.x * kShots + threadIdx.x;
  long long b[kShots];
  bool ok[kShots];
#pragma unroll
  for (int j = 0; j < kShots; ++j) {
    b[j] = base + (long long)j * blockDim.x;
    ok[j] = b[j] < B;
  }
  const int WR = (R + 31) / 32;
  unsigned e[kShots][kWC];
  for (int rw = 0; rw < WR; ++rw) {
    // parity is linear, so the chunks' partial parities XOR together
    unsigned packed[kShots];
#pragma unroll
    for (int j = 0; j < kShots; ++j) packed[j] = 0u;
    for (int w0 = 0; w0 < W; w0 += kWC) {
      if (rw == 0 || W > kWC) {
#pragma unroll
        for (int j = 0; j < kShots; ++j)
#pragma unroll
          for (int w = 0; w < kWC; ++w)
            e[j][w] = (ok[j] && w0 + w < W)
                          ? e_t[(long long)(w0 + w) * B + b[j]]
                          : 0u;
      }
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int row = 32 * rw + r;
        unsigned hv[kWC];
#pragma unroll
        for (int w = 0; w < kWC; ++w)
          hv[w] = (row < R && w0 + w < W) ? hs[row * W + w0 + w] : 0u;
#pragma unroll
        for (int j = 0; j < kShots; ++j) {
          unsigned acc = 0u;
#pragma unroll
          for (int w = 0; w < kWC; ++w) acc ^= e[j][w] & hv[w];
          packed[j] ^= ((unsigned)__popc(acc) & 1u) << r;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kShots; ++j)
      if (ok[j]) out[(long long)rw * B + b[j]] = packed[j];
  }
}


inline int blocks_for(long long n) {
  return (int)((n + kThreads - 1) / kThreads);
}

// How K6 or K8 lays out a launch; shared by the launchers and the config
// query. words: the instance (W for 16-byte aligned inputs with W <= 4,
// else 0, the generic one); shots a thread a tile; lanes: the threads of
// a block that own shots (0: one shot's output does not fit).
struct Plan {
  int words;
  int shots;
  int lanes;
  bool h_in_smem;
  bool lut_in_smem;
  long long smem;
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int instance_words(int W, const void* e, const void* out) {
  return W <= 4 && aligned16(e) && aligned16(out) ? W : 0;
}

// K6: the check rows in shared memory if they take at most half of it;
// the rest holds the tile's output bytes, up to kThreads lanes (a whole
// number of warps when there are more than 32).
Plan plan_k6(int W, int R, const void* e, const void* out) {
  Plan p{};
  p.words = instance_words(W, e, out);
  p.shots = group_shots(p.words) * groups_per_thread(p.words);
  const long long hb = 4 * round_up4((long long)R * W);
  p.h_in_smem = hb <= kMaxSmem / 2;
  const long long room = kMaxSmem - (p.h_in_smem ? hb : 0);
  long long lanes =
      std::min<long long>(kThreads, room / ((long long)p.shots * R));
  if (lanes >= 32) lanes -= lanes % 32;
  p.lanes = (int)lanes;
  p.smem = (p.h_in_smem ? hb : 0) + lanes * p.shots * R;
  return p;
}

// K8: the check rows, then the LUT, in shared memory while they fit.
Plan plan_k8(int W, int R, const void* e, const void* out) {
  Plan p{};
  p.words = instance_words(W, e, out);
  p.shots = group_shots(p.words) * groups_per_thread(p.words);
  p.lanes = kThreads;
  const long long hb = 4 * round_up4((long long)R * W);
  const long long lb = 4LL * W << R;
  p.h_in_smem = hb <= kMaxSmem / 2;  // always at W <= 4 (R <= 30)
  p.lut_in_smem = p.h_in_smem && hb + lb <= kMaxSmem;
  p.smem = (p.h_in_smem ? hb : 0) + (p.lut_in_smem ? lb : 0);
  return p;
}

Instance k6_instance(int words) {
  switch (words) {
    case 1: return instance<syndromes_packed_kernel<1>>();
    case 2: return instance<syndromes_packed_kernel<2>>();
    case 3: return instance<syndromes_packed_kernel<3>>();
    case 4: return instance<syndromes_packed_kernel<4>>();
    default: return instance<syndromes_packed_generic_kernel>();
  }
}

Instance k8_instance(int words) {
  switch (words) {
    case 1: return instance<decode_residual_packed_kernel<1>>();
    case 2: return instance<decode_residual_packed_kernel<2>>();
    case 3: return instance<decode_residual_packed_kernel<3>>();
    case 4: return instance<decode_residual_packed_kernel<4>>();
    default: return instance<decode_residual_packed_generic_kernel>();
  }
}

// Launch k over ntiles tiles with the persistent grid.
cudaError_t launch(Instance k, const Plan& p, long long ntiles, void** args,
                   void* stream) {
  int blocks = 0;
  cudaError_t err = qcss::resident_blocks(k, kThreads, p.smem, &blocks);
  if (err != cudaSuccess) return err;
  const int grid = (int)std::min<long long>(ntiles, blocks);
  err = cudaLaunchKernel(k.fn, dim3(grid), dim3(kThreads), args,
                         (size_t)p.smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The launch plan of K6 (kernel = 6) or K8 (kernel = 8) for inputs e and
// output out at widths W and R: out[0] the instance (W, or 0 for the
// generic one), out[1] shots a thread a tile, out[2] lanes (threads that
// own shots), out[3] shots a tile, out[4] dynamic shared memory a block,
// out[5] 1 if the check rows are staged, out[6] 1 if the LUT is (K8),
// out[7] the blocks the card holds at once (the persistent grid's cap),
// out[8] registers a thread. Returns the CUDA error code (0 = success).
extern "C" int qcss_gf2_packed_config(int kernel, int W, int R,
                                      const void* e, const void* out,
                                      long long* res) {
  if ((kernel != 6 && kernel != 8) || W < 1 || R < 1 ||
      (kernel == 8 && R > 30))
    return (int)cudaErrorInvalidValue;
  const Plan p = kernel == 6 ? plan_k6(W, R, e, out) : plan_k8(W, R, e, out);
  if (p.lanes < 1) return (int)cudaErrorInvalidValue;
  const Instance k = kernel == 6 ? k6_instance(p.words) : k8_instance(p.words);
  int blocks = 0;
  cudaError_t err = qcss::resident_blocks(k, kThreads, p.smem, &blocks);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, k.fn)) != cudaSuccess)
    return (int)err;
  const long long vals[] = {p.words, p.shots, p.lanes,
                            (long long)p.lanes * p.shots, p.smem,
                            p.h_in_smem, p.lut_in_smem, blocks,
                            attr.numRegs};
  std::copy(vals, vals + 9, res);
  return 0;
}

// e [B, W], h [R, W] words -> out [B, R] uint8 syndrome bits.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int qcss_syndromes_packed(const int* e, const int* h, long long B,
                                     int W, int R, unsigned char* out,
                                     void* stream) {
  if (W < 1 || R < 1 || B < 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan_k6(W, R, e, out);
  if (p.lanes < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  const long long T = (long long)p.lanes * p.shots;
  const unsigned* eu = reinterpret_cast<const unsigned*>(e);
  const unsigned* hu = reinterpret_cast<const unsigned*>(h);
  bool h_in_smem = p.h_in_smem;
  int lanes = p.lanes;
  void* fixed[] = {&eu, &hu, &B, &R, &h_in_smem, &lanes, &out};
  void* generic[] = {&eu, &hu, &B, &W, &R, &h_in_smem, &lanes, &out};
  return (int)launch(k6_instance(p.words), p, (B + T - 1) / T,
                     p.words ? fixed : generic, stream);
}

// e_t [W, B], h [R, W] words -> out [ceil(R/32), B] words, syndrome bit r
// of shot b at bit r % 32 of out[r / 32, b].
extern "C" int qcss_syndromes_packed_t(const int* e_t, const int* h,
                                       long long B, int W, int R, int* out,
                                       void* stream) {
  if (W < 1 || R < 1 || B < 0) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const long long hb = 4LL * R * W;
    const bool fits = hb <= kSmemBytes;
    const size_t smem = fits ? (size_t)hb : 0;
    const cudaStream_t s = (cudaStream_t)stream;
    const unsigned* et = (const unsigned*)e_t;
    const unsigned* hw = (const unsigned*)h;
    unsigned* o = (unsigned*)out;
    // kShots shots a thread: 4 while a shot's words are few, else 2
#define QCSS_K7(WC, SHOTS)                                                 \
  syndromes_packed_t_kernel<WC, SHOTS>                                     \
      <<<blocks_for((B + SHOTS - 1) / SHOTS), kThreads, smem, s>>>(        \
          et, hw, B, W, R, fits, o)
    switch (W) {
      case 1: QCSS_K7(1, 4); break;
      case 2: QCSS_K7(2, 4); break;
      case 3: QCSS_K7(3, 4); break;
      case 4: QCSS_K7(4, 4); break;
      case 5: QCSS_K7(5, 2); break;
      case 6: QCSS_K7(6, 2); break;
      case 7: QCSS_K7(7, 2); break;
      case 8: QCSS_K7(8, 2); break;
      default: QCSS_K7(kK7MaxWords, 2); break;  // chunks of 8 words
    }
#undef QCSS_K7
  }
  return (int)cudaGetLastError();
}

// e [B, W], h [R, W], lut [2^R, W] words -> out [B, W] = e ^ lut[index],
// index the big-endian syndrome (R <= 30).
extern "C" int qcss_decode_residual_packed(const int* e, const int* h,
                                           const int* lut, long long B,
                                           int W, int R, int* out,
                                           void* stream) {
  if (W < 1 || R < 1 || R > 30 || B < 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan_k8(W, R, e, out);
  if (B == 0) return (int)cudaGetLastError();
  const long long T = (long long)p.lanes * p.shots;
  const unsigned* eu = reinterpret_cast<const unsigned*>(e);
  const unsigned* hu = reinterpret_cast<const unsigned*>(h);
  const unsigned* lu = reinterpret_cast<const unsigned*>(lut);
  unsigned* ou = reinterpret_cast<unsigned*>(out);
  bool h_in_smem = p.h_in_smem, lut_in_smem = p.lut_in_smem;
  void* fixed[] = {&eu, &hu, &lu, &B, &R, &lut_in_smem, &ou};
  void* generic[] = {&eu, &hu, &lu, &B, &W, &R, &h_in_smem, &lut_in_smem,
                     &ou};
  return (int)launch(k8_instance(p.words), p, (B + T - 1) / T,
                     p.words ? fixed : generic, stream);
}
