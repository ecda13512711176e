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
//   arithmetic is a few integer operations per (shot, row, word). The
//   small check matrix (and K8's LUT, when it fits) is staged in shared
//   memory once per block, so device memory sees just the packed inputs
//   and the outputs. The TPU kernels tiled the batch through VMEM
//   (B % tile_b == 0); here a grid of blocks masks its ragged last block,
//   so any B is taken.
//
// Design: stores coalesce along the batch.
//   K6: thread t owns (shot t / R, row t % R): consecutive threads write
//       consecutive bytes of the row-major [B, R] output.
//   K7: a thread owns 2-4 shots of the transposed [W, B] input, so reads
//       of E_T[w, b] and writes of S_T[rw, b] coalesce along b. Its bound
//       is the integer work (W LOP3s, a popcount and the bit's placement
//       per shot and row), so the shots' words are loaded into registers
//       once (template instances for W = 1..8; wider checks in chunks of
//       8 words) and each check row, a shared-memory broadcast, serves all
//       of the thread's shots: W loads a shot, not R*W.
//   K8: thread b owns shot b: its R syndrome bits form the big-endian
//       index (row 0 most significant, the reference's 1 << (R-1-r)
//       weights), and the LUT row is XORed into its error words.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// check rows and LUT words staged in shared memory up to this size;
// above it the kernels read them from device memory (through L1/L2)
constexpr int kSmemBytes = 48 * 1024;
// K7 keeps up to this many words of a shot in registers; wider checks
// run in chunks of it (the generic instance)
constexpr int kK7MaxWords = 8;

__device__ __forceinline__ unsigned row_parity(const unsigned* e,
                                               const unsigned* h, int W) {
  unsigned acc = 0;
  for (int w = 0; w < W; ++w) acc ^= e[w] & h[w];
  return __popc(acc) & 1u;
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

__global__ void syndromes_packed_kernel(const unsigned* __restrict__ e,
                                        const unsigned* __restrict__ h,
                                        long long B, int W, int R,
                                        bool h_in_smem,
                                        unsigned char* __restrict__ out) {
  extern __shared__ unsigned smem[];
  const unsigned* hs = stage(h, (long long)R * W, smem, h_in_smem);
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * R) return;
  const long long b = t / R;
  const int r = (int)(t - b * R);
  out[t] = (unsigned char)row_parity(e + b * W, hs + (long long)r * W, W);
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

__global__ void decode_residual_packed_kernel(
    const unsigned* __restrict__ e, const unsigned* __restrict__ h,
    const unsigned* __restrict__ lut, long long B, int W, int R,
    bool h_in_smem, bool lut_in_smem, unsigned* __restrict__ out) {
  extern __shared__ unsigned smem[];
  const unsigned* hs = stage(h, (long long)R * W, smem, h_in_smem);
  const long long h_words = h_in_smem ? (long long)R * W : 0;
  const unsigned* ls =
      stage(lut, ((long long)1 << R) * W, smem + h_words, lut_in_smem);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const unsigned* eb = e + b * W;
  unsigned idx = 0;
  for (int r = 0; r < R; ++r) idx = (idx << 1) | row_parity(eb, hs + r * W, W);
  const unsigned* corr = ls + (long long)idx * W;
  for (int w = 0; w < W; ++w) out[b * W + w] = eb[w] ^ corr[w];
}

inline int blocks_for(long long n) {
  return (int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// e [B, W], h [R, W] words -> out [B, R] uint8 syndrome bits.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int qcss_syndromes_packed(const int* e, const int* h, long long B,
                                     int W, int R, unsigned char* out,
                                     void* stream) {
  if (W < 1 || R < 1 || B < 0) return (int)cudaErrorInvalidValue;
  if (B * R >= (long long)kThreads * 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const long long hb = 4LL * R * W;
    const bool fits = hb <= kSmemBytes;
    syndromes_packed_kernel<<<blocks_for(B * R), kThreads, fits ? hb : 0,
                              (cudaStream_t)stream>>>(
        (const unsigned*)e, (const unsigned*)h, B, W, R, fits, out);
  }
  return (int)cudaGetLastError();
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
  if (B > 0) {
    const long long hb = 4LL * R * W;
    const long long lb = 4LL * W << R;
    const bool h_fits = hb <= kSmemBytes;
    const bool lut_fits = h_fits && hb + lb <= kSmemBytes;
    const long long smem = (h_fits ? hb : 0) + (lut_fits ? lb : 0);
    decode_residual_packed_kernel<<<blocks_for(B), kThreads, smem,
                                    (cudaStream_t)stream>>>(
        (const unsigned*)e, (const unsigned*)h, (const unsigned*)lut, B, W,
        R, h_fits, lut_fits, (unsigned*)out);
  }
  return (int)cudaGetLastError();
}
