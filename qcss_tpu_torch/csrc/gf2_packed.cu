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
// Design: one thread per output element with coalesced stores.
//   K6: thread t owns (shot t / R, row t % R): consecutive threads write
//       consecutive bytes of the row-major [B, R] output.
//   K7: thread b owns shot b of the transposed [W, B] input, so reads of
//       E_T[w, b] and writes of S_T[rw, b] coalesce along b.
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

__global__ void syndromes_packed_t_kernel(const unsigned* __restrict__ e_t,
                                          const unsigned* __restrict__ h,
                                          long long B, int W, int R,
                                          bool h_in_smem,
                                          unsigned* __restrict__ out) {
  extern __shared__ unsigned smem[];
  const unsigned* hs = stage(h, (long long)R * W, smem, h_in_smem);
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int WR = (R + 31) / 32;
  for (int rw = 0; rw < WR; ++rw) {
    unsigned packed = 0;
    const int r_end = min(R, 32 * (rw + 1));
    for (int r = 32 * rw; r < r_end; ++r) {
      unsigned acc = 0;
      for (int w = 0; w < W; ++w) acc ^= e_t[(long long)w * B + b] & hs[r * W + w];
      packed |= (__popc(acc) & 1u) << (r - 32 * rw);
    }
    out[(long long)rw * B + b] = packed;
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
    syndromes_packed_t_kernel<<<blocks_for(B), kThreads, fits ? hb : 0,
                                (cudaStream_t)stream>>>(
        (const unsigned*)e_t, (const unsigned*)h, B, W, R, fits,
        (unsigned*)out);
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
