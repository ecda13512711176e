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
// What bounds it on this card: integer operations. Each random-branch
//   measurement does a W-word rowsum (bit-sliced phase, two popcounts)
//   on every row that anticommutes with Z_q; each deterministic one a
//   W-word prefix-XOR scan and popcounts over the selected stabilizer
//   rows. The tableau itself crosses device memory once each way.
//
// Design: one block per shot, threads over the 2n rows. The shot's x, z
//   and r stay in shared memory for all M measurements (16 n W + 2n
//   bytes: 70 KB at n = 363), so device memory sees one round trip per
//   block measurement, as the TPU kernel's VMEM tile did. Where a shot's
//   tableau does not fit in shared memory (n above about 670), the same
//   kernel works in place on its output buffers in device memory
//   (in_smem = 0); the wrapper chooses the form by size. Per measured
//   qubit q:
//   * pivot: the first (lowest-index) stabilizer row with bit q set, by a
//     block minimum — the scan's argmax tie-break;
//   * the branch is uniform per block, so only the taken branch runs;
//   * random: the pivot row is staged in shared memory; every other
//     anticommuting row does the rowsum with g = popc(plus) - popc(minus)
//     and r = ((2r + 2pr + g) & 3) >> 1 (& 3 is the floor mod 4 of the
//     reference's %, as g may be negative); destabilizer p - n takes the
//     old pivot row and the pivot row becomes Z_q with the shot's bit;
//   * deterministic: per word, an exclusive prefix XOR of the selected
//     stabilizer rows' z words (block scan over contiguous row chunks),
//     pair = sum popc(x & prefix) & 1, base = sum (2r + popc(x & z)), and
//     the outcome ((base + 2 pair) & 3) >> 1.
//   The TPU kernel's lane transpose, one-hot selects, roll-based prefix
//   and compute-both-branches have no counterpart; any B is taken.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

#include "block_reduce.cuh"

namespace {

constexpr int kMaxThreads = 256;
// shared-memory header in words: block reductions (33 ints) at 0, the
// warp totals of the prefix scan (32 words) at kScanTotals
constexpr int kScanTotals = 40;
constexpr int kHeaderWords = 72;

// Exclusive XOR prefix of v over the block's threads in thread order.
// Every thread must call it; blockDim.x is a multiple of 32.
__device__ __forceinline__ unsigned block_excl_xor_scan(unsigned v,
                                                        unsigned* totals) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl ^= t;
  }
  if (lane == 31) totals[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned t = lane < nwarps ? totals[lane] : 0u;
    unsigned s = t;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned u = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s ^= u;
    }
    if (lane < nwarps) totals[lane] = s ^ t;
  }
  __syncthreads();
  const unsigned r = incl ^ v ^ totals[warp];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kMaxThreads) chp_measure_kernel(
    const unsigned* __restrict__ x_in, const unsigned* __restrict__ z_in,
    const unsigned char* __restrict__ r_in, const int* __restrict__ qubits,
    const unsigned char* __restrict__ rand, int n, int W, int M,
    int in_smem, unsigned* x_out, unsigned* z_out, unsigned char* r_out,
    unsigned char* __restrict__ out) {
  extern __shared__ unsigned smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int two_n = 2 * n;
  const int tw = two_n * W;
  const long long shot = blockIdx.x;
  int* red = reinterpret_cast<int*>(smem);
  unsigned* totals = smem + kScanTotals;
  unsigned* px = smem + kHeaderWords;  // staged pivot row
  unsigned* pz = px + W;
  unsigned* X;
  unsigned* Z;
  unsigned char* R;
  if (in_smem) {
    X = pz + W;
    Z = X + tw;
    R = reinterpret_cast<unsigned char*>(Z + tw);
  } else {
    X = x_out + shot * tw;
    Z = z_out + shot * tw;
    R = r_out + shot * two_n;
  }
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
            const unsigned x1 = px[w], z1 = pz[w], x2 = xi[w], z2 = zi[w];
            const unsigned plus = (x1 & z1 & z2 & ~x2) |
                                  (x1 & ~z1 & x2 & z2) |
                                  (~x1 & z1 & x2 & ~z2);
            const unsigned minus = (x1 & z1 & x2 & ~z2) |
                                   (x1 & ~z1 & ~x2 & z2) |
                                   (~x1 & z1 & x2 & z2);
            g += __popc(plus) - __popc(minus);
            xi[w] = x2 ^ x1;
            zi[w] = z2 ^ z1;
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

  if (in_smem) {
    __syncthreads();
    for (int i = tid; i < tw; i += T) {
      x_out[shot * tw + i] = X[i];
      z_out[shot * tw + i] = Z[i];
    }
    for (int i = tid; i < two_n; i += T) r_out[shot * two_n + i] = R[i];
  }
}

}  // namespace

// Dynamic shared memory, in bytes, of one block: the header and the
// staged pivot row, plus the shot's tableau when it is held there.
extern "C" long long qcss_chp_measure_smem(int n, int W, int in_smem) {
  long long bytes = 4LL * (kHeaderWords + 2LL * W);
  if (in_smem) bytes += 4LL * 2 * (2LL * n * W) + 2LL * n;
  return bytes;
}

// x, z [B, 2n, W] int32 words, r [B, 2n] uint8, qubits [M] int32 in
// [0, n), rand [B, M] uint8 -> x_out, z_out [B, 2n, W], r_out [B, 2n],
// out [B, M] uint8. in_smem: hold each shot's tableau in shared memory
// (1) or work in place on x_out, z_out, r_out (0). Returns the CUDA error
// code of the launch (0 = success).
extern "C" int qcss_chp_measure(const int* x, const int* z,
                                const unsigned char* r, const int* qubits,
                                const unsigned char* rand, long long B,
                                int n, int W, int M, int in_smem, int* x_out,
                                int* z_out, unsigned char* r_out,
                                unsigned char* out, void* stream) {
  if (n < 1 || W < (n + 31) / 32 || M < 0 || B < 0 || B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)qcss_chp_measure_smem(n, W, in_smem);
  const cudaError_t err = cudaFuncSetAttribute(
      chp_measure_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (B > 0) {
    const int threads =
        std::min(kMaxThreads, std::max(32, (2 * n + 31) / 32 * 32));
    chp_measure_kernel<<<(unsigned)B, threads, smem, (cudaStream_t)stream>>>(
        (const unsigned*)x, (const unsigned*)z, r, qubits, rand, n, W, M,
        in_smem, (unsigned*)x_out, (unsigned*)z_out, r_out, out);
  }
  return (int)cudaGetLastError();
}
