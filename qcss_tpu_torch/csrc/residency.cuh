// What a persistent launch needs to know of the card, shared by the
// kernels in this directory that size their grid to the blocks the card
// holds at once (K2, K6, K8, K9).
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace qcss {

// the most dynamic shared memory one block may opt in to (227 KB)
constexpr long long kMaxSmem = 232448;

// A kernel instance and what its persistent launch needs to know of the
// card: the SM count and the resident blocks an SM takes at the last
// shared-memory size asked for. Read once per instance (and again when
// the device or the size changes), so a launch makes no query.
struct Residency {
  std::mutex m;
  int device = -1;
  int sms = 0;
  long long smem = -1;
  int per_sm = 0;
};

struct Instance {
  const void* fn;
  Residency* res;
};

// One Residency per kernel instance (per translation unit).
template <auto K>
Instance instance() {
  static Residency r;
  return {reinterpret_cast<const void*>(K), &r};
}

// Blocks of instance k the card holds at once, with `threads` threads and
// smem bytes of dynamic shared memory a block. Opts the instance in to
// kMaxSmem on first use.
inline cudaError_t resident_blocks(Instance k, int threads, long long smem,
                                   int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Residency& c = *k.res;
  std::lock_guard<std::mutex> lock(c.m);
  if (c.device != dev) {
    err = cudaFuncSetAttribute(
        k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    c.device = dev;
    c.smem = -1;
  }
  if (c.smem != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm, k.fn,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    c.smem = smem;
  }
  *blocks = c.sms * c.per_sm;
  return c.per_sm > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// Registers a thread of instance k uses.
inline cudaError_t registers(Instance k, int* regs) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, k.fn);
  if (err == cudaSuccess) *regs = attr.numRegs;
  return err;
}

}  // namespace qcss
