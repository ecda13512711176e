// Block-wide reductions shared by the kernels in this directory.
#pragma once

#include <cuda_runtime.h>

namespace qcss {

// Minimum of v over the block. Every thread of the block must call it;
// blockDim.x is a multiple of 32, at most 1024. scratch holds 33 ints
// of shared memory; it may be reused as soon as the call returns.
__device__ __forceinline__ int block_min(int v, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = __reduce_min_sync(0xffffffffu, v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? scratch[lane] : 0x7fffffff;
    w = __reduce_min_sync(0xffffffffu, w);
    if (lane == 0) scratch[32] = w;
  }
  __syncthreads();
  const int r = scratch[32];
  __syncthreads();
  return r;
}

// Sum of v over the block; the same contract as block_min.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = __reduce_add_sync(0xffffffffu, v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)(blockDim.x >> 5) ? scratch[lane] : 0;
    w = __reduce_add_sync(0xffffffffu, w);
    if (lane == 0) scratch[32] = w;
  }
  __syncthreads();
  const int r = scratch[32];
  __syncthreads();
  return r;
}

}  // namespace qcss
