// Scatter-accumulate of one block's worker payloads, for epilogue.cu's
// scatter_epilogue. (randk.cu's scatter_accum has its own warp-per-block walk.)
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// Accumulate the n·kb payload pairs of block b into acc[0..B) in the oracle's
// order (w = 0..n−1, then t = 0..kb−1). Lane 0 does every add, so duplicate
// offsets always add in the same order; no float atomics. Offsets outside
// [0, B) are dropped, as XLA's scatter drops them.
__device__ __forceinline__ void scatter_block(const float* __restrict__ vals,
                                              const int32_t* __restrict__ offs,
                                              float* acc, float* sv, int32_t* so,
                                              int n, int64_t nblk, int block,
                                              int kb, int64_t b) {
  const int m = n * kb;
  for (int j = threadIdx.x; j < block; j += blockDim.x) acc[j] = 0.0f;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int64_t src = ((int64_t)(i / kb) * nblk + b) * kb + (i % kb);
    sv[i] = vals[src];
    so[i] = offs[src];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < m; ++i) {
      const int o = so[i];
      if (o >= 0 && o < block) acc[o] = __fadd_rn(acc[o], sv[i]);
    }
  }
  __syncthreads();
}
