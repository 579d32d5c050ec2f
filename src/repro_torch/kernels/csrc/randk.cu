// Seeded RandK uplink and server scatter-mean for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/randk.py::randk_seeded_workers
// and ::scatter_accum. The TPU versions move irregular indices through the MXU as
// one-hot matmuls; here an indexed load (gather) and an indexed shared-memory add
// (scatter) take their place.
//
// Both kernels are bound by device-memory bytes, not operations: the gather reads
// one f32 per sampled slot from a 4 KiB block and writes a value and an offset;
// the scatter reads n·kb payload pairs per block and writes one (B,) row.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "murmur.cuh"
#include "scatter.cuh"

// One thread per (w, b, t): offset = murmur(seed_w, b·kb + t) & (B − 1),
// value = x[w, b, offset] · scale, the multiply rounded once in f32.
__global__ void randk_seeded_workers_kernel(const float* __restrict__ x,
                                            const int32_t* __restrict__ seeds,
                                            float* __restrict__ vals,
                                            int32_t* __restrict__ offs,
                                            int64_t total, int64_t nblk,
                                            int block, int kb, float scale) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t t = i % kb;
    const int64_t wb = i / kb;  // w·nblk + b
    const int64_t b = wb % nblk;
    const int64_t w = wb / nblk;
    // seeds arrive as int32 and are reinterpreted, not converted
    const uint32_t seed = (uint32_t)seeds[w];
    const uint32_t ctr = (uint32_t)(b * kb + t);
    const uint32_t off = murmur_bits(seed, ctr) & (uint32_t)(block - 1);
    vals[i] = __fmul_rn(x[wb * block + off], scale);
    offs[i] = (int32_t)off;
  }
}

// One CTA per block b; acc (B f32) and the block's payloads in shared memory.
// out[b, j] = acc[j] / n, a true division.
__global__ void scatter_accum_kernel(const float* __restrict__ vals,
                                     const int32_t* __restrict__ offs,
                                     float* __restrict__ out, int n,
                                     int64_t nblk, int block, int kb) {
  extern __shared__ float smem[];
  float* acc = smem;
  float* sv = acc + block;
  int32_t* so = reinterpret_cast<int32_t*>(sv + n * kb);
  const int64_t b = blockIdx.x;
  scatter_block(vals, offs, acc, sv, so, n, nblk, block, kb, b);
  const float fn = (float)n;
  for (int j = threadIdx.x; j < block; j += blockDim.x)
    out[b * block + j] = __fdiv_rn(acc[j], fn);
}

static int grid_for(int64_t total, int threads) {
  int64_t g = (total + threads - 1) / threads;
  if (g > 1048576) g = 1048576;  // grid-stride loop covers the rest
  return (int)(g < 1 ? 1 : g);
}

extern "C" int randk_seeded_workers(const void* x, const void* seeds, void* vals,
                                    void* offs, int n, long long nblk, int block,
                                    int kb, float scale, void* stream) {
  const int64_t total = (int64_t)n * nblk * kb;
  const int threads = 256;
  randk_seeded_workers_kernel<<<grid_for(total, threads), threads, 0,
                                (cudaStream_t)stream>>>(
      (const float*)x, (const int32_t*)seeds, (float*)vals, (int32_t*)offs,
      total, nblk, block, kb, scale);
  return (int)cudaGetLastError();
}

extern "C" int scatter_accum(const void* vals, const void* offs, void* out, int n,
                             long long nblk, int block, int kb, void* stream) {
  const size_t smem = (size_t)block * sizeof(float) +
                      (size_t)n * kb * (sizeof(float) + sizeof(int32_t));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        scatter_accum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  scatter_accum_kernel<<<(unsigned)nblk, 128, smem, (cudaStream_t)stream>>>(
      (const float*)vals, (const int32_t*)offs, (float*)out, n, nblk, block, kb);
  return (int)cudaGetLastError();
}
