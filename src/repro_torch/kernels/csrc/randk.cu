// Seeded RandK uplink and server scatter-mean for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/randk.py::randk_seeded_workers,
// ::scatter_accum, ::randk_gather and ::randk_seeded. The TPU versions move
// irregular indices through the MXU as one-hot matmuls; here an indexed load
// (gather) and an indexed shared-memory add (scatter) take their place. (The
// one-hot matmul also turns a gathered −0 into +0 and spreads a ±inf or NaN
// anywhere in the block to every gathered value; the indexed load gathers
// exactly, as the reference's oracle does: ROADMAP C.)
//
// All are bound by device-memory bytes, not operations: a gather reads one
// value per sampled slot from a 4 KiB block (a 32-byte sector in practice) and
// writes a value and an offset, or reads the offset; the scatter reads n·kb
// payload pairs per block and writes one (B,) row. randk_gather and
// randk_seeded take x in f32 or bf16 and multiply in f32, rounding the
// product once to x's type, as the Pallas bodies do.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One thread per (b, t) of the host-supplied offsets: value = x[b, off]·scale,
// the product in f32 rounded once to x's type. An offset outside [0, B) reads
// nothing and gives NaN.
template <typename XT>
__global__ void randk_gather_kernel(const XT* __restrict__ x,
                                    const int32_t* __restrict__ offs,
                                    XT* __restrict__ vals, int64_t total, int block,
                                    int kb, float scale) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int32_t off = offs[i];
    const float v = (off >= 0 && off < block)
                        ? __fmul_rn(to_f32(x[(i / kb) * block + off]), scale)
                        : __int_as_float(0x7fc00000);
    store_as(vals + i, v);
  }
}

// One thread per (b, t) of one buffer under one seed: offset =
// murmur(seed, b·kb + t) & (B − 1) — the counter is the flat index i, wrapped
// to 32 bits as in the oracle — and value = x[b, offset]·scale as above.
template <typename XT>
__global__ void randk_seeded_kernel(const XT* __restrict__ x, uint32_t seed,
                                    XT* __restrict__ vals, int32_t* __restrict__ offs,
                                    int64_t total, int block, int kb, float scale) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const uint32_t off = murmur_bits(seed, (uint32_t)i) & (uint32_t)(block - 1);
    store_as(vals + i, __fmul_rn(to_f32(x[(i / kb) * block + off]), scale));
    offs[i] = (int32_t)off;
  }
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


template <typename XT>
static int launch_gather(const void* x, const void* offs, void* vals, long long nblk,
                         int block, int kb, float scale, void* stream) {
  const int64_t total = (int64_t)nblk * kb;
  randk_gather_kernel<XT><<<grid_for(total, 256), 256, 0, (cudaStream_t)stream>>>(
      (const XT*)x, (const int32_t*)offs, (XT*)vals, total, block, kb, scale);
  return (int)cudaGetLastError();
}

extern "C" int randk_gather_f32(const void* x, const void* offs, void* vals,
                                long long nblk, int block, int kb, float scale,
                                void* stream) {
  return launch_gather<float>(x, offs, vals, nblk, block, kb, scale, stream);
}

extern "C" int randk_gather_bf16(const void* x, const void* offs, void* vals,
                                 long long nblk, int block, int kb, float scale,
                                 void* stream) {
  return launch_gather<__nv_bfloat16>(x, offs, vals, nblk, block, kb, scale, stream);
}

template <typename XT>
static int launch_seeded(const void* x, uint32_t seed, void* vals, void* offs,
                         long long nblk, int block, int kb, float scale, void* stream) {
  const int64_t total = (int64_t)nblk * kb;
  randk_seeded_kernel<XT><<<grid_for(total, 256), 256, 0, (cudaStream_t)stream>>>(
      (const XT*)x, seed, (XT*)vals, (int32_t*)offs, total, block, kb, scale);
  return (int)cudaGetLastError();
}

extern "C" int randk_seeded_f32(const void* x, uint32_t seed, void* vals, void* offs,
                                long long nblk, int block, int kb, float scale,
                                void* stream) {
  return launch_seeded<float>(x, seed, vals, offs, nblk, block, kb, scale, stream);
}

extern "C" int randk_seeded_bf16(const void* x, uint32_t seed, void* vals, void* offs,
                                 long long nblk, int block, int kb, float scale,
                                 void* stream) {
  return launch_seeded<__nv_bfloat16>(x, seed, vals, offs, nblk, block, kb, scale,
                                      stream);
}
