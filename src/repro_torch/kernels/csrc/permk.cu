// PermK uplink for Hopper (sm_90a): one shared seeded permutation partitions
// every block's B coordinates across the n workers.
//
// Replaces the Pallas TPU kernel src/repro/kernels/permk.py::permk_seeded_workers.
// The TPU version runs one grid step per (worker, block) and gathers through a
// one-hot MXU matmul. Here one CTA serves block b for all n workers, since the
// affine bijection π_b(t) = (a_b·t + c_b) mod B is shared: it draws a_b and c_b
// once from the murmur3 counter RNG (counters 2b, 2b+1), stages the n workers'
// rows of block b in shared memory with coalesced 16-byte loads, and gathers from
// there. Thread slot t ∈ [0, B) belongs to worker w = t / (B/n); it writes
// vals[w, b, t mod B/n] = x[w, b, π_b(t)]·n and the int32 offset, so neighbouring
// threads write neighbouring addresses.
//
// Bound by device-memory bytes: each block reads its n rows of x once (a gather
// of B/n of B values per row would touch ~90 % of the row's 32-byte sectors
// anyway) and writes B values and B offsets. The ×n scale is exact: n divides
// the power of two B, so it is a power of two.
//
// x and the values are f32 or bf16 (XT). C interface (loaded with ctypes): each
// entry point launches on the given stream, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "murmur.cuh"

constexpr int kThreads = 256;
constexpr int kStageBytes = 32 * 1024;  // rows staged per pass (more if one row is larger)

__device__ __forceinline__ float scale_n(float v, float n) { return __fmul_rn(v, n); }
__device__ __forceinline__ __nv_bfloat16 scale_n(__nv_bfloat16 v, float n) {
  return __float2bfloat16_rn(__fmul_rn(__bfloat162float(v), n));
}

template <typename XT>
__global__ void permk_seeded_workers_kernel(const XT* __restrict__ x, uint32_t seed,
                                            XT* __restrict__ vals,
                                            int32_t* __restrict__ offs, int n,
                                            int64_t nblk, int block, int rows,
                                            bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  XT* stage = reinterpret_cast<XT*>(smem_raw);
  const int64_t b = blockIdx.x;
  const uint32_t mask = (uint32_t)(block - 1);
  const uint32_t a = (murmur_bits(seed, 2u * (uint32_t)b) | 1u) & mask;
  const uint32_t c = murmur_bits(seed, 2u * (uint32_t)b + 1u) & mask;
  const int chunk = block / n;
  const float fn = (float)n;
  for (int w0 = 0; w0 < n; w0 += rows) {
    const int rw = min(rows, n - w0);
    if (vec) {  // 16 bytes a thread
      const int per_row = block * (int)sizeof(XT) / 16;
      for (int i = threadIdx.x; i < rw * per_row; i += blockDim.x) {
        const int r = i / per_row;
        const uint4* src =
            reinterpret_cast<const uint4*>(x + ((int64_t)(w0 + r) * nblk + b) * block);
        reinterpret_cast<uint4*>(stage + (int64_t)r * block)[i % per_row] = src[i % per_row];
      }
    } else {
      for (int i = threadIdx.x; i < rw * block; i += blockDim.x)
        stage[i] = x[((int64_t)(w0 + i / block) * nblk + b) * block + i % block];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rw * chunk; i += blockDim.x) {
      const int w = w0 + i / chunk;
      const int j = i % chunk;
      const uint32_t t = (uint32_t)(w0 * chunk + i);  // = w·chunk + j
      const uint32_t off = (a * t + c) & mask;
      const int64_t o = ((int64_t)w * nblk + b) * chunk + j;
      vals[o] = scale_n(stage[(w - w0) * block + (int)off], fn);
      offs[o] = (int32_t)off;
    }
    __syncthreads();
  }
}

template <typename XT>
static int launch_permk(const void* x, unsigned int seed, void* vals, void* offs, int n,
                        long long nblk, int block, void* stream) {
  const int row_bytes = block * (int)sizeof(XT);
  int rows = kStageBytes / row_bytes;
  rows = rows < 1 ? 1 : (rows > n ? n : rows);
  const size_t smem = (size_t)rows * row_bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(permk_seeded_workers_kernel<XT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec = ((uintptr_t)x % 16 == 0) && (row_bytes % 16 == 0);
  permk_seeded_workers_kernel<XT><<<(unsigned)nblk, kThreads, smem, (cudaStream_t)stream>>>(
      (const XT*)x, (uint32_t)seed, (XT*)vals, (int32_t*)offs, n, nblk, block, rows, vec);
  return (int)cudaGetLastError();
}

extern "C" int permk_seeded_workers_f32(const void* x, unsigned int seed, void* vals,
                                        void* offs, int n, long long nblk, int block,
                                        void* stream) {
  return launch_permk<float>(x, seed, vals, offs, n, nblk, block, stream);
}

extern "C" int permk_seeded_workers_bf16(const void* x, unsigned int seed, void* vals,
                                         void* offs, int n, long long nblk, int block,
                                         void* stream) {
  return launch_permk<__nv_bfloat16>(x, seed, vals, offs, n, nblk, block, stream);
}
