// PermK uplink for Hopper (sm_90a): one shared seeded permutation partitions
// every block's B coordinates across the n workers of a fleet.
//
// Replaces the Pallas TPU kernel src/repro/kernels/permk.py::permk_seeded_workers.
// The TPU version runs one grid step per (worker, block) and gathers through a
// one-hot MXU matmul. Here the affine bijection π_b(t) = (a_b·t + c_b) mod B is
// shared by every worker, so one CTA serves block b for all the stacked rows: it
// draws a_b and c_b from the murmur3 counter RNG (counters 2b, 2b+1), stages the
// rows of block b in shared memory with coalesced 16-byte loads, and gathers from
// there. Stacked row k is worker w_k of the fleet (a device array of indices, or
// k itself): it takes the slots t ∈ [w_k·C, (w_k+1)·C), C = B/n, and writes
// vals[k, b, j] = x[k, b, π_b(w_k·C + j)]·n and, unless the caller drops them,
// the int32 offset. A stack wider than kStageBytes is staged in passes.
//
// Bound by device-memory bytes. A gather of C of a row's B values touches ~95 %
// of its 64-byte segments, so each staged row is read in full: the design moves
// r·B·elt bytes of x a block, plus r·C·elt of values and r·C·4 of offsets, and
// runs at ~93 % of the card's rate for them. What a caller saves is the bytes it
// does not ask for: offsets=False (no offset store, a template branch) and a
// stack of only the r rows a rank holds. (A persistent grid fed by a ring of TMA
// bulk copies was 4.6 % slower with offsets at the production shape, f32.)
//
// Stores: a warp's 32 consecutive slots sit on 32 consecutive lanes, so its
// shared-memory reads hit distinct banks (a_b is odd) and its stores coalesce.
// With f32 x a lane takes 4 consecutive slots for one 16-byte store, its reads
// rotated by its lane group so each step's 32 reads still hit 32 banks (0.6 %
// faster than 4-byte stores without offsets); bf16 keeps one slot a lane (its
// 8-slot rotation was 12 % slower). The ×n scale is exact: n divides the power
// of two B, so it is a power of two; a bf16 value rounds once, from the f32
// product.
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

// f32, C a multiple of 4: lane l of a warp takes slots 4l .. 4l+3 of the warp's
// 128; at step q it reads slot 4l + (q + h) mod 4, h = l / 8, so the 32 reads
// of a step fall on 32 slots distinct mod 32, then rotates them back by h.
template <bool kOffs>
__device__ __forceinline__ void gather4x4(const float* stage, const int32_t* wid,
                                          float* vals, int32_t* offs, int64_t nblk,
                                          int64_t b, int k0, int rw, int chunk, int cshift,
                                          int bshift, uint32_t a, uint32_t c, uint32_t mask,
                                          float fn) {
  const int h = (threadIdx.x & 31) >> 3;
  for (int u = threadIdx.x; u < (rw * chunk) >> 2; u += blockDim.x) {
    const int i = u << 2;
    const int kl = i >> cshift;  // the stage's row, worker wid[k0 + kl]
    const int j = i & (chunk - 1);
    const uint32_t t0 = (uint32_t)(wid[k0 + kl] * chunk + j);
    const float* row = stage + (kl << bshift);
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = row[(a * (t0 + ((q + h) & 3)) + c) & mask];
    float4 out;  // slot t0 + m is v[(m - h) mod 4]
    out.x = scale_n(h == 0 ? v[0] : h == 1 ? v[3] : h == 2 ? v[2] : v[1], fn);
    out.y = scale_n(h == 0 ? v[1] : h == 1 ? v[0] : h == 2 ? v[3] : v[2], fn);
    out.z = scale_n(h == 0 ? v[2] : h == 1 ? v[1] : h == 2 ? v[0] : v[3], fn);
    out.w = scale_n(h == 0 ? v[3] : h == 1 ? v[2] : h == 2 ? v[1] : v[0], fn);
    const int64_t o = ((int64_t)(k0 + kl) * nblk + b) * chunk + j;
    *reinterpret_cast<float4*>(vals + o) = out;
    if (kOffs)
      *reinterpret_cast<int4*>(offs + o) =
          make_int4((int)((a * t0 + c) & mask), (int)((a * (t0 + 1) + c) & mask),
                    (int)((a * (t0 + 2) + c) & mask), (int)((a * (t0 + 3) + c) & mask));
  }
}

template <typename XT, bool kOffs>
__global__ void __launch_bounds__(kThreads)
permk_seeded_workers_kernel(const XT* __restrict__ x, uint32_t seed,
                            const int32_t* __restrict__ workers, XT* __restrict__ vals,
                            int32_t* __restrict__ offs, int n, int r, int64_t nblk,
                            int block, int rows, bool vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  XT* stage = reinterpret_cast<XT*>(smem_raw);
  int32_t* wid = reinterpret_cast<int32_t*>(
      smem_raw + ((rows * block * (int)sizeof(XT) + 15) & ~15));
  for (int k = threadIdx.x; k < r; k += blockDim.x) wid[k] = workers ? workers[k] : k;
  const int64_t b = blockIdx.x;
  const uint32_t mask = (uint32_t)(block - 1);
  const uint32_t a = (murmur_bits(seed, 2u * (uint32_t)b) | 1u) & mask;
  const uint32_t c = murmur_bits(seed, 2u * (uint32_t)b + 1u) & mask;
  const int chunk = block / n;
  const int cshift = __ffs(chunk) - 1;
  const int bshift = __ffs(block) - 1;
  const float fn = (float)n;
  for (int k0 = 0; k0 < r; k0 += rows) {
    const int rw = min(rows, r - k0);
    if (vec) {  // 16 bytes a thread
      const int per_row = block * (int)sizeof(XT) / 16;
      for (int i = threadIdx.x; i < rw * per_row; i += blockDim.x) {
        const uint4* src = reinterpret_cast<const uint4*>(
            x + ((int64_t)(k0 + i / per_row) * nblk + b) * block);
        reinterpret_cast<uint4*>(stage)[i] = src[i % per_row];
      }
    } else {
      for (int i = threadIdx.x; i < rw * block; i += blockDim.x)
        stage[i] = x[((int64_t)(k0 + (i >> bshift)) * nblk + b) * block + (i & (block - 1))];
    }
    __syncthreads();
    if constexpr (sizeof(XT) == 4) {
      if ((chunk & 3) == 0) {
        gather4x4<kOffs>(stage, wid, vals, offs, nblk, b, k0, rw, chunk, cshift, bshift, a,
                         c, mask, fn);
        __syncthreads();
        continue;
      }
    }
    for (int i = threadIdx.x; i < rw * chunk; i += blockDim.x) {
      const int kl = i >> cshift;  // the stage's row, worker wid[k0 + kl]
      const int j = i & (chunk - 1);
      const uint32_t off = (a * (uint32_t)(wid[k0 + kl] * chunk + j) + c) & mask;
      const int64_t o = ((int64_t)(k0 + kl) * nblk + b) * chunk + j;
      vals[o] = scale_n(stage[(kl << bshift) + (int)off], fn);
      if (kOffs) offs[o] = (int32_t)off;
    }
    __syncthreads();
  }
}

template <typename XT, bool kOffs>
static int launch_kernel(const void* x, uint32_t seed, const void* workers, void* vals,
                         void* offs, int n, int r, long long nblk, int block, void* stream) {
  const int row_bytes = block * (int)sizeof(XT);
  int rows = kStageBytes / row_bytes;
  rows = rows < 1 ? 1 : (rows > r ? r : rows);
  const size_t smem = (((size_t)rows * row_bytes + 15) & ~(size_t)15) + (size_t)r * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(permk_seeded_workers_kernel<XT, kOffs>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec = ((uintptr_t)x % 16 == 0) && (row_bytes % 16 == 0);
  permk_seeded_workers_kernel<XT, kOffs><<<(unsigned)nblk, kThreads, smem,
                                           (cudaStream_t)stream>>>(
      (const XT*)x, seed, (const int32_t*)workers, (XT*)vals, (int32_t*)offs, n, r, nblk,
      block, rows, vec);
  return (int)cudaGetLastError();
}

template <typename XT>
static int launch_permk(const void* x, unsigned int seed, const void* workers, void* vals,
                        void* offs, int n, int r, long long nblk, int block, void* stream) {
  return offs ? launch_kernel<XT, true>(x, seed, workers, vals, offs, n, r, nblk, block, stream)
              : launch_kernel<XT, false>(x, seed, workers, vals, offs, n, r, nblk, block,
                                         stream);
}

extern "C" int permk_seeded_workers_f32(const void* x, unsigned int seed, const void* workers,
                                        void* vals, void* offs, int n, int r, long long nblk,
                                        int block, void* stream) {
  return launch_permk<float>(x, seed, workers, vals, offs, n, r, nblk, block, stream);
}

extern "C" int permk_seeded_workers_bf16(const void* x, unsigned int seed,
                                         const void* workers, void* vals, void* offs, int n,
                                         int r, long long nblk, int block, void* stream) {
  return launch_permk<__nv_bfloat16>(x, seed, workers, vals, offs, n, r, nblk, block, stream);
}
