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
// How many bytes L2 fetches from device memory for one such random load is
// the context's cudaLimitMaxL2FetchGranularity, which l2_fetch_granularity
// reads back and set_l2_fetch_granularity asks for. The port leaves it at
// the runtime's default (64 bytes on the H100): 32 bytes reads back as set
// but moves neither gather nor a bare random gather (PERF.md), so it
// is read and printed, never set, on the port's paths.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError() (the limit's
// two return the runtime call's error).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "murmur.cuh"

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

// One warp per block b, up to kScatterWarps blocks a CTA, the warp's (B,)
// f32 row in shared memory; no __syncthreads. The warp zero-fills its row,
// then takes the block's n·kb payload pairs 32 at a time in the oracle's
// order (w = 0..n−1, then t = 0..kb−1; worker w's kb pairs of block b are
// contiguous at (w·nblk + b)·kb), one pair a lane, loaded coalesced. Pairs
// of one chunk with the same offset are ranked by lane (__match_any_sync);
// rank r adds in round r, so the lanes of a round add into distinct
// coordinates at once and each coordinate's adds keep the oracle's order,
// without float atomics. Offsets outside [0, B) are dropped, as XLA's
// scatter drops them. Then out[b, j] = acc[j] / n, written as float4 where
// every row stays 16-byte aligned (B a multiple of 4; else one float at a
// time): for n a
// power of two as acc[j]·(1/n), which is acc[j] / n rounded once (1/n is
// exact, so both round the same real number), else a true division. The
// design it replaces ran one CTA of 128 threads a block, with lane 0 doing
// all n·kb read-add-writes in a dependent chain while the others waited at a
// barrier (2.7× its byte bound, PERF.md); with the chain gone, the IEEE
// divide of every coordinate took more instruction slots than the pairs' adds.
// Bound by bytes: the (B,) output row is 1.86 of the 2.15 GB it moves at the
// production shape.
constexpr int kScatterWarps = 8;

// row[j] = acc[j] / n rounded once, by a warp: for POW2 (n a power of two)
// as acc[j]·(1/n), 1/n exact, else an IEEE division; float4 stores for VEC
// (B a multiple of 4, so acc and row are 16-byte aligned), one float a lane
// otherwise
template <bool POW2, bool VEC>
__device__ __forceinline__ void write_mean_row(const float* acc, float* __restrict__ row,
                                               int block, int n, int lane) {
  const float fn = (float)n;
  const float inv = __fdiv_rn(1.0f, fn);
  auto mean = [&](float a) { return POW2 ? __fmul_rn(a, inv) : __fdiv_rn(a, fn); };
  const int quads = VEC ? block >> 2 : 0;
  for (int j = lane; j < quads; j += 32) {
    const float4 a = reinterpret_cast<const float4*>(acc)[j];
    reinterpret_cast<float4*>(row)[j] = make_float4(mean(a.x), mean(a.y), mean(a.z), mean(a.w));
  }
  for (int j = 4 * quads + lane; j < block; j += 32) row[j] = mean(acc[j]);
}

template <bool VEC>
__global__ void __launch_bounds__(32 * kScatterWarps)
scatter_accum_kernel(const float* __restrict__ vals, const int32_t* __restrict__ offs,
                     float* __restrict__ out, int n, int64_t nblk, int block, int kb,
                     int warps) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * warps + warp;
  if (b >= nblk) return;  // the whole warp: nothing below waits on another warp
  float* acc = reinterpret_cast<float*>(smem4) + (size_t)warp * block;
  const int quads = VEC ? block >> 2 : 0;
  float4* acc4 = reinterpret_cast<float4*>(acc);  // VEC: 16-byte aligned rows
  for (int j = lane; j < quads; j += 32) acc4[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j = 4 * quads + lane; j < block; j += 32) acc[j] = 0.0f;
  __syncwarp();

  const int m = n * kb;
  const unsigned below = (1u << lane) - 1u;
  for (int i0 = 0; i0 < m; i0 += 32) {
    const int i = i0 + lane;
    int o = -1;
    float v = 0.0f;
    if (i < m) {
      const int w = i / kb;
      const int64_t src = ((int64_t)w * nblk + b) * kb + (i - w * kb);
      v = vals[src];
      o = offs[src];
    }
    const bool keep = (unsigned)o < (unsigned)block;
    const int rank = __popc(__match_any_sync(0xffffffffu, o) & below);
    const int rounds = (int)__reduce_max_sync(0xffffffffu, keep ? rank + 1 : 0);
    for (int r = 0; r < rounds; ++r) {
      if (keep && rank == r) acc[o] = __fadd_rn(acc[o], v);
      __syncwarp();
    }
  }

  if ((n & (n - 1)) == 0)
    write_mean_row<true, VEC>(acc, out + b * block, block, n, lane);
  else
    write_mean_row<false, VEC>(acc, out + b * block, block, n, lane);
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

template <bool VEC>
static int launch_scatter(const void* vals, const void* offs, void* out, int n,
                          long long nblk, int block, int kb, void* stream) {
  // kScatterWarps blocks a CTA up to B = 1024 (32 KiB of rows), fewer above;
  // one row a CTA from B = 8192 up to the 227 KiB a CTA may hold (the
  // wrapper refuses wider rows)
  const int warps = block >= 1024 ? (block >= 8192 ? 1 : 8192 / block) : kScatterWarps;
  const size_t smem = (size_t)warps * block * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        scatter_accum_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long grid = (nblk + warps - 1) / warps;
  scatter_accum_kernel<VEC><<<(unsigned)grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const float*)vals, (const int32_t*)offs, (float*)out, n, nblk, block, kb, warps);
  return (int)cudaGetLastError();
}

extern "C" int scatter_accum(const void* vals, const void* offs, void* out, int n,
                             long long nblk, int block, int kb, void* stream) {
  return (block & 3) == 0
             ? launch_scatter<true>(vals, offs, out, n, nblk, block, kb, stream)
             : launch_scatter<false>(vals, offs, out, n, nblk, block, kb, stream);
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

// The context's L2 fetch granularity (cudaLimitMaxL2FetchGranularity), in
// bytes, as the runtime reads it back.
extern "C" int l2_fetch_granularity(int* bytes) {
  size_t v = 0;
  const cudaError_t e = cudaDeviceGetLimit(&v, cudaLimitMaxL2FetchGranularity);
  *bytes = (int)v;
  return (int)e;
}

// Ask the runtime for an L2 fetch granularity of `bytes`, a hint it may
// clamp or ignore (read it back with l2_fetch_granularity).
extern "C" int set_l2_fetch_granularity(int bytes) {
  return (int)cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, (size_t)bytes);
}
