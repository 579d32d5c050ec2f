// Packed payloads summed over the workers, for Hopper (sm_90a): the one
// kernel behind qsgd_epilogue and natural_epilogue (epilogue.cu) and
// qsgd_dequant_mean (quantize.cu), each source compiled on its own. A payload
// is n rows of int8 codes, (n, nblk, B), and one f32 per (worker, block) row,
// (n, nblk). Two policies fill the kernel in:
//
// * Decode: how a row decodes. row_scale turns the row's f32 into the scale
//   the warp shares, add adds four decoded coordinates to the running sum,
//   each operation rounded once. Each decoder's name holds a wrapper's
//   (chip_smoke.py's profile counts a kernel as the port's by such names).
// * Tail: what becomes of the sum. load(q) starts the loads the tail needs
//   at quad q (they are issued with the codes, before any is used); store(q,
//   acc, in) writes its outputs. epilogue.cu's tail updates g and x;
//   mean_row below writes the mean.
//
// One thread per 4 contiguous coordinates (quad q), every access contiguous
// across the warp: each worker's codes as one char4 (128 B a warp
// instruction), the tails' f32 rows as float4 (512 B). B ≥ 128
// (check_qsgd_block, check_natural_block) makes the quad count a multiple of
// 32, so every warp is full and its 128 coordinates lie in one block
// b = q >> qshift (a shift: B = 2^(qshift + 2)): lane w reads row w's f32 once
// and computes its row_scale, and the warp shares it by shuffles, in place of
// n loads (and, for QSGD, n divides) a thread. For NW = n ≤ 4 (every count the
// paths give: the uplink's 4, the downlink's 1) the workers are unrolled and
// every load (codes, the tail's, the row's f32) is started before any is used;
// NW = 0 keeps a runtime loop, 32 workers a round of shuffles. The sum runs
// from +0, worker by worker, each operation rounded once, so every output is
// bit-equal to its plain version. The unrolling is what makes these kernels
// bound by bytes: with code loads in a loop over the runtime n, behind the
// row load and divide, a thread waits for two memory round trips (1.4–2.2×
// the byte bound, PERF.md).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"

// QSGD: level l under norm_w as l·(norm_w / s)
struct qsgd_epilogue_levels {
  float s;
  __device__ __forceinline__ float row_scale(float norm) const { return __fdiv_rn(norm, s); }
  __device__ __forceinline__ void add(float4& acc, char4 l, float scale) const {
    acc.x = __fadd_rn(acc.x, __fmul_rn((float)l.x, scale));
    acc.y = __fadd_rn(acc.y, __fmul_rn((float)l.y, scale));
    acc.z = __fadd_rn(acc.z, __fmul_rn((float)l.z, scale));
    acc.w = __fadd_rn(acc.w, __fmul_rn((float)l.w, scale));
  }
};

// natural: code c under scale_w (used as read) as natural_value(c, scale_w),
// the branch-free decode of quant.cuh
struct natural_epilogue_codes {
  __device__ __forceinline__ float row_scale(float scale) const { return scale; }
  __device__ __forceinline__ void add(float4& acc, char4 c, float scale) const {
    acc.x = __fadd_rn(acc.x, natural_value(c.x, scale));
    acc.y = __fadd_rn(acc.y, natural_value(c.y, scale));
    acc.z = __fadd_rn(acc.z, natural_value(c.z, scale));
    acc.w = __fadd_rn(acc.w, natural_value(c.w, scale));
  }
};

// out = acc / n, written as float4: for POW2 (n a power of two) as
// acc·(1/n), 1/n exact, which rounds the same real number as acc / n and so
// is bit-identical; else a true __fdiv_rn
template <bool POW2>
struct mean_row {
  float* out;
  float fn, inv;
  struct In {};
  __device__ __forceinline__ In load(int64_t) const { return {}; }
  __device__ __forceinline__ float mean(float a) const {
    return POW2 ? __fmul_rn(a, inv) : __fdiv_rn(a, fn);
  }
  __device__ __forceinline__ void store(int64_t q, float4 acc, In) const {
    reinterpret_cast<float4*>(out)[q] =
        make_float4(mean(acc.x), mean(acc.y), mean(acc.z), mean(acc.w));
  }
};

template <int NW, typename Decode, typename Tail>
__global__ void packed_sum_kernel(const int8_t* __restrict__ codes,
                                  const float* __restrict__ rows, int n, int64_t nblk,
                                  int block, Decode dec, Tail tail) {
  const int64_t quads = nblk * block / 4;
  const int qshift = __ffs(block) - 3;
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;  // a multiple of 32
  const char4* cv = reinterpret_cast<const char4*>(codes);
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < quads;
       q += stride) {  // warp-uniform: quads and q − lane are multiples of 32
    const int64_t b = q >> qshift;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    typename Tail::In in;
    if constexpr (NW > 0) {
      char4 c[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) c[w] = cv[(int64_t)w * quads + q];
      in = tail.load(q);
      const float mine = dec.row_scale(lane < NW ? rows[(int64_t)lane * nblk + b] : 0.0f);
#pragma unroll
      for (int w = 0; w < NW; ++w) dec.add(acc, c[w], __shfl_sync(0xffffffffu, mine, w));
    } else {
      in = tail.load(q);
      for (int w0 = 0; w0 < n; w0 += 32) {
        const int m = min(32, n - w0);
        const float mine =
            lane < m ? dec.row_scale(rows[(int64_t)(w0 + lane) * nblk + b]) : 0.0f;
#pragma unroll 4
        for (int j = 0; j < m; ++j) {
          const float scale = __shfl_sync(0xffffffffu, mine, j);
          dec.add(acc, cv[(int64_t)(w0 + j) * quads + q], scale);
        }
      }
    }
    tail.store(q, acc, in);
  }
}

// One launch of packed_sum_kernel, 256 threads a CTA, the workers unrolled
// for n ≤ 4
template <typename Decode, typename Tail>
static int launch_packed(const void* codes, const void* rows, int n, long long nblk,
                         int block, Decode dec, Tail tail, void* stream) {
  long long grid = (nblk * block / 4 + 255) / 256;
  if (grid > 1048576) grid = 1048576;  // the grid-stride loop covers the rest
  if (grid < 1) grid = 1;
  cudaStream_t st = (cudaStream_t)stream;
#define PACKED_LAUNCH(NW)                                                          \
  packed_sum_kernel<NW, Decode, Tail><<<(unsigned)grid, 256, 0, st>>>(              \
      (const int8_t*)codes, (const float*)rows, n, nblk, block, dec, tail)
  switch (n) {
    case 1: PACKED_LAUNCH(1); break;
    case 2: PACKED_LAUNCH(2); break;
    case 3: PACKED_LAUNCH(3); break;
    case 4: PACKED_LAUNCH(4); break;
    default: PACKED_LAUNCH(0);  // any other n: the runtime worker loop
  }
#undef PACKED_LAUNCH
  return (int)cudaGetLastError();
}
