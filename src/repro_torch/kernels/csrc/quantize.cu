// Packed quantization wire for Hopper (sm_90a): blockwise s-level QSGD
// uplink, the server's dequantize-and-mean, the 4-bit nibble words the levels
// cross the wire in, and blockwise natural compression (power-of-two
// stochastic rounding, int8 exponent-delta codes) with its decode-and-mean,
// and the serving engine's int8 KV-page rows (per-row absmax quantize and its
// dequantize), and the two-pass global-norm QSGD of the flat-vector wire
// (Σx² per block, the levels against one norm and a host dither, the
// dequantize).
//
// Replaces the Pallas TPU kernels src/repro/kernels/quantize.py::
// qsgd_block_workers, ::qsgd_dequant_mean, ::nibble_pack, ::nibble_unpack,
// ::natural_block_workers, ::natural_dequant_mean, ::absmax_quant_rows,
// ::absmax_dequant_rows, ::block_sumsq, ::qsgd_quantize and ::qsgd_dequantize.
// The TPU versions sweep one (1, B) VMEM tile per grid step in order; here
// every (worker, block) row or group of coordinates is its own CTA or thread,
// in no order, and nothing carries over between them.
//
// All six are bound by device-memory bytes: a few operations per byte
// moved. qsgd_block_workers reads x (f32 or bf16) once and writes int8
// levels and one f32 norm per row; the block's norm is reduced in registers
// and shared memory, so x is never read twice. Its murmur3 hash, IEEE
// divide and floor per coordinate take instruction time of the same order as
// its bytes (PERF.md). qsgd_dequant_mean reads the n int8 payloads and writes
// one f32 accumulator. The nibble kernels move 8 int8 to or from one 32-bit
// word per thread. natural_block_workers, like the QSGD uplink, reads x once
// and writes int8 codes and one f32 scale per row: the row's max |x| is
// reduced in registers and shared memory (a max is exact in any order), and
// each coordinate then costs an exponent read from its bits, one exact
// subtraction and division, and a murmur3 hash. natural_dequant_mean reads
// the n int8 payloads and writes one f32 accumulator. absmax_quant_rows
// reads each KV row (W = 32·NPL values, one warp per row) once into
// registers, takes the row's max |x| with warp shuffles (exact in any order)
// and writes W int8 codes and one f32 scale, to rows of its own or, for
// absmax_quant_write_pages, straight into a layer's k and v page pools at
// device-side (page, row) indices; absmax_dequant_rows is one
// multiply per code, 16 codes per thread (see its section). block_sumsq
// reads x once (one CTA
// per block, the blockwise norm's reduction) and writes one f32 per block;
// qsgd_quantize reads x and the f32 dither and writes int8, 4 coordinates
// per thread; qsgd_dequantize reads int8 and writes f32.
//
// Floating-point order (the plain versions in ref.py repeat it exactly):
// * the block norm and block_sumsq: thread t squares its 4 contiguous
//   elements and adds them left to right; each warp adds its 32 partials in
//   a halving tree (shfl_down by 16, 8, 4, 2, 1); warp 0 adds the warps' sums
//   in a halving tree (zero-padded to a power of two); then, for the norm,
//   an IEEE square root;
// * the level: floor((s·|x|) / safe + u), each operation rounded once
//   (__fmul_rn, __fdiv_rn, __fadd_rn; no reciprocal, no FMA);
// * the dequant-mean: from 0, worker by worker, acc + level·(norm_w / s),
//   then acc / n, each rounded once;
// * natural codes and decoding: quant.cuh (natural_code, natural_value);
//   the decode-and-mean sums from 0 in worker order, then acc / n;
// * absmax rows: scale = amax·f32(1/127) (__fmul_rn by the constant's exact
//   bits, never 1.0f/127.0f), code = rintf(x / safe) (__fdiv_rn, round half
//   to even), safe = 1 where the scale is 0; dequant = code·scale.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError(). The wrappers
// check shapes, types and 16-byte alignment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "murmur.cuh"
#include "quant.cuh"

// 4 contiguous elements of x as f32 (one 16-byte or 8-byte load)
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

// Σ of the squares of a row held 4 per thread by a CTA of B/4 threads (B a
// multiple of 128), in the fixed order: each thread adds its 4 squares left
// to right, each warp its 32 partials in a halving tree (shfl_down by 16, 8,
// 4, 2, 1), then warp 0 the warps' sums in a halving tree, zero-padded to a
// power of two. The result is valid in thread 0.
__device__ __forceinline__ float block_sumsq4(const float v[4], float* warp_sums) {
  const int t = threadIdx.x;
  float p = __fmul_rn(v[0], v[0]);
  p = __fadd_rn(p, __fmul_rn(v[1], v[1]));
  p = __fadd_rn(p, __fmul_rn(v[2], v[2]));
  p = __fadd_rn(p, __fmul_rn(v[3], v[3]));
  for (int h = 16; h > 0; h >>= 1) p = __fadd_rn(p, __shfl_down_sync(0xffffffffu, p, h));
  const int warps = blockDim.x >> 5;
  if ((t & 31) == 0) warp_sums[t >> 5] = p;
  __syncthreads();
  float q = 0.0f;
  if (t < 32) {
    q = t < warps ? warp_sums[t] : 0.0f;
    int width = 1;
    while (width < warps) width <<= 1;
    for (int h = width >> 1; h > 0; h >>= 1) q = __fadd_rn(q, __shfl_down_sync(0xffffffffu, q, h));
  }
  return q;
}

// One CTA of B/4 threads per (w, b) row: the row's norm, then its B levels.
template <typename XT>
__global__ void qsgd_block_workers_kernel(const XT* __restrict__ x,
                                          const int32_t* __restrict__ seeds,
                                          int8_t* __restrict__ levels,
                                          float* __restrict__ norms,
                                          int64_t nblk, int block, float s) {
  __shared__ float warp_sums[32];
  __shared__ float row_norm;
  const int64_t row = blockIdx.x;  // w·nblk + b
  const int64_t b = row % nblk;
  const int w = (int)(row / nblk);
  const int t = threadIdx.x;
  float v[4];
  load4(x + row * block + 4 * t, v);

  const float sumsq = block_sumsq4(v, warp_sums);
  if (t == 0) {
    row_norm = __fsqrt_rn(sumsq);
    norms[row] = row_norm;
  }
  __syncthreads();
  const float norm = row_norm;
  const float safe = norm > 0.0f ? norm : 1.0f;
  // seeds arrive as int32 and are reinterpreted, not converted
  const uint32_t seed = (uint32_t)seeds[w];
  const uint32_t ctr0 = (uint32_t)(b * block + 4 * t);
  char4 q;
  q.x = qsgd_level(v[0], s, safe, murmur_bits(seed, ctr0));
  q.y = qsgd_level(v[1], s, safe, murmur_bits(seed, ctr0 + 1u));
  q.z = qsgd_level(v[2], s, safe, murmur_bits(seed, ctr0 + 2u));
  q.w = qsgd_level(v[3], s, safe, murmur_bits(seed, ctr0 + 3u));
  reinterpret_cast<char4*>(levels + row * block)[t] = q;
}

// One thread per 4 coordinates: the workers' payloads dequantized and
// summed in order, ÷ n.
__global__ void qsgd_dequant_mean_kernel(const int8_t* __restrict__ levels,
                                         const float* __restrict__ norms,
                                         float* __restrict__ out, int n,
                                         int64_t nblk, int block, float s) {
  const int64_t size = nblk * block;
  const int64_t quads = size / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const float fn = (float)n;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < quads;
       i += stride) {
    float acc[4];
    dequant_sum4(levels, norms, n, nblk, size, 4 * i / block, 4 * i, s, acc);
    float4 o;
    o.x = __fdiv_rn(acc[0], fn);
    o.y = __fdiv_rn(acc[1], fn);
    o.z = __fdiv_rn(acc[2], fn);
    o.w = __fdiv_rn(acc[3], fn);
    reinterpret_cast<float4*>(out)[i] = o;
  }
}

// One CTA of B/4 threads per (w, b) row: the row's max |x| (subnormals
// flushed), then its B codes and the scale 2^e_ref.
template <typename XT>
__global__ void natural_block_workers_kernel(const XT* __restrict__ x,
                                             const int32_t* __restrict__ seeds,
                                             int8_t* __restrict__ codes,
                                             float* __restrict__ scales,
                                             int64_t nblk, int block) {
  __shared__ float warp_max[32];
  __shared__ int row_e_ref;
  const int64_t row = blockIdx.x;  // w·nblk + b
  const int64_t b = row % nblk;
  const int w = (int)(row / nblk);
  const int t = threadIdx.x;
  float v[4];
  load4(x + row * block + 4 * t, v);

  float m = fmaxf(fmaxf(natural_abs(v[0]), natural_abs(v[1])),
                  fmaxf(natural_abs(v[2]), natural_abs(v[3])));
  for (int h = 16; h > 0; h >>= 1) m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, h));
  const int warps = blockDim.x >> 5;
  if ((t & 31) == 0) warp_max[t >> 5] = m;
  __syncthreads();
  if (t < 32) {
    float q = t < warps ? warp_max[t] : 0.0f;
    for (int h = 16; h > 0; h >>= 1) q = fmaxf(q, __shfl_down_sync(0xffffffffu, q, h));
    if (t == 0) {
      row_e_ref = natural_e_ref(q);
      scales[row] = pow2_exact(row_e_ref);
    }
  }
  __syncthreads();
  const int e_ref = row_e_ref;
  // seeds arrive as int32 and are reinterpreted, not converted
  const uint32_t seed = (uint32_t)seeds[w];
  const uint32_t ctr0 = (uint32_t)(b * block + 4 * t);
  char4 c;
  c.x = natural_code(v[0], e_ref, murmur_bits(seed, ctr0));
  c.y = natural_code(v[1], e_ref, murmur_bits(seed, ctr0 + 1u));
  c.z = natural_code(v[2], e_ref, murmur_bits(seed, ctr0 + 2u));
  c.w = natural_code(v[3], e_ref, murmur_bits(seed, ctr0 + 3u));
  reinterpret_cast<char4*>(codes + row * block)[t] = c;
}

// One thread per 4 coordinates: the workers' codes decoded and summed in
// order, ÷ n.
__global__ void natural_dequant_mean_kernel(const int8_t* __restrict__ codes,
                                            const float* __restrict__ scales,
                                            float* __restrict__ out, int n,
                                            int64_t nblk, int block) {
  const int64_t size = nblk * block;
  const int64_t quads = size / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const float fn = (float)n;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < quads;
       i += stride) {
    float acc[4];
    natural_sum4(codes, scales, n, nblk, size, 4 * i / block, 4 * i, acc);
    float4 o;
    o.x = __fdiv_rn(acc[0], fn);
    o.y = __fdiv_rn(acc[1], fn);
    o.z = __fdiv_rn(acc[2], fn);
    o.w = __fdiv_rn(acc[3], fn);
    reinterpret_cast<float4*>(out)[i] = o;
  }
}

// One thread per word: 8 int8 levels in [−8, 7] → one uint32, level t's
// two's-complement nibble at bits [4t, 4t+4).
__global__ void nibble_pack_kernel(const int8_t* __restrict__ q,
                                   uint32_t* __restrict__ words, int64_t nwords) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nwords;
       i += stride) {
    const uint2 g = reinterpret_cast<const uint2*>(q)[i];
    uint32_t word = 0;
    for (int t = 0; t < 4; ++t) {
      word |= ((g.x >> (8 * t)) & 0xFu) << (4 * t);
      word |= ((g.y >> (8 * t)) & 0xFu) << (4 * t + 16);
    }
    words[i] = word;
  }
}

// One thread per word: the inverse, each nibble sign-extended (8..15 → −8..−1).
__global__ void nibble_unpack_kernel(const uint32_t* __restrict__ words,
                                     int8_t* __restrict__ q, int64_t nwords) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nwords;
       i += stride) {
    const uint32_t word = words[i];
    uint2 g = {0u, 0u};
    for (int t = 0; t < 4; ++t) {
      // shift the nibble to the top of an int32, then arithmetic-shift back
      const uint32_t lo = (uint32_t)((int32_t)(word << (28 - 4 * t)) >> 28) & 0xFFu;
      const uint32_t hi = (uint32_t)((int32_t)(word << (12 - 4 * t)) >> 28) & 0xFFu;
      g.x |= lo << (8 * t);
      g.y |= hi << (8 * t);
    }
    reinterpret_cast<uint2*>(q)[i] = g;
  }
}

// ---------------------------------------------------------------------------
// The serving engine's int8 KV-page rows: the absmax quantize (one kernel,
// two row maps) and its dequantize.
// ---------------------------------------------------------------------------

// f32(1/127) as numpy rounds the double 1/127: bit pattern 0x3C010204
#define ABSMAX_INV127_BITS 0x3C010204u

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// absmax_quant_rows replaces src/repro/kernels/quantize.py::absmax_quant_rows
// (there one (bm, W) VMEM tile per grid step and a separate scatter of the
// codes and scales into the page pool by XLA). Bound: device-memory bytes,
// W·(elt + 1) + 4 a row, a few operations a value. One kernel, two row maps:
// IdentityRows writes row r to codes[r] and scales[r] (the wrapper
// absmax_quant_rows, the Pallas kernel's exact function); PagedRows is the
// int8 KV-page write of one layer (absmax_quant_write_pages): warp r takes
// (k | v, token t, kv-head h), reads page[t] and row[t] on the device and
// writes its W codes straight into kq / vq[page[t], row[t], h, :] and its
// scale into k_scale / v_scale[page[t], row[t], h]. At decode's shapes the
// device time is a few µs, and what a caller waited for was host work: two
// wrapper calls, two copies and four index assignments a layer and step
// (PERF.md), now one launch with no allocation.
//
// The null page. Idle decode slots and padded prefill tokens all target
// page 0 (the reference's absorbed writes, src/repro/models/attention.py
// ::_paged_write); their warps race there, so a page-0 row's codes and its
// scale may come from different tokens (index_put with duplicate indices is
// as unspecified). Every row of pages >= 1 is bit-equal to the plain version
// (codes, scales, the sign of zero); page 0 is never read as data. A page or
// row index outside the pool is dropped, as the reference's scatter drops an
// out-of-bounds update.
// ---------------------------------------------------------------------------

// Row r of an absmax_quant_rows launch: x, codes and scales row-major.
template <typename XT>
struct IdentityRows {
  const XT* x;
  int8_t* codes;
  float* scales;
  template <int W>
  __device__ __forceinline__ bool locate(int64_t r, const XT*& xr, int8_t*& cr,
                                         float*& sr) const {
    xr = x + r * W;
    cr = codes + r * W;
    sr = scales + r;
    return true;
  }
};

// Row r of a paged write: r < T·KV is k's (t, h) = (r / KV, r % KV), the
// rest v's. k and v rows are (T, KV, W) with a token stride (elements) and
// contiguous (KV, W) parts; the pools (npage, P, KV, W) int8 and (npage, P,
// KV) f32, contiguous.
template <typename XT>
struct PagedRows {
  const XT* k;
  const XT* v;
  long long k_stride, v_stride;
  const int32_t* page;
  const int32_t* row;
  int8_t* kq;
  int8_t* vq;
  float* k_scale;
  float* v_scale;
  int tokens, kv, npage, psize;
  template <int W>
  __device__ __forceinline__ bool locate(int64_t r, const XT*& xr, int8_t*& cr,
                                         float*& sr) const {
    const int per = tokens * kv;  // < 2^30 (the wrapper checks)
    const bool is_v = r >= per;
    const int i = (int)r - (is_v ? per : 0);
    const int t = i / kv, h = i - t * kv;
    const int pg = page[t], rw = row[t];
    if ((unsigned)pg >= (unsigned)npage || (unsigned)rw >= (unsigned)psize) return false;
    const int64_t dst = ((int64_t)pg * psize + rw) * kv + h;
    xr = (is_v ? v + t * v_stride : k + t * k_stride) + h * W;
    cr = (is_v ? vq : kq) + dst * W;
    sr = (is_v ? v_scale : k_scale) + dst;
    return true;
  }
};

// One warp per (row of W = 32·NPL values), rows grid-strided: lane l holds
// the row's values l, l + 32, … (each load and store is contiguous across the
// warp). The max keeps a NaN, as jnp.max does.
template <typename XT, int NPL, typename Map>
__global__ void absmax_quant_kernel(const Map map, int64_t rows) {
  constexpr int W = 32 * NPL;
  const int lane = threadIdx.x & 31;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const float inv127 = __uint_as_float(ABSMAX_INV127_BITS);
  for (int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5; r < rows;
       r += warps) {
    const XT* xr;
    int8_t* cr;
    float* sr;
    if (!map.template locate<W>(r, xr, cr, sr)) continue;  // warp-uniform
    float v[NPL];
    float amax = 0.0f;
#pragma unroll
    for (int k = 0; k < NPL; ++k) {
      v[k] = to_f32(xr[k * 32 + lane]);
      const float a = fabsf(v[k]);
      amax = (a > amax || a != a) ? a : amax;
    }
#pragma unroll
    for (int h = 16; h > 0; h >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, amax, h);
      amax = (o > amax || o != o) ? o : amax;
    }
    const float scale = __fmul_rn(amax, inv127);
    const float safe = scale > 0.0f ? scale : 1.0f;
#pragma unroll
    for (int k = 0; k < NPL; ++k)
      cr[k * 32 + lane] = (int8_t)(int)rintf(__fdiv_rn(v[k], safe));
    if (lane == 0) *sr = scale;
  }
}

// ---------------------------------------------------------------------------
// absmax_dequant_rows replaces
// src/repro/kernels/quantize.py::absmax_dequant_rows (there one (bm, W) VMEM
// tile per grid step, one multiply by the row's broadcast scale). Bound:
// device-memory bytes, 5 per code (1 read, 4 written) and 4 per row: it does
// one multiply per 5 bytes. The design reads 16 codes a thread with one
// 16-byte load and writes them as four float4 stores, so a warp moves 512
// contiguous bytes in and 2 KB out per instruction; the row comes from a
// 32-bit shift (W a power of two) and its scale is read once per 16 codes.
// At decode's sizes (a few MB) a call is over in microseconds, and the
// wrapper's host work (kernels/quantize.py) is what a caller waits for.
// There is no sum: out = code·scale, one __fmul_rn, bit-equal to the plain
// version in any order.
// ---------------------------------------------------------------------------

// out = code·scale, one __fmul_rn per element (bit-equal to the plain
// version). One thread per 16 codes: one 16-byte load, four float4 stores.
// W = 2^shift ≥ 16 (every width the serve path gives it): the 16 codes lie in
// one row, found by a 32-bit shift, and its scale is read once; a full warp
// trades words and scales with shuffles so that each of its four stores
// writes 512 contiguous bytes (a thread's own 64 bytes, stored as they are,
// would leave every 32-byte sector half written by each of two stores). Any
// other W (a multiple of 4): the tail branch finds each group of 4 codes'
// row by a 32-bit division, and the last thread's 16 codes may be fewer.
__device__ __forceinline__ float4 dequant4(uint32_t w, float s) {
  float4 o;
  o.x = __fmul_rn((float)(int8_t)w, s);
  o.y = __fmul_rn((float)(int8_t)(w >> 8), s);
  o.z = __fmul_rn((float)(int8_t)(w >> 16), s);
  o.w = __fmul_rn((float)(int8_t)(w >> 24), s);
  return o;
}

__global__ void absmax_dequant_rows_kernel(const int8_t* __restrict__ codes,
                                           const float* __restrict__ scales,
                                           float* __restrict__ out, uint32_t groups,
                                           uint32_t quads, uint32_t row_quads, int shift) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t first = i - lane;  // the warp's first group
  if (first >= groups) return;
  if (shift >= 4 && first + 32 <= groups) {
    // A full warp: lane l holds codes 16l .. 16l + 15 of the warp's 512 (one
    // 16-byte load) and its row's scale; store k writes float4 32k + l of the
    // warp's 128 (coalesced), which is word l mod 4 of lane 8k + l / 4.
    const uint4 c = reinterpret_cast<const uint4*>(codes)[i];
    const float s = scales[i >> (shift - 4)];
    float4* o = reinterpret_cast<float4*>(out) + 4 * (size_t)first;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int src = 8 * k + (int)(lane >> 2);
      const uint32_t x = __shfl_sync(0xffffffffu, c.x, src);
      const uint32_t y = __shfl_sync(0xffffffffu, c.y, src);
      const uint32_t z = __shfl_sync(0xffffffffu, c.z, src);
      const uint32_t w = __shfl_sync(0xffffffffu, c.w, src);
      const float sk = __shfl_sync(0xffffffffu, s, src);
      const uint32_t sel = lane & 3;
      o[32 * k + lane] = dequant4(sel == 0 ? x : sel == 1 ? y : sel == 2 ? z : w, sk);
    }
    return;
  }
  if (i >= groups) return;
  float4* o = reinterpret_cast<float4*>(out) + 4 * (size_t)i;
  if (shift >= 4) {  // the last, partial warp
    const float s = scales[i >> (shift - 4)];
    const uint4 c = reinterpret_cast<const uint4*>(codes)[i];
    o[0] = dequant4(c.x, s);
    o[1] = dequant4(c.y, s);
    o[2] = dequant4(c.z, s);
    o[3] = dequant4(c.w, s);
    return;
  }
  const uint32_t* words = reinterpret_cast<const uint32_t*>(codes);
  if ((uint64_t)4 * i + 4 <= quads) {
    const uint4 c = reinterpret_cast<const uint4*>(codes)[i];
    o[0] = dequant4(c.x, scales[(4 * i) / row_quads]);
    o[1] = dequant4(c.y, scales[(4 * i + 1) / row_quads]);
    o[2] = dequant4(c.z, scales[(4 * i + 2) / row_quads]);
    o[3] = dequant4(c.w, scales[(4 * i + 3) / row_quads]);
    return;
  }
  for (uint32_t k = 4 * i; k < quads; ++k)
    reinterpret_cast<float4*>(out)[k] = dequant4(words[k], scales[k / row_quads]);
}

// ---------------------------------------------------------------------------
// Two-pass global-norm QSGD (the flat-vector wire, ops.py): Σx² per block,
// then the levels against one norm and a host-supplied dither, and the
// dequantize. The norm sqrt(Σ_b sumsq_b) is taken between the passes,
// outside any kernel; it arrives here as a device scalar.
// ---------------------------------------------------------------------------

// One CTA of B/4 threads per block: out[b] = Σ_j x[b, j]², in block_sumsq4's
// order (that of the blockwise norm, without the square root).
template <typename XT>
__global__ void block_sumsq_kernel(const XT* __restrict__ x, float* __restrict__ out,
                                   int block) {
  __shared__ float warp_sums[32];
  const int64_t row = blockIdx.x;
  float v[4];
  load4(x + row * block + 4 * threadIdx.x, v);
  const float sumsq = block_sumsq4(v, warp_sums);
  if (threadIdx.x == 0) out[row] = sumsq;
}

// One thread per 4 coordinates: sign(x)·floor((s·|x|) / safe + u) as int8,
// safe = norm (1 where it is 0), each operation rounded once.
template <typename XT>
__global__ void qsgd_quantize_kernel(const XT* __restrict__ x, const float* __restrict__ u,
                                     const float* __restrict__ norm,
                                     int8_t* __restrict__ q, int64_t quads, float s) {
  const float nv = *norm;
  const float safe = nv > 0.0f ? nv : 1.0f;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < quads;
       i += stride) {
    float v[4];
    load4(x + 4 * i, v);
    const float4 d = reinterpret_cast<const float4*>(u)[i];
    char4 l;
    l.x = qsgd_level_u(v[0], s, safe, d.x);
    l.y = qsgd_level_u(v[1], s, safe, d.y);
    l.z = qsgd_level_u(v[2], s, safe, d.z);
    l.w = qsgd_level_u(v[3], s, safe, d.w);
    reinterpret_cast<char4*>(q)[i] = l;
  }
}

// One thread per 4 levels: out = level·(norm / s), the divide and the
// multiply each rounded.
__global__ void qsgd_dequantize_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ norm,
                                       float* __restrict__ out, int64_t quads, float s) {
  const float scale = __fdiv_rn(*norm, s);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < quads;
       i += stride) {
    const char4 l = reinterpret_cast<const char4*>(q)[i];
    float4 o;
    o.x = __fmul_rn((float)l.x, scale);
    o.y = __fmul_rn((float)l.y, scale);
    o.z = __fmul_rn((float)l.z, scale);
    o.w = __fmul_rn((float)l.w, scale);
    reinterpret_cast<float4*>(out)[i] = o;
  }
}

static unsigned grid_for(long long work, int threads) {
  long long grid = (work + threads - 1) / threads;
  if (grid > 1048576) grid = 1048576;  // grid-stride loops cover the rest
  return (unsigned)(grid < 1 ? 1 : grid);
}

template <typename XT>
static int launch_qsgd(const void* x, const void* seeds, void* levels, void* norms,
                       int n, long long nblk, int block, int s, void* stream) {
  qsgd_block_workers_kernel<XT><<<(unsigned)(n * nblk), block / 4, 0,
                                  (cudaStream_t)stream>>>(
      (const XT*)x, (const int32_t*)seeds, (int8_t*)levels, (float*)norms, nblk,
      block, (float)s);
  return (int)cudaGetLastError();
}

extern "C" int qsgd_block_workers_f32(const void* x, const void* seeds, void* levels,
                                      void* norms, int n, long long nblk, int block,
                                      int s, void* stream) {
  return launch_qsgd<float>(x, seeds, levels, norms, n, nblk, block, s, stream);
}

extern "C" int qsgd_block_workers_bf16(const void* x, const void* seeds, void* levels,
                                       void* norms, int n, long long nblk, int block,
                                       int s, void* stream) {
  return launch_qsgd<__nv_bfloat16>(x, seeds, levels, norms, n, nblk, block, s,
                                    stream);
}

extern "C" int qsgd_dequant_mean(const void* levels, const void* norms, void* out,
                                 int n, long long nblk, int block, int s,
                                 void* stream) {
  qsgd_dequant_mean_kernel<<<grid_for(nblk * block / 4, 256), 256, 0,
                             (cudaStream_t)stream>>>(
      (const int8_t*)levels, (const float*)norms, (float*)out, n, nblk, block,
      (float)s);
  return (int)cudaGetLastError();
}

extern "C" int nibble_pack(const void* q, void* words, long long nwords, void* stream) {
  nibble_pack_kernel<<<grid_for(nwords, 256), 256, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (uint32_t*)words, nwords);
  return (int)cudaGetLastError();
}

extern "C" int nibble_unpack(const void* words, void* q, long long nwords,
                             void* stream) {
  nibble_unpack_kernel<<<grid_for(nwords, 256), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (int8_t*)q, nwords);
  return (int)cudaGetLastError();
}

template <typename XT>
static int launch_natural(const void* x, const void* seeds, void* codes, void* scales,
                          int n, long long nblk, int block, void* stream) {
  natural_block_workers_kernel<XT><<<(unsigned)(n * nblk), block / 4, 0,
                                     (cudaStream_t)stream>>>(
      (const XT*)x, (const int32_t*)seeds, (int8_t*)codes, (float*)scales, nblk,
      block);
  return (int)cudaGetLastError();
}

extern "C" int natural_block_workers_f32(const void* x, const void* seeds, void* codes,
                                         void* scales, int n, long long nblk,
                                         int block, void* stream) {
  return launch_natural<float>(x, seeds, codes, scales, n, nblk, block, stream);
}

extern "C" int natural_block_workers_bf16(const void* x, const void* seeds,
                                          void* codes, void* scales, int n,
                                          long long nblk, int block, void* stream) {
  return launch_natural<__nv_bfloat16>(x, seeds, codes, scales, n, nblk, block,
                                       stream);
}

extern "C" int natural_dequant_mean(const void* codes, const void* scales, void* out,
                                    int n, long long nblk, int block, void* stream) {
  natural_dequant_mean_kernel<<<grid_for(nblk * block / 4, 256), 256, 0,
                                (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const float*)scales, (float*)out, n, nblk, block);
  return (int)cudaGetLastError();
}

template <typename XT, typename Map>
static int launch_absmax(const Map& map, long long rows, int width, void* stream) {
  const unsigned grid = grid_for(rows * 32, 256);  // 8 rows (warps) per CTA
  cudaStream_t st = (cudaStream_t)stream;
  switch (width) {
    case 32: absmax_quant_kernel<XT, 1><<<grid, 256, 0, st>>>(map, rows); break;
    case 64: absmax_quant_kernel<XT, 2><<<grid, 256, 0, st>>>(map, rows); break;
    case 128: absmax_quant_kernel<XT, 4><<<grid, 256, 0, st>>>(map, rows); break;
    case 256: absmax_quant_kernel<XT, 8><<<grid, 256, 0, st>>>(map, rows); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int absmax_quant_rows_f32(const void* x, void* codes, void* scales,
                                     long long rows, int width, void* stream) {
  const IdentityRows<float> map{(const float*)x, (int8_t*)codes, (float*)scales};
  return launch_absmax<float>(map, rows, width, stream);
}

extern "C" int absmax_quant_rows_bf16(const void* x, void* codes, void* scales,
                                      long long rows, int width, void* stream) {
  const IdentityRows<__nv_bfloat16> map{(const __nv_bfloat16*)x, (int8_t*)codes,
                                        (float*)scales};
  return launch_absmax<__nv_bfloat16>(map, rows, width, stream);
}

// k and v rows (tokens, kv, width) with token strides k_stride / v_stride
// (elements) → both pools of one layer at (page[t], row[t]), one launch.
template <typename XT>
static int launch_write_pages(const void* k, const void* v, long long k_stride,
                              long long v_stride, const void* page, const void* row,
                              void* kq, void* vq, void* k_scale, void* v_scale,
                              int tokens, int kv, int width, int npage, int psize,
                              void* stream) {
  const PagedRows<XT> map{(const XT*)k, (const XT*)v, k_stride, v_stride,
                          (const int32_t*)page, (const int32_t*)row, (int8_t*)kq,
                          (int8_t*)vq, (float*)k_scale, (float*)v_scale, tokens, kv,
                          npage, psize};
  return launch_absmax<XT>(map, 2LL * tokens * kv, width, stream);
}

extern "C" int absmax_quant_write_pages_f32(const void* k, const void* v,
                                            long long k_stride, long long v_stride,
                                            const void* page, const void* row, void* kq,
                                            void* vq, void* k_scale, void* v_scale,
                                            int tokens, int kv, int width, int npage,
                                            int psize, void* stream) {
  return launch_write_pages<float>(k, v, k_stride, v_stride, page, row, kq, vq, k_scale,
                                   v_scale, tokens, kv, width, npage, psize, stream);
}

extern "C" int absmax_quant_write_pages_bf16(const void* k, const void* v,
                                             long long k_stride, long long v_stride,
                                             const void* page, const void* row, void* kq,
                                             void* vq, void* k_scale, void* v_scale,
                                             int tokens, int kv, int width, int npage,
                                             int psize, void* stream) {
  return launch_write_pages<__nv_bfloat16>(k, v, k_stride, v_stride, page, row, kq, vq,
                                           k_scale, v_scale, tokens, kv, width, npage,
                                           psize, stream);
}

// rows·width < 2^34 (the wrapper checks it: the f32 output alone would
// exceed the card's memory), so every index below fits in 32 bits.
extern "C" int absmax_dequant_rows(const void* codes, const void* scales, void* out,
                                   long long rows, int width, void* stream) {
  const long long quads = rows * width / 4;
  const uint32_t groups = (uint32_t)((quads + 3) / 4);
  int shift = -1;
  if (width >= 16 && (width & (width - 1)) == 0)
    for (shift = 0; (1 << shift) < width; ++shift) {
    }
  absmax_dequant_rows_kernel<<<(groups + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const float*)scales, (float*)out, groups, (uint32_t)quads,
      (uint32_t)(width / 4), shift);
  return (int)cudaGetLastError();
}


template <typename XT>
static int launch_block_sumsq(const void* x, void* out, long long nblk, int block,
                              void* stream) {
  block_sumsq_kernel<XT><<<(unsigned)nblk, block / 4, 0, (cudaStream_t)stream>>>(
      (const XT*)x, (float*)out, block);
  return (int)cudaGetLastError();
}

extern "C" int block_sumsq_f32(const void* x, void* out, long long nblk, int block,
                               void* stream) {
  return launch_block_sumsq<float>(x, out, nblk, block, stream);
}

extern "C" int block_sumsq_bf16(const void* x, void* out, long long nblk, int block,
                                void* stream) {
  return launch_block_sumsq<__nv_bfloat16>(x, out, nblk, block, stream);
}

template <typename XT>
static int launch_qsgd_quantize(const void* x, const void* u, const void* norm, void* q,
                                long long size, int s, void* stream) {
  qsgd_quantize_kernel<XT><<<grid_for(size / 4, 256), 256, 0, (cudaStream_t)stream>>>(
      (const XT*)x, (const float*)u, (const float*)norm, (int8_t*)q, size / 4, (float)s);
  return (int)cudaGetLastError();
}

extern "C" int qsgd_quantize_f32(const void* x, const void* u, const void* norm, void* q,
                                 long long size, int s, void* stream) {
  return launch_qsgd_quantize<float>(x, u, norm, q, size, s, stream);
}

extern "C" int qsgd_quantize_bf16(const void* x, const void* u, const void* norm, void* q,
                                  long long size, int s, void* stream) {
  return launch_qsgd_quantize<__nv_bfloat16>(x, u, norm, q, size, s, stream);
}

extern "C" int qsgd_dequantize(const void* q, const void* norm, void* out, long long size,
                               int s, void* stream) {
  qsgd_dequantize_kernel<<<grid_for(size / 4, 256), 256, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)norm, (float*)out, size / 4, (float)s);
  return (int)cudaGetLastError();
}
