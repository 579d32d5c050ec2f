// Fused server epilogues for Hopper (sm_90a): finish a MARINA round in one
// sweep over the (nblk, B) buffers — aggregate, g' = g + δ, x' = (−γ)·g' + x.
//
// Replaces the Pallas TPU kernels src/repro/kernels/epilogue.py::scatter_epilogue
// (seeded-RandK payloads, carry compressed rounds), ::mean_epilogue (packed
// worker gradients, carry sync rounds), ::delta_epilogue (an already-dense
// round delta: the PermK aggregate on carry compressed rounds) and
// ::qsgd_epilogue (packed-QSGD payloads: int8 levels + per-block norms, the
// QSGD uplink's and the compressed downlink's carry rounds) and
// ::natural_epilogue (natural-compression payloads: int8 exponent-delta codes
// + per-block power-of-two scales, the same two uses), and the robust pair
// ::trimmed_delta_epilogue / ::trimmed_sync_epilogue (the coordinate-wise
// trimmed mean or median of n per-worker rows, carry compressed / sync
// rounds under a trimmed_mean or coordinate_median aggregator). Where the TPU
// version scatters through one-hot MXU matmuls, scatter_epilogue adds into a
// shared-memory row.
//
// All five are bound by device-memory bytes: each reads g (or the n gradient
// rows, or δ and g, or the n int8 payloads and g) and x once and writes g' and
// x' once; the arithmetic is a few flops per coordinate (qsgd_epilogue adds an
// IEEE divide per worker per warp and one per coordinate; natural_epilogue
// decodes each code with one multiply by a power of two built from bits, and
// divides once per coordinate; both move every coordinate in 16-byte accesses
// and start all their loads at once: see their kernels; the trimmed pair
// sorts n values per coordinate in registers). The x update rounds the
// multiply and the add separately (__fmul_rn, __fadd_rn) — an FMA would differ
// from the oracle in the last bit.
//
// x is f32 or bf16 (XT); g, g' and the accumulation are f32. x' is rounded to
// XT to nearest even.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant.cuh"
#include "scatter.cuh"

__device__ __forceinline__ float load_x(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_x(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_x(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// x' = (−γ)·g' + x, rounded separately
__device__ __forceinline__ float apply_update(float neg_gamma, float g_new, float x) {
  return __fadd_rn(__fmul_rn(neg_gamma, g_new), x);
}

// One CTA per block b: scatter-accumulate the n worker payloads in the oracle's
// order, then g' = g + acc/n and the x update for the block's B coordinates.
template <typename XT>
__global__ void scatter_epilogue_kernel(const float* __restrict__ vals,
                                        const int32_t* __restrict__ offs,
                                        const float* __restrict__ g,
                                        const XT* __restrict__ x,
                                        float* __restrict__ g_out,
                                        XT* __restrict__ x_out, int n,
                                        int64_t nblk, int block, int kb,
                                        float neg_gamma) {
  extern __shared__ float smem[];
  float* acc = smem;
  float* sv = acc + block;
  int32_t* so = reinterpret_cast<int32_t*>(sv + n * kb);
  const int64_t b = blockIdx.x;
  scatter_block(vals, offs, acc, sv, so, n, nblk, block, kb, b);
  const float fn = (float)n;
  for (int j = threadIdx.x; j < block; j += blockDim.x) {
    const int64_t i = b * block + j;
    const float g_new = __fadd_rn(g[i], __fdiv_rn(acc[j], fn));
    g_out[i] = g_new;
    store_x(x_out, i, apply_update(neg_gamma, g_new, load_x(x, i)));
  }
}

// One thread per coordinate: g' = (Σ_{w=0..n−1} g_w) / n summed in order from
// 0, then the x update.
template <typename XT>
__global__ void mean_epilogue_kernel(const float* __restrict__ gbufs,
                                     const XT* __restrict__ x,
                                     float* __restrict__ g_out,
                                     XT* __restrict__ x_out, int n,
                                     int64_t size, float neg_gamma) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const float fn = (float)n;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < size;
       i += stride) {
    float acc = 0.0f;
    for (int w = 0; w < n; ++w) acc = __fadd_rn(acc, gbufs[(int64_t)w * size + i]);
    const float g_new = __fdiv_rn(acc, fn);
    g_out[i] = g_new;
    store_x(x_out, i, apply_update(neg_gamma, g_new, load_x(x, i)));
  }
}

// One thread per coordinate: g' = g + δ, then the x update.
template <typename XT>
__global__ void delta_epilogue_kernel(const float* __restrict__ delta,
                                      const float* __restrict__ g,
                                      const XT* __restrict__ x,
                                      float* __restrict__ g_out,
                                      XT* __restrict__ x_out, int64_t size,
                                      float neg_gamma) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < size;
       i += stride) {
    const float g_new = __fadd_rn(g[i], delta[i]);
    g_out[i] = g_new;
    store_x(x_out, i, apply_update(neg_gamma, g_new, load_x(x, i)));
  }
}

// 4 contiguous coordinates of x as f32 (one 16-byte or 8-byte load), and x'
// rounded to XT to nearest even (one 16-byte or 8-byte store)
__device__ __forceinline__ float4 load_x4(const float* p, int64_t q) {
  return reinterpret_cast<const float4*>(p)[q];
}
__device__ __forceinline__ float4 load_x4(const __nv_bfloat16* p, int64_t q) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[q];
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}
__device__ __forceinline__ void store_x4(float* p, int64_t q, float4 v) {
  reinterpret_cast<float4*>(p)[q] = v;
}
__device__ __forceinline__ void store_x4(__nv_bfloat16* p, int64_t q, float4 v) {
  __nv_bfloat162 a, b;
  a.x = __float2bfloat16_rn(v.x);
  a.y = __float2bfloat16_rn(v.y);
  b.x = __float2bfloat16_rn(v.z);
  b.y = __float2bfloat16_rn(v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  reinterpret_cast<uint2*>(p)[q] = u;
}

// How a packed payload (int8 codes + one f32 per (worker, block) row)
// decodes in packed_epilogue_kernel: row_scale turns the row's f32 into the
// scale the warp shares, add adds four decoded coordinates, each operation
// rounded once. Each name holds its wrapper's, which chip_smoke.py's profile
// matches. QSGD: level l under norm_w as l·(norm_w / s) (dequant_sum4's
// order, quant.cuh).
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

// qsgd_epilogue and natural_epilogue: one thread per 4 contiguous coordinates
// (quad q), every access contiguous across the warp: g and g' as float4 (512 B
// a warp instruction), x and x' as float4 (f32) or 4 × bf16 in 8 bytes, each
// worker's codes as one char4 (128 B). The design it replaces read and wrote
// g, x, g' and x' one coordinate at a time in a loop over the thread's four,
// so each warp instruction spanned 512 B at a 16-byte stride for 128 useful
// bytes, and each store wrote its sectors partly, four times over (2.1× the
// byte bound at n = 4 and as slow at n = 1, PERF.md). B ≥ 128
// (check_qsgd_block, check_natural_block) makes the quad count a multiple of
// 32, so every warp is full and its 128 coordinates lie in one block b: lane w
// reads row w's f32 once and computes its row_scale, and the warp shares it
// by shuffles, in place of n loads (and, for QSGD, n divides) a thread. With
// coalesced accesses alone the QSGD kernel was still latency-bound (bf16 x as
// slow as f32, 1.4–1.5× its bound): the code loads sat in a loop whose trip
// count is the runtime n, behind the row load and divide, so a thread waited
// for two memory round trips. For NW = n ≤ 4 (every count the paths give
// them: the uplink's 4, the downlink's 1) the workers are unrolled and every
// load (codes, g, x, the row's f32) is started before any is used; NW = 0
// keeps the runtime loop, 32 workers a round of shuffles. The sum runs from
// +0, worker by worker, then g + acc / n and (−γ)·g' + x, each operation
// rounded once, so g' and x' are bit-equal to the plain versions.
template <typename XT, int NW, typename Decode>
__global__ void packed_epilogue_kernel(const int8_t* __restrict__ codes,
                                       const float* __restrict__ rows,
                                       const float* __restrict__ g,
                                       const XT* __restrict__ x,
                                       float* __restrict__ g_out,
                                       XT* __restrict__ x_out, int n, int64_t nblk,
                                       int block, Decode dec, float neg_gamma) {
  const int64_t quads = nblk * block / 4;
  const int qshift = __ffs(block) - 3;  // B = 2^(qshift + 2): quad q lies in block q >> qshift
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;  // a multiple of 32
  const float fn = (float)n;
  const char4* cv = reinterpret_cast<const char4*>(codes);
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < quads;
       q += stride) {  // warp-uniform: quads and q − lane are multiples of 32
    const int64_t b = q >> qshift;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 gv, xv;
    if constexpr (NW > 0) {
      char4 c[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) c[w] = cv[(int64_t)w * quads + q];
      gv = reinterpret_cast<const float4*>(g)[q];
      xv = load_x4(x, q);
      const float mine = dec.row_scale(lane < NW ? rows[(int64_t)lane * nblk + b] : 0.0f);
#pragma unroll
      for (int w = 0; w < NW; ++w) dec.add(acc, c[w], __shfl_sync(0xffffffffu, mine, w));
    } else {
      gv = reinterpret_cast<const float4*>(g)[q];
      xv = load_x4(x, q);
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
    float4 gn;
    gn.x = __fadd_rn(gv.x, __fdiv_rn(acc.x, fn));
    gn.y = __fadd_rn(gv.y, __fdiv_rn(acc.y, fn));
    gn.z = __fadd_rn(gv.z, __fdiv_rn(acc.z, fn));
    gn.w = __fadd_rn(gv.w, __fdiv_rn(acc.w, fn));
    reinterpret_cast<float4*>(g_out)[q] = gn;
    float4 xn;
    xn.x = apply_update(neg_gamma, gn.x, xv.x);
    xn.y = apply_update(neg_gamma, gn.y, xv.y);
    xn.z = apply_update(neg_gamma, gn.z, xv.z);
    xn.w = apply_update(neg_gamma, gn.w, xv.w);
    store_x4(x_out, q, xn);
  }
}

// ---------------------------------------------------------------------------
// Coordinate-wise trimmed mean over the worker rows
//
// One thread per coordinate: its n worker values, read at stride size from
// rows of f32 or bf16 (coalesced across the warp), are held in registers
// (n is a template parameter, 1..kTrimMaxN). As in the plain version
// (ref.trimmed_mean_rows_ref), NaN becomes +inf, an odd-even transposition
// network of n stages sorts the values with compare-selects that order −0
// below +0 (XLA's min / max; fminf / fmaxf follow another rule), and the
// window [lo, hi) is summed in sorted order from r[lo], then divided by
// hi − lo. The TPU kernel instead ranks the values and sums the kept ones in
// worker order, which rounds differently when hi − lo > 2.
// ---------------------------------------------------------------------------

constexpr int kTrimMaxN = 16;

__device__ __forceinline__ void compare_exchange(float& a, float& b) {
  const bool keep = a < b || (a == b && (__float_as_uint(a) >> 31));
  const float lo = keep ? a : b;
  const float hi = keep ? b : a;
  a = lo;
  b = hi;
}

template <int N, typename BT>
__device__ __forceinline__ float trimmed_coord(const BT* __restrict__ bufs,
                                               int64_t size, int64_t i, int lo,
                                               int hi) {
  float r[N];
#pragma unroll
  for (int w = 0; w < N; ++w) {
    const float v = load_x(bufs, (int64_t)w * size + i);
    r[w] = isnan(v) ? __int_as_float(0x7f800000) : v;
  }
#pragma unroll
  for (int stage = 0; stage < N; ++stage) {
#pragma unroll
    for (int j = stage % 2; j < N - 1; j += 2) compare_exchange(r[j], r[j + 1]);
  }
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (j == lo) acc = r[j];
    else if (j > lo && j < hi) acc = __fadd_rn(acc, r[j]);
  }
  return __fdiv_rn(acc, (float)(hi - lo));
}

// g' = g + trimmed mean (g given: carry compressed rounds) or the trimmed mean
// itself (g null: sync rounds), then the x update.
template <int N, typename BT, typename XT>
__global__ void trimmed_epilogue_kernel(const BT* __restrict__ bufs,
                                        const float* __restrict__ g,
                                        const XT* __restrict__ x,
                                        float* __restrict__ g_out,
                                        XT* __restrict__ x_out, int64_t size,
                                        int lo, int hi, float neg_gamma) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < size;
       i += stride) {
    const float t = trimmed_coord<N>(bufs, size, i, lo, hi);
    const float g_new = g != nullptr ? __fadd_rn(g[i], t) : t;
    g_out[i] = g_new;
    store_x(x_out, i, apply_update(neg_gamma, g_new, load_x(x, i)));
  }
}

static unsigned elementwise_grid(long long size, int threads) {
  long long grid = (size + threads - 1) / threads;
  if (grid > 1048576) grid = 1048576;  // grid-stride loop covers the rest
  return (unsigned)(grid < 1 ? 1 : grid);
}

template <typename XT>
static int launch_scatter(const void* vals, const void* offs, const void* g,
                          const void* x, void* g_out, void* x_out, int n,
                          long long nblk, int block, int kb, float neg_gamma,
                          void* stream) {
  const size_t smem = (size_t)block * sizeof(float) +
                      (size_t)n * kb * (sizeof(float) + sizeof(int32_t));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        scatter_epilogue_kernel<XT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  scatter_epilogue_kernel<XT><<<(unsigned)nblk, 128, smem, (cudaStream_t)stream>>>(
      (const float*)vals, (const int32_t*)offs, (const float*)g, (const XT*)x,
      (float*)g_out, (XT*)x_out, n, nblk, block, kb, neg_gamma);
  return (int)cudaGetLastError();
}

template <typename XT>
static int launch_mean(const void* gbufs, const void* x, void* g_out, void* x_out,
                       int n, long long size, float neg_gamma, void* stream) {
  mean_epilogue_kernel<XT><<<elementwise_grid(size, 256), 256, 0,
                             (cudaStream_t)stream>>>(
      (const float*)gbufs, (const XT*)x, (float*)g_out, (XT*)x_out, n, size,
      neg_gamma);
  return (int)cudaGetLastError();
}

template <typename XT>
static int launch_delta(const void* delta, const void* g, const void* x,
                        void* g_out, void* x_out, long long size, float neg_gamma,
                        void* stream) {
  delta_epilogue_kernel<XT><<<elementwise_grid(size, 256), 256, 0,
                              (cudaStream_t)stream>>>(
      (const float*)delta, (const float*)g, (const XT*)x, (float*)g_out,
      (XT*)x_out, size, neg_gamma);
  return (int)cudaGetLastError();
}

template <typename XT, typename Decode>
static int launch_packed(const void* codes, const void* rows, const void* g,
                         const void* x, void* g_out, void* x_out, int n, long long nblk,
                         int block, Decode dec, float neg_gamma, void* stream) {
  const unsigned grid = elementwise_grid(nblk * block / 4, 256);
  cudaStream_t st = (cudaStream_t)stream;
#define PACKED_LAUNCH(NW)                                                         \
  packed_epilogue_kernel<XT, NW, Decode><<<grid, 256, 0, st>>>(                    \
      (const int8_t*)codes, (const float*)rows, (const float*)g, (const XT*)x,     \
      (float*)g_out, (XT*)x_out, n, nblk, block, dec, neg_gamma)
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

extern "C" int scatter_epilogue_f32(const void* vals, const void* offs,
                                    const void* g, const void* x, void* g_out,
                                    void* x_out, int n, long long nblk, int block,
                                    int kb, float neg_gamma, void* stream) {
  return launch_scatter<float>(vals, offs, g, x, g_out, x_out, n, nblk, block, kb,
                               neg_gamma, stream);
}

extern "C" int scatter_epilogue_bf16(const void* vals, const void* offs,
                                     const void* g, const void* x, void* g_out,
                                     void* x_out, int n, long long nblk, int block,
                                     int kb, float neg_gamma, void* stream) {
  return launch_scatter<__nv_bfloat16>(vals, offs, g, x, g_out, x_out, n, nblk,
                                       block, kb, neg_gamma, stream);
}

extern "C" int mean_epilogue_f32(const void* gbufs, const void* x, void* g_out,
                                 void* x_out, int n, long long size,
                                 float neg_gamma, void* stream) {
  return launch_mean<float>(gbufs, x, g_out, x_out, n, size, neg_gamma, stream);
}

extern "C" int mean_epilogue_bf16(const void* gbufs, const void* x, void* g_out,
                                  void* x_out, int n, long long size,
                                  float neg_gamma, void* stream) {
  return launch_mean<__nv_bfloat16>(gbufs, x, g_out, x_out, n, size, neg_gamma,
                                    stream);
}

extern "C" int delta_epilogue_f32(const void* delta, const void* g, const void* x,
                                  void* g_out, void* x_out, long long size,
                                  float neg_gamma, void* stream) {
  return launch_delta<float>(delta, g, x, g_out, x_out, size, neg_gamma, stream);
}

extern "C" int delta_epilogue_bf16(const void* delta, const void* g, const void* x,
                                   void* g_out, void* x_out, long long size,
                                   float neg_gamma, void* stream) {
  return launch_delta<__nv_bfloat16>(delta, g, x, g_out, x_out, size, neg_gamma,
                                     stream);
}

extern "C" int qsgd_epilogue_f32(const void* levels, const void* norms, const void* g,
                                 const void* x, void* g_out, void* x_out, int n,
                                 long long nblk, int block, int s, float neg_gamma,
                                 void* stream) {
  return launch_packed<float>(levels, norms, g, x, g_out, x_out, n, nblk, block,
                              qsgd_epilogue_levels{(float)s}, neg_gamma, stream);
}

extern "C" int qsgd_epilogue_bf16(const void* levels, const void* norms, const void* g,
                                  const void* x, void* g_out, void* x_out, int n,
                                  long long nblk, int block, int s, float neg_gamma,
                                  void* stream) {
  return launch_packed<__nv_bfloat16>(levels, norms, g, x, g_out, x_out, n, nblk, block,
                                      qsgd_epilogue_levels{(float)s}, neg_gamma, stream);
}

extern "C" int natural_epilogue_f32(const void* codes, const void* scales, const void* g,
                                    const void* x, void* g_out, void* x_out, int n,
                                    long long nblk, int block, float neg_gamma,
                                    void* stream) {
  return launch_packed<float>(codes, scales, g, x, g_out, x_out, n, nblk, block,
                              natural_epilogue_codes{}, neg_gamma, stream);
}

extern "C" int natural_epilogue_bf16(const void* codes, const void* scales,
                                     const void* g, const void* x, void* g_out,
                                     void* x_out, int n, long long nblk, int block,
                                     float neg_gamma, void* stream) {
  return launch_packed<__nv_bfloat16>(codes, scales, g, x, g_out, x_out, n, nblk,
                                      block, natural_epilogue_codes{}, neg_gamma, stream);
}

template <typename BT, typename XT>
static int launch_trimmed(const void* bufs, const void* g, const void* x,
                          void* g_out, void* x_out, int n, long long size, int lo,
                          int hi, float neg_gamma, void* stream) {
  if (n < 1 || n > kTrimMaxN || lo < 0 || lo >= hi || hi > n)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = elementwise_grid(size, 256);
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
#define TRIM_CASE(N)                                                            \
  case N:                                                                       \
    trimmed_epilogue_kernel<N, BT, XT><<<grid, 256, 0, st>>>(                   \
        (const BT*)bufs, (const float*)g, (const XT*)x, (float*)g_out,          \
        (XT*)x_out, size, lo, hi, neg_gamma);                                   \
    break;
    TRIM_CASE(1) TRIM_CASE(2) TRIM_CASE(3) TRIM_CASE(4) TRIM_CASE(5) TRIM_CASE(6)
    TRIM_CASE(7) TRIM_CASE(8) TRIM_CASE(9) TRIM_CASE(10) TRIM_CASE(11)
    TRIM_CASE(12) TRIM_CASE(13) TRIM_CASE(14) TRIM_CASE(15) TRIM_CASE(16)
#undef TRIM_CASE
  }
  return (int)cudaGetLastError();
}

// bufs (n, size) in BT, g (size) f32, x (size) in XT → g', x'
#define TRIMMED_ENTRY(BNAME, BT, XNAME, XT)                                         \
  extern "C" int trimmed_delta_epilogue_##BNAME##_##XNAME(                          \
      const void* bufs, const void* g, const void* x, void* g_out, void* x_out,   \
      int n, long long size, int lo, int hi, float neg_gamma, void* stream) {      \
    if (g == nullptr) return (int)cudaErrorInvalidValue;                          \
    return launch_trimmed<BT, XT>(bufs, g, x, g_out, x_out, n, size, lo, hi,       \
                                  neg_gamma, stream);                             \
  }                                                                               \
  extern "C" int trimmed_sync_epilogue_##BNAME##_##XNAME(                           \
      const void* bufs, const void* x, void* g_out, void* x_out, int n,           \
      long long size, int lo, int hi, float neg_gamma, void* stream) {             \
    return launch_trimmed<BT, XT>(bufs, nullptr, x, g_out, x_out, n, size, lo, hi, \
                                  neg_gamma, stream);                             \
  }

TRIMMED_ENTRY(f32, float, f32, float)
TRIMMED_ENTRY(f32, float, bf16, __nv_bfloat16)
TRIMMED_ENTRY(bf16, __nv_bfloat16, f32, float)
TRIMMED_ENTRY(bf16, __nv_bfloat16, bf16, __nv_bfloat16)
#undef TRIMMED_ENTRY
