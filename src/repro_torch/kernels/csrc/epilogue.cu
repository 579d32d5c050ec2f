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
// IEEE divide per worker per 4 coordinates and one per coordinate, whose
// instruction time is not small beside its bytes: PERF.md; natural_epilogue
// decodes each code with one multiply by a power of two built from bits, and
// divides once per coordinate; the trimmed pair sorts n values per
// coordinate in registers). The x update rounds the
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

// One thread per 4 coordinates: the dequantize-and-mean of qsgd_dequant_mean
// (quant.cuh), then g' = g + acc/n and the x update.
template <typename XT>
__global__ void qsgd_epilogue_kernel(const int8_t* __restrict__ levels,
                                     const float* __restrict__ norms,
                                     const float* __restrict__ g,
                                     const XT* __restrict__ x,
                                     float* __restrict__ g_out,
                                     XT* __restrict__ x_out, int n, int64_t nblk,
                                     int block, float s, float neg_gamma) {
  const int64_t size = nblk * block;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const float fn = (float)n;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < size / 4;
       q += stride) {
    const int64_t i0 = 4 * q;
    float acc[4];
    dequant_sum4(levels, norms, n, nblk, size, i0 / block, i0, s, acc);
    for (int k = 0; k < 4; ++k) {
      const float g_new = __fadd_rn(g[i0 + k], __fdiv_rn(acc[k], fn));
      g_out[i0 + k] = g_new;
      store_x(x_out, i0 + k, apply_update(neg_gamma, g_new, load_x(x, i0 + k)));
    }
  }
}

// One thread per 4 coordinates: the n natural payloads decoded and summed in
// order (quant.cuh), then g' = g + acc/n and the x update.
template <typename XT>
__global__ void natural_epilogue_kernel(const int8_t* __restrict__ codes,
                                        const float* __restrict__ scales,
                                        const float* __restrict__ g,
                                        const XT* __restrict__ x,
                                        float* __restrict__ g_out,
                                        XT* __restrict__ x_out, int n, int64_t nblk,
                                        int block, float neg_gamma) {
  const int64_t size = nblk * block;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const float fn = (float)n;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < size / 4;
       q += stride) {
    const int64_t i0 = 4 * q;
    float acc[4];
    natural_sum4(codes, scales, n, nblk, size, i0 / block, i0, acc);
    for (int k = 0; k < 4; ++k) {
      const float g_new = __fadd_rn(g[i0 + k], __fdiv_rn(acc[k], fn));
      g_out[i0 + k] = g_new;
      store_x(x_out, i0 + k, apply_update(neg_gamma, g_new, load_x(x, i0 + k)));
    }
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

template <typename XT>
static int launch_qsgd(const void* levels, const void* norms, const void* g,
                       const void* x, void* g_out, void* x_out, int n,
                       long long nblk, int block, int s, float neg_gamma,
                       void* stream) {
  qsgd_epilogue_kernel<XT><<<elementwise_grid(nblk * block / 4, 256), 256, 0,
                             (cudaStream_t)stream>>>(
      (const int8_t*)levels, (const float*)norms, (const float*)g, (const XT*)x,
      (float*)g_out, (XT*)x_out, n, nblk, block, (float)s, neg_gamma);
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
  return launch_qsgd<float>(levels, norms, g, x, g_out, x_out, n, nblk, block, s,
                            neg_gamma, stream);
}

extern "C" int qsgd_epilogue_bf16(const void* levels, const void* norms, const void* g,
                                  const void* x, void* g_out, void* x_out, int n,
                                  long long nblk, int block, int s, float neg_gamma,
                                  void* stream) {
  return launch_qsgd<__nv_bfloat16>(levels, norms, g, x, g_out, x_out, n, nblk, block,
                                    s, neg_gamma, stream);
}

template <typename XT>
static int launch_natural(const void* codes, const void* scales, const void* g,
                          const void* x, void* g_out, void* x_out, int n,
                          long long nblk, int block, float neg_gamma, void* stream) {
  natural_epilogue_kernel<XT><<<elementwise_grid(nblk * block / 4, 256), 256, 0,
                                (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const float*)scales, (const float*)g, (const XT*)x,
      (float*)g_out, (XT*)x_out, n, nblk, block, neg_gamma);
  return (int)cudaGetLastError();
}

extern "C" int natural_epilogue_f32(const void* codes, const void* scales, const void* g,
                                    const void* x, void* g_out, void* x_out, int n,
                                    long long nblk, int block, float neg_gamma,
                                    void* stream) {
  return launch_natural<float>(codes, scales, g, x, g_out, x_out, n, nblk, block,
                               neg_gamma, stream);
}

extern "C" int natural_epilogue_bf16(const void* codes, const void* scales,
                                     const void* g, const void* x, void* g_out,
                                     void* x_out, int n, long long nblk, int block,
                                     float neg_gamma, void* stream) {
  return launch_natural<__nv_bfloat16>(codes, scales, g, x, g_out, x_out, n, nblk,
                                       block, neg_gamma, stream);
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
