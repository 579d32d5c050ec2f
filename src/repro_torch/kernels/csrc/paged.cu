// Paged-KV single-query decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged.py::paged_attn_decode.
// There, grid step (s, p) DMAs page tables[s, p] of the pool into a per-slot
// VMEM cache through a scalar-prefetched index map, and the slot's last page
// step runs one masked softmax over all max_pages·P positions. Here one CTA
// serves one (slot, kv-head) pair: the rep = H / KV query heads of a GQA
// group share every K and V row the CTA loads, it reads its slot's block-table
// entries itself, and it walks only the pages that hold valid positions,
// p < ceil(n_valid[s] / P). A masked logit is -1e30 exactly and its weight
// exp(-1e30 - m) is exactly 0 in f32, so skipping those positions is exact;
// nothing is ever read from a position at or past n_valid (page 0, the null
// page, holds the garbage idle slots write, and is never multiplied in).
//
// Bound: device-memory bytes. Every valid K and V row is read once (2·hd
// values per position and kv-head) for 2·rep·hd multiply-adds: about one
// operation per byte in f32, far below the card's ridge. The design keeps the
// K/V traffic at that floor: each warp loads whole rows (hd contiguous values,
// one coalesced load per 32 of them) and the rep heads reuse them from
// registers. One CTA per (slot, kv-head) leaves the
// card underfilled at small batch (128 CTAs at the serve shape), and each
// warp's trips through its positions are serial: the kernel is latency-bound
// there (PERF.md). The logits, then their exponentials, then the weights go
// to an (S, H, max_pages·P) f32 scratch the wrapper allocates (rep·n_valid·4
// bytes per CTA, each written and read three times, mostly in L2).
//
// Arithmetic, in the plain version's order (kernels/ref.py::paged_attend_ref),
// except for the order of the three sums:
// * logit = round_to_T(q·k) · scale, the dot product accumulated in f32 (lane
//   partial sums, then a butterfly over the warp), rounded to the pages' type
//   as the plain einsum's output is, then multiplied by scale = f32(1/√hd);
// * the two-pass softmax of jax.nn.softmax: m = max, e = expf(l − m) (not
//   __expf), sum, then w = e / sum (a true division, once per head and
//   position);
// * w rounded to v's type before the PV product, accumulated in f32 per warp,
//   the warps' partial sums added in order, the output rounded to v's type.
// Torch's einsums run on cuBLAS, whose summation order is not this one: the
// kernel is held to its plain version within a bound (ROADMAP C), not bit for
// bit.
//
// Head h reads kv-head h / rep (the reference's jnp.repeat(k, rep, axis=1)).
// n_valid[s] ≤ 0 masks every position, as in the reference: the softmax is
// then uniform over all max_pages·P positions of the row. n_valid[s] is
// clamped to max_pages·P.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError(); an
// unsupported (hd, rep) returns cudaErrorInvalidValue. The wrapper checks
// shapes, types and alignment.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

constexpr int kWarps = 8;  // warps per CTA

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// round an f32 value to T and back (identity for f32)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Sum across the warp; every lane ends with the same value (a + b = b + a).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, h));
  return v;
}

// E = hd / 32 values per lane (lane l holds d = e·32 + l), REP = H / KV.
template <typename T, int E, int REP>
__global__ void __launch_bounds__(kWarps * 32)
paged_attn_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                         const T* __restrict__ vp, const int32_t* __restrict__ tables,
                         const int32_t* __restrict__ n_valid, float* __restrict__ scratch,
                         T* __restrict__ out, int H, int KV, int P, int maxp,
                         float scale) {
  constexpr int HD = 32 * E;
  __shared__ float red[kWarps][REP];
  __shared__ float stat[2][REP];  // the block's max, then its sum
  __shared__ float acc_s[kWarps][REP][HD];

  const int s = blockIdx.x / KV;
  const int g = blockIdx.x % KV;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int L = maxp * P;
  int n = n_valid[s];
  const bool all_masked = n <= 0;  // every logit −1e30: uniform over L
  n = (all_masked || n > L) ? L : n;
  const int32_t* trow = tables + (int64_t)s * maxp;
  const int64_t row_stride = (int64_t)KV * HD;  // one (page, row) of the pool
  float* lg = scratch + ((int64_t)s * H + (int64_t)g * REP) * L;  // REP rows of L

  float qr[REP][E];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[r][e] = to_f32(q[((int64_t)s * H + g * REP + r) * HD + e * 32 + lane]);

  // pass 1: logits and their max; warp w takes positions w, w + 8, w + 16, …
  float m[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) m[r] = -CUDART_INF_F;
  for (int t = warp; t < n; t += kWarps) {
    const T* krow = kp + ((int64_t)trow[t / P] * P + t % P) * row_stride + (int64_t)g * HD;
    float kv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) kv[e] = to_f32(krow[e * 32 + lane]);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float d = __fmul_rn(qr[r][0], kv[0]);
#pragma unroll
      for (int e = 1; e < E; ++e) d = __fadd_rn(d, __fmul_rn(qr[r][e], kv[e]));
      const float l = all_masked ? -1e30f : __fmul_rn(round_to<T>(warp_sum(d)), scale);
      if (lane == r) lg[(int64_t)r * L + t] = l;
      m[r] = fmaxf(m[r], l);
    }
  }
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < REP; ++r) red[warp][r] = m[r];
  __syncthreads();
  if (threadIdx.x < REP) {
    float v = red[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) v = fmaxf(v, red[w][threadIdx.x]);
    stat[0][threadIdx.x] = v;
  }
  __syncthreads();

  // pass 2: e = exp(l − m) in place, and the sum
  float sum[REP];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float mr = stat[0][r];
    float acc = 0.0f;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const float ex = expf(__fsub_rn(lg[(int64_t)r * L + t], mr));
      lg[(int64_t)r * L + t] = ex;
      acc = __fadd_rn(acc, ex);
    }
    sum[r] = warp_sum(acc);
  }
  __syncthreads();  // red is reused below
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < REP; ++r) red[warp][r] = sum[r];
  __syncthreads();
  if (threadIdx.x < REP) {
    float v = red[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) v = __fadd_rn(v, red[w][threadIdx.x]);
    stat[1][threadIdx.x] = v;
  }
  __syncthreads();

  // pass 2b: the weights w = round_to_T(e / sum) in place: one division per
  // (head, position), which the 32 lanes of pass 3 then share
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float den = stat[1][r];
    for (int t = threadIdx.x; t < n; t += blockDim.x)
      lg[(int64_t)r * L + t] = round_to<T>(__fdiv_rn(lg[(int64_t)r * L + t], den));
  }
  __syncthreads();

  // pass 3: out = Σ_t w_t·v_t, positions split over the warps as in pass 1
  // (each warp adds its own in increasing t)
  float acc[REP][E];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.0f;
  for (int t = warp; t < n; t += kWarps) {
    const T* vrow = vp + ((int64_t)trow[t / P] * P + t % P) * row_stride + (int64_t)g * HD;
    float vv[E];
#pragma unroll
    for (int e = 0; e < E; ++e) vv[e] = to_f32(vrow[e * 32 + lane]);
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float w = lg[(int64_t)r * L + t];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] = __fadd_rn(acc[r][e], __fmul_rn(w, vv[e]));
    }
  }
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc_s[warp][r][e * 32 + lane] = acc[r][e];
  __syncthreads();
  for (int i = threadIdx.x; i < REP * HD; i += blockDim.x) {
    const int r = i / HD, d = i % HD;
    float v = acc_s[0][r][d];
    for (int w = 1; w < kWarps; ++w) v = __fadd_rn(v, acc_s[w][r][d]);
    out[((int64_t)s * H + g * REP + r) * HD + d] = from_f32<T>(v);
  }
}

template <typename T, int E, int REP>
static int launch_rep(const void* q, const void* kp, const void* vp, const void* tables,
                      const void* n_valid, void* scratch, void* out, int S, int H,
                      int KV, int P, int maxp, float scale, cudaStream_t st) {
  paged_attn_decode_kernel<T, E, REP><<<(unsigned)(S * KV), kWarps * 32, 0, st>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int32_t*)tables,
      (const int32_t*)n_valid, (float*)scratch, (T*)out, H, KV, P, maxp, scale);
  return (int)cudaGetLastError();
}

template <typename T, int E>
static int launch_hd(const void* q, const void* kp, const void* vp, const void* tables,
                     const void* n_valid, void* scratch, void* out, int S, int H, int KV,
                     int P, int maxp, float scale, cudaStream_t st) {
  switch (H / KV) {
    case 1: return launch_rep<T, E, 1>(q, kp, vp, tables, n_valid, scratch, out, S, H, KV, P, maxp, scale, st);
    case 2: return launch_rep<T, E, 2>(q, kp, vp, tables, n_valid, scratch, out, S, H, KV, P, maxp, scale, st);
    case 4: return launch_rep<T, E, 4>(q, kp, vp, tables, n_valid, scratch, out, S, H, KV, P, maxp, scale, st);
    case 8: return launch_rep<T, E, 8>(q, kp, vp, tables, n_valid, scratch, out, S, H, KV, P, maxp, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int launch_paged(const void* q, const void* kp, const void* vp, const void* tables,
                        const void* n_valid, void* scratch, void* out, int S, int H,
                        int KV, int P, int maxp, int hd, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S <= 0 || KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32: return launch_hd<T, 1>(q, kp, vp, tables, n_valid, scratch, out, S, H, KV, P, maxp, scale, st);
    case 64: return launch_hd<T, 2>(q, kp, vp, tables, n_valid, scratch, out, S, H, KV, P, maxp, scale, st);
    case 128: return launch_hd<T, 4>(q, kp, vp, tables, n_valid, scratch, out, S, H, KV, P, maxp, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int paged_attn_decode_f32(const void* q, const void* kp, const void* vp,
                                     const void* tables, const void* n_valid,
                                     void* scratch, void* out, int S, int H, int KV,
                                     int P, int maxp, int hd, float scale,
                                     void* stream) {
  return launch_paged<float>(q, kp, vp, tables, n_valid, scratch, out, S, H, KV, P,
                             maxp, hd, scale, stream);
}

extern "C" int paged_attn_decode_bf16(const void* q, const void* kp, const void* vp,
                                      const void* tables, const void* n_valid,
                                      void* scratch, void* out, int S, int H, int KV,
                                      int P, int maxp, int hd, float scale,
                                      void* stream) {
  return launch_paged<__nv_bfloat16>(q, kp, vp, tables, n_valid, scratch, out, S, H,
                                     KV, P, maxp, hd, scale, stream);
}
