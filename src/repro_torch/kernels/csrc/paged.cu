// Paged-KV single-query decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged.py::paged_attn_decode.
// There, grid step (s, p) DMAs page tables[s, p] of the pool into a per-slot
// VMEM cache through a scalar-prefetched index map, and the slot's last page
// step runs one masked softmax over all max_pages·P positions.
//
// Bound: device-memory bytes. Every valid K and V row is read once (2·hd
// values per position and kv-head) for 2·rep·hd multiply-adds: about one
// operation per byte in f32 and two in bf16, far below the card's ridge. At
// decode's shapes the time is latency: few (slot, kv-head) pairs, each a
// serial walk over up to thousands of positions, and a few dependent global
// reads before the first byte of K arrives. The design:
//
// * A cluster of C CTAs (C ∈ {1, 2, 4, 8}, chosen by the wrapper from the
//   static shape, kernels/paged.py::launch_plan) serves one (slot, kv-head)
//   pair, so the grid is S·KV·C CTAs. The pv = ceil(n_valid / P) pages that
//   hold valid positions are split evenly: rank c takes pages
//   [c·pv/C, (c+1)·pv/C), so a short row keeps every rank equally busy
//   instead of leaving the ranks past n_valid waiting at the cluster's
//   barriers. A rank past the valid pages loads nothing.
// * Each CTA reads the slot's table row, q and n_valid at once, then stages
//   K, then V, in shared memory in tiles of 32 positions with cp.async (16
//   bytes a thread, one commit group a tile), in a ring of two: the next
//   tile's copy runs under this tile's products, and V's first tile is in
//   flight while the cluster agrees on the softmax. Each staged row is padded
//   by 16 bytes, so neither the row-per-thread reads nor ldmatrix meet bank
//   conflicts. A row past n_valid is zero-filled, never read.
// * Logits: f32 — each thread computes one (position, head, dim part) share
//   of a dot product from shared memory, the parts chosen so that all 256
//   threads work at any rep; bf16 — mma.sync.m16n8k16 with f32
//   accumulation, the staged K tile as A (16 positions × 16 dims through
//   ldmatrix) and Qᵀ as B (N = 8 ≥ rep heads). Tensor cores stay off for
//   f32: TF32 would break the f32 bound.
// * The rank's logits stay in shared memory (rep · ceil(maxp/C)·P floats at
//   most); there is no global scratch.
// * The softmax crosses the cluster through distributed shared memory
//   (cluster.map_shared_rank, cluster.sync): the row max is the max of the C
//   ranks' maxima; each rank writes e = expf(l − m) in place and sums its
//   share; the C partial sums are added in rank order; each rank writes its
//   weights round_T(e / Σ) in place.
// * PV: each rank accumulates a partial output in f32 — SIMT for f32 (one
//   thread per (dim, head, block of positions), four positions per read of
//   the weights), mma for
//   bf16 with Vᵀ as A (ldmatrix.trans) and the weights as B — and the C
//   partials are added in rank order through distributed shared memory, then
//   rounded to T once. A rank's C remote loads are issued together. A last
//   cluster.sync keeps every rank's shared memory alive until the others
//   have read it.
//
// Arithmetic, in the plain version's order (kernels/ref.py::paged_attend_ref),
// except for the order of the sums:
// * logit = round_to_T(q·k) · scale, the dot product accumulated in f32 and
//   rounded to the pages' type as the plain einsum's output is, then
//   multiplied by scale = f32(1/√hd). f32: hd split into 8/rep contiguous
//   parts; within a part four partial sums over d ≡ 0, 1, 2, 3 (mod 4), each
//   in increasing d, then (s0 + s1) + (s2 + s3); then the parts in order.
//   bf16: the tensor core's order within each 16-wide step, the steps in
//   order. Products and sums are rounded separately (__fmul_rn, __fadd_rn);
// * the two-pass softmax of jax.nn.softmax over all valid positions of the
//   row: m = max (exact in any order), e = expf(l − m) (not __expf), the sum
//   (within a rank: thread-strided sums, a warp butterfly, the warps in
//   order; then the ranks in order), then w = e / sum (a true division, once
//   per head and position);
// * w rounded to v's type before PV; PV accumulated in f32 within a rank
//   (f32: each 32-position tile cut into max(1, 256/(hd·rep)) blocks, a
//   block's positions in increasing order, tile after tile, then the blocks
//   in order; bf16: mma steps of 16 positions in increasing order), the
//   ranks' partials added in rank order, the output rounded to v's type once.
// Torch's einsums run on cuBLAS, whose summation order is not this one: the
// kernel is held to its plain version within a bound (ROADMAP C), not bit for
// bit. The flash-decoding combination (partial maxima, rescaled partial
// outputs) is not used: it would drop the rounding of the weights to v's type.
//
// Head h reads kv-head h / rep (the reference's jnp.repeat(k, rep, axis=1)).
// n_valid[s] ≤ 0 masks every position, as in the reference: the softmax is
// then uniform over all max_pages·P positions of the row. n_valid[s] is
// clamped to max_pages·P. Nothing at or past n_valid is read (page 0, the
// null page, holds the garbage idle slots write, and is never multiplied in).
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError(); an
// unsupported (hd, rep, C), or a shared-memory size that is not this
// layout's, returns cudaErrorInvalidValue. The wrapper checks shapes, types
// and alignment.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// The layout (kernels/paged.py repeats TILE, STAGES and SMALL), as tuned on
// the H100 (PERF.md, the kernel table): 32-position tiles in a ring of two
// (a deeper ring was slower); 256 threads for f32 pages (the SIMT products
// split over all of them), 128 for bf16 (four warps, two of which take the
// tile's mma rows).
constexpr int kTile = 32;                // positions per staged tile
constexpr int kStages = 2;               // tiles in the ring
constexpr int kSmall = 512;              // bytes: maxima, sums, the warps' partials
constexpr long long kMaxSmem = 232448;   // a CTA's shared memory on the H100
template <typename T> __host__ __device__ constexpr int threads_for() {
  return sizeof(T) == 4 ? 256 : 128;
}

// Dynamic shared memory of one CTA, in order: the ring of staged tiles (rows
// padded by 16 bytes), the partial output (rep × hd f32), q (rep × hd f32,
// f32 only), one float a thread for the split sums (f32 only), the small
// exchange area, the slot's table row (padded to 16
// bytes), and the logits (rep rows of ceil(maxp/C)·P f32, each padded to a
// multiple of 4). kernels/paged.py::smem_bytes repeats this sum.
static long long paged_smem_bytes(int elt, int hd, int rep, int P, int maxp, int C) {
  const long long ppr = (maxp + C - 1) / C;
  return (long long)kStages * kTile * (hd * elt + 16) +
         (long long)rep * hd * 4 * (elt == 4 ? 2 : 1) + (elt == 4 ? 4 * threads_for<float>() : 0) +
         kSmall + 16 * ((maxp + 3) / 4) + 16LL * rep * ((ppr * P + 3) / 4);
}

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, h));
  return v;
}

// acc + a·b, each operation rounded once (no FMA, as the plain version's
// products and sums)
__device__ __forceinline__ float mac(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global → shared, asynchronously; src_bytes = 0 zero-fills the
// destination and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// d += A·B: A 16×16 bf16 (row), B 16×8 bf16 (col), d 16×8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

constexpr int kMaxCluster = 8;  // the portable cluster size

// x[k] = *p in rank k's shared memory, for k < C: all C loads issued before
// any is used, so the ranks' latencies overlap.
__device__ __forceinline__ void gather_ranks(float (&x)[kMaxCluster], float* p, int C) {
#pragma unroll
  for (int k = 0; k < kMaxCluster; ++k)
    x[k] = k < C ? *cg::this_cluster().map_shared_rank(p, k) : 0.0f;
}

// Copy tile `it` (rank positions it·kTile …) of one kv-head's rows into ring
// slot it mod kStages, as one commit group (empty past the last tile, so that
// wait_group counts tiles). `col` points at the kv-head's column of page 0;
// a position's row lies row_bytes · (page·P + offset) past it. The thread's
// 16-byte chunk column is fixed, its rows step by RSTEP, and its page is
// followed incrementally (one division a tile). Rows past `cnt` are
// zero-filled, never read.
template <int ROW, int CH, int RSTEP>
__device__ __forceinline__ void stage_tile(unsigned char* ring, const unsigned char* col,
                                           int it, int ntiles, int cnt, int tid, int P,
                                           int p0, const int* tbl, int64_t row_bytes) {
  if (it >= ntiles) {
    cp_async_commit();
    return;
  }
  unsigned char* dst = ring + (it % kStages) * (kTile * ROW) + (tid % CH) * 16;
  col += (tid % CH) * 16;
  int r = tid / CH, t = it * kTile + r, pg = p0 + t / P, off = t % P;
  for (; r < kTile; r += RSTEP) {
    const bool ok = t < cnt;
    cp_async16(dst + r * ROW, ok ? col + ((int64_t)tbl[pg] * P + off) * row_bytes : col,
               ok ? 16 : 0);
    t += RSTEP;
    off += RSTEP;
    while (off >= P) {
      off -= P;
      ++pg;
    }
  }
  cp_async_commit();
}

// T = float or __nv_bfloat16, HD = head width, REP = H / KV (≤ 8).
// blockIdx.x = ((s·KV + g)·C + rank), one cluster of C CTAs per (s, g).
template <typename T, int HD, int REP>
__global__ void __launch_bounds__(threads_for<T>())
paged_attn_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                         const T* __restrict__ vp, const int32_t* __restrict__ tables,
                         const int32_t* __restrict__ n_valid, T* __restrict__ out, int H,
                         int KV, int P, int maxp, int C, float scale) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int NT = threads_for<T>();
  constexpr int NW = NT / 32;
  constexpr int ROW = HD * (int)sizeof(T) + 16;  // staged row stride, bytes
  constexpr int CH = HD * (int)sizeof(T) / 16;   // 16-byte chunks per row
  constexpr int RSTEP = NT / CH;                 // rows between a thread's chunks
  static_assert(NT % CH == 0 && kTile % RSTEP == 0 && kTile % 16 == 0, "tile layout");
  static_assert(kF32 ? NT % kTile == 0 && NT >= HD : NW * 16 >= kTile, "thread layout");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int pair = blockIdx.x / C;
  const int s = pair / KV, g = pair % KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;  // the mma fragments' row / column group
  const int L = maxp * P;
  const int ppr = (maxp + C - 1) / C;
  const int lc = (ppr * P + 3) / 4 * 4;  // logit slots per head

  unsigned char* ring = smem;
  float* part = reinterpret_cast<float*>(smem + kStages * kTile * ROW);  // [REP][HD]
  float* qs = part + REP * HD;                                       // [REP][HD], f32 only
  float* xs = qs + (kF32 ? REP * HD : 0);  // [NT] f32 only: the split sums' exchange
  float* small = xs + (kF32 ? NT : 0);
  float* smax = small;       // [8] this rank's maxima
  float* ssum = small + 8;   // [8] this rank's sums
  float* gmax = small + 16;  // [8] the row maxima
  float* gsum = small + 24;  // [8] the row sums
  float* red = small + 32;   // [NW][8] the warps' partials
  int* tbl = reinterpret_cast<int*>(small + kSmall / 4);
  float* lg = reinterpret_cast<float*>(tbl + 4 * ((maxp + 3) / 4));  // [REP][lc]

  // the slot's whole table row, q (f32) and n_valid are read at once
  for (int i = tid; i < maxp; i += NT) tbl[i] = tables[(int64_t)s * maxp + i];
  if constexpr (kF32)
    for (int i = tid; i < REP * HD; i += NT) qs[i] = q[((int64_t)s * H + g * REP) * HD + i];
  int n = n_valid[s];
  const bool all_masked = n <= 0;  // every logit −1e30: uniform over L
  n = (all_masked || n > L) ? L : n;
  // the pages that hold valid positions, split evenly: rank c takes pages
  // [c·pv/C, (c+1)·pv/C) (kernels/paged.py::rank_pages)
  const int pv = (n + P - 1) / P;
  const int p0 = (int)((long long)rank * pv / C);
  const int p1 = (int)((long long)(rank + 1) * pv / C);
  const int cnt = max(0, min(p1 * P, n) - p0 * P);  // this rank's valid positions
  const int ntiles = (cnt + kTile - 1) / kTile;
  __syncthreads();

  // the kv-head's column of K and V, and the bytes between a pool's rows
  const unsigned char* kbase = reinterpret_cast<const unsigned char*>(kp + (int64_t)g * HD);
  const unsigned char* vbase = reinterpret_cast<const unsigned char*>(vp + (int64_t)g * HD);
  const int64_t row_bytes = (int64_t)KV * HD * (int64_t)sizeof(T);
#define STAGE(base, it) \
  stage_tile<ROW, CH, RSTEP>(ring, base, it, ntiles, cnt, tid, P, p0, tbl, row_bytes)
  // bf16: Qᵀ as the B fragments, heads ≥ REP zero
  uint32_t qb[kF32 ? 1 : HD / 16][2];
  if constexpr (!kF32) {
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
        q + ((int64_t)s * H + g * REP + (gid < REP ? gid : 0)) * HD);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qb[kk][0] = gid < REP ? qrow[kk * 8 + tig] : 0u;
      qb[kk][1] = gid < REP ? qrow[kk * 8 + 4 + tig] : 0u;
    }
  }

  // pass 1: the rank's logits into lg
  if (all_masked) {
    for (int i = tid; i < REP * cnt; i += NT) lg[(i / cnt) * lc + i % cnt] = -1e30f;
  } else {
    for (int k = 0; k < kStages - 1; ++k) STAGE(kbase, k);
    for (int it = 0; it < ntiles; ++it) {
      STAGE(kbase, it + kStages - 1);
      cp_async_wait<kStages - 1>();  // tile it has landed
      __syncthreads();
      const unsigned char* buf = ring + (it % kStages) * (kTile * ROW);
      if constexpr (kF32) {
        // thread → position t = tid % kTile and group tid / kTile = (head r,
        // part dp) of the NG groups: dims [dp·DW, (dp+1)·DW) of head r, so
        // every thread works at any rep. Each part's sum as four partial sums over
        // d ≡ 0, 1, 2, 3 (mod 4) in increasing d, then (s0 + s1) + (s2 + s3);
        // the DP parts of a head then added in order.
        constexpr int NG = NT / kTile, DP = NG / REP, DW = HD / DP;
        static_assert(NG % REP == 0 && DW % 4 == 0, "f32 logits layout");
        const int t = tid % kTile, r = tid / kTile / DP, dp = tid / kTile % DP;
        const int pos = it * kTile + t;
        if (pos < cnt) {
          const float* krow = reinterpret_cast<const float*>(buf + t * ROW) + dp * DW;
          const float* qrow = qs + r * HD + dp * DW;
          float acc[4];
#pragma unroll
          for (int d4 = 0; d4 < DW; d4 += 4) {
            const float4 k4 = *reinterpret_cast<const float4*>(krow + d4);
            const float4 q4 = *reinterpret_cast<const float4*>(qrow + d4);
            if (d4 == 0) {
              acc[0] = __fmul_rn(q4.x, k4.x);
              acc[1] = __fmul_rn(q4.y, k4.y);
              acc[2] = __fmul_rn(q4.z, k4.z);
              acc[3] = __fmul_rn(q4.w, k4.w);
            } else {
              acc[0] = mac(acc[0], q4.x, k4.x);
              acc[1] = mac(acc[1], q4.y, k4.y);
              acc[2] = mac(acc[2], q4.z, k4.z);
              acc[3] = mac(acc[3], q4.w, k4.w);
            }
          }
          const float sum = __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
          if constexpr (DP == 1)
            lg[r * lc + pos] = __fmul_rn(sum, scale);
          else
            xs[tid] = sum;
        }
        if constexpr (DP > 1) {
          __syncthreads();
          if (tid < REP * kTile && it * kTile + tid % kTile < cnt) {
            const int tt = tid % kTile, rr = tid / kTile;
            float v = xs[rr * DP * kTile + tt];
#pragma unroll
            for (int k = 1; k < DP; ++k) v = __fadd_rn(v, xs[(rr * DP + k) * kTile + tt]);
            lg[rr * lc + it * kTile + tt] = __fmul_rn(v, scale);
          }
        }
      } else if (warp * 16 < kTile) {
        // warp w → positions 16w .. 16w + 15 of the tile: A = K (ldmatrix)
        const int pb = it * kTile + warp * 16;
        if (pb < cnt) {
          const int j = lane >> 3, i = lane & 7;
          const unsigned char* arow = buf + (warp * 16 + (j & 1) * 8 + i) * ROW + (j >> 1) * 16;
          float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(a, arow + kk * 32);
            mma_bf16(c, a, qb[kk][0], qb[kk][1]);
          }
          // c[0], c[1]: position pb + gid, heads 2·tig, 2·tig + 1; c[2], c[3]: pb + gid + 8
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 2 * tig + (e & 1), pos = pb + gid + (e >> 1) * 8;
            if (r < REP && pos < cnt) lg[r * lc + pos] = __fmul_rn(round_to<T>(c[e]), scale);
          }
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
  // V's first tiles fly under the softmax
  for (int k = 0; k < kStages - 1; ++k) STAGE(vbase, k);

  // the row max: this rank's, then the cluster's (exact in any order)
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float v = -CUDART_INF_F;
    for (int t = tid; t < cnt; t += NT) v = fmaxf(v, lg[r * lc + t]);
    v = warp_max(v);
    if (lane == 0) red[warp * 8 + r] = v;
  }
  __syncthreads();
  if (tid < REP) {
    float v = red[tid];
    for (int w = 1; w < NW; ++w) v = fmaxf(v, red[w * 8 + tid]);
    smax[tid] = v;
  }
  cluster.sync();
  if (tid < REP) {
    float x[kMaxCluster];
    gather_ranks(x, smax + tid, C);
    float v = x[0];
#pragma unroll
    for (int k = 1; k < kMaxCluster; ++k)
      if (k < C) v = fmaxf(v, x[k]);
    gmax[tid] = v;
  }
  __syncthreads();

  // e = exp(l − m) in place; the rank's sums, then the cluster's in rank order
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float m = gmax[r];
    float acc = 0.0f;
    for (int t = tid; t < cnt; t += NT) {
      const float ex = expf(__fsub_rn(lg[r * lc + t], m));
      lg[r * lc + t] = ex;
      acc = __fadd_rn(acc, ex);
    }
    acc = warp_sum(acc);
    if (lane == 0) red[warp * 8 + r] = acc;
  }
  __syncthreads();
  if (tid < REP) {
    float v = red[tid];
    for (int w = 1; w < NW; ++w) v = __fadd_rn(v, red[w * 8 + tid]);
    ssum[tid] = v;
  }
  cluster.sync();
  if (tid < REP) {
    float x[kMaxCluster];
    gather_ranks(x, ssum + tid, C);
    float v = x[0];
#pragma unroll
    for (int k = 1; k < kMaxCluster; ++k)
      if (k < C) v = __fadd_rn(v, x[k]);
    gsum[tid] = v;
  }
  __syncthreads();

  // the weights w = round_to_T(e / sum) in place: one division per (head, position)
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    const float den = gsum[r];
    for (int t = tid; t < cnt; t += NT)
      lg[r * lc + t] = round_to<T>(__fdiv_rn(lg[r * lc + t], den));
  }
  __syncthreads();

  // pass 2: the rank's partial output Σ_t w_t·v_t into part
  if constexpr (kF32) {
    // thread → dim d = tid % HD and group tid / HD: heads hg + NHG·j where
    // rep ≥ NHG, else (head r, position block p) of the NHG groups, so every
    // thread works at any rep. A thread adds its positions in increasing
    // order, four at a time (one float4 of weights per head); with PP
    // position blocks per tile (positions [p·BW, (p+1)·BW) of each tile), a
    // head's PP partial sums are then added in block order.
    constexpr int NHG = NT / HD;
    constexpr int PP = REP < NHG ? NHG / REP : 1;
    constexpr int RPT = REP < NHG ? 1 : REP / NHG;
    constexpr int BW = kTile / PP;
    const int d = tid % HD, hg = tid / HD;
    const int r0 = hg / PP, blk = hg % PP;
    float acc[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) acc[j] = 0.0f;
    for (int it = 0; it < ntiles; ++it) {
      STAGE(vbase, it + kStages - 1);
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const float* vcol =
          reinterpret_cast<const float*>(ring + (it % kStages) * (kTile * ROW)) + d;
      const float* wt = lg + it * kTile;
      const int tn = min((blk + 1) * BW, cnt - it * kTile);
      int t = blk * BW;
      for (; t + 4 <= tn; t += 4) {
        const float v0 = vcol[t * (ROW / 4)], v1 = vcol[(t + 1) * (ROW / 4)];
        const float v2 = vcol[(t + 2) * (ROW / 4)], v3 = vcol[(t + 3) * (ROW / 4)];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const float4 w = *reinterpret_cast<const float4*>(wt + (r0 + j * NHG) * lc + t);
          acc[j] = mac(mac(mac(mac(acc[j], w.x, v0), w.y, v1), w.z, v2), w.w, v3);
        }
      }
      for (; t < tn; ++t) {
        const float v = vcol[t * (ROW / 4)];
#pragma unroll
        for (int j = 0; j < RPT; ++j) acc[j] = mac(acc[j], wt[(r0 + j * NHG) * lc + t], v);
      }
      __syncthreads();
    }
    if constexpr (PP == 1) {
#pragma unroll
      for (int j = 0; j < RPT; ++j) part[(r0 + j * NHG) * HD + d] = acc[0 + j];
    } else {
      xs[tid] = acc[0];  // (head r0, block blk) row of HD partial sums
      __syncthreads();
      for (int i = tid; i < REP * HD; i += NT) {
        const int r = i / HD, dd = i % HD;
        float v = xs[r * PP * HD + dd];
#pragma unroll
        for (int k = 1; k < PP; ++k) v = __fadd_rn(v, xs[(r * PP + k) * HD + dd]);
        part[i] = v;
      }
    }
  } else {
    // warp w → dim tiles w, w + NW, … (16 dims each): A = Vᵀ (ldmatrix.trans),
    // B = the weights (16 positions × 8 heads), positions in steps of 16
    constexpr int NDT = HD / 16;
    constexpr int DPW = (NDT + NW - 1) / NW;
    float acc[DPW][4];
#pragma unroll
    for (int j = 0; j < DPW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    const int jm = lane >> 3, im = lane & 7;
    for (int it = 0; it < ntiles; ++it) {
      STAGE(vbase, it + kStages - 1);
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const unsigned char* buf = ring + (it % kStages) * (kTile * ROW);
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
        const int pb = it * kTile + ks * 16;
        if (pb >= cnt) break;
        uint32_t b0 = 0u, b1 = 0u;
        if (gid < REP) {
          const float* wr = lg + gid * lc;
          const int t0 = pb + 2 * tig, t1 = t0 + 8;
          b0 = pack_bf16(t0 < cnt ? wr[t0] : 0.0f, t0 + 1 < cnt ? wr[t0 + 1] : 0.0f);
          b1 = pack_bf16(t1 < cnt ? wr[t1] : 0.0f, t1 + 1 < cnt ? wr[t1 + 1] : 0.0f);
        }
#pragma unroll
        for (int j = 0; j < DPW; ++j) {
          const int dt = warp + j * NW;
          if (dt < NDT) {
            uint32_t a[4];
            ldmatrix_x4_trans(a, buf + (ks * 16 + (jm >> 1) * 8 + im) * ROW +
                                     (dt * 16 + (jm & 1) * 8) * 2);
            mma_bf16(acc[j], a, b0, b1);
          }
        }
      }
      __syncthreads();
    }
    // acc[j][0], [1]: dim 16·dt + gid, heads 2·tig, 2·tig + 1; [2], [3]: dim + 8
#pragma unroll
    for (int j = 0; j < DPW; ++j) {
      const int dt = warp + j * NW;
      if (dt < NDT) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 2 * tig + (e & 1), d = dt * 16 + gid + (e >> 1) * 8;
          if (r < REP) part[r * HD + d] = acc[j][e];
        }
      }
    }
  }

  // the ranks' partials in rank order, rounded to T once; rank c writes
  // outputs c·NT + tid, + C·NT, …
  cluster.sync();
  T* orow = out + ((int64_t)s * H + g * REP) * HD;
  for (int i = rank * NT + tid; i < REP * HD; i += C * NT) {
    float x[kMaxCluster];
    gather_ranks(x, part + i, C);
    float v = x[0];
#pragma unroll
    for (int k = 1; k < kMaxCluster; ++k)
      if (k < C) v = __fadd_rn(v, x[k]);
    orow[i] = from_f32<T>(v);
  }
  cluster.sync();  // no rank leaves while another still reads its part
#undef STAGE
}

template <typename T, int HD, int REP>
static int launch_rep(const void* q, const void* kp, const void* vp, const void* tables,
                      const void* n_valid, void* out, int S, int H, int KV, int P, int maxp,
                      float scale, int C, int smem, cudaStream_t st) {
  auto kern = paged_attn_decode_kernel<T, HD, REP>;
  if (smem != paged_smem_bytes((int)sizeof(T), HD, REP, P, maxp, C) || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  static int smem_set = 48 * 1024;  // the most this instantiation was allowed so far
  if (smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(S * KV * C));
  cfg.blockDim = dim3(threads_for<T>());
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, (const T*)q, (const T*)kp, (const T*)vp, (const int32_t*)tables,
      (const int32_t*)n_valid, (T*)out, H, KV, P, maxp, C, scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, int HD>
static int launch_hd(const void* q, const void* kp, const void* vp, const void* tables,
                     const void* n_valid, void* out, int S, int H, int KV, int P, int maxp,
                     float scale, int C, int smem, cudaStream_t st) {
  switch (H / KV) {
    case 1: return launch_rep<T, HD, 1>(q, kp, vp, tables, n_valid, out, S, H, KV, P, maxp, scale, C, smem, st);
    case 2: return launch_rep<T, HD, 2>(q, kp, vp, tables, n_valid, out, S, H, KV, P, maxp, scale, C, smem, st);
    case 4: return launch_rep<T, HD, 4>(q, kp, vp, tables, n_valid, out, S, H, KV, P, maxp, scale, C, smem, st);
    case 8: return launch_rep<T, HD, 8>(q, kp, vp, tables, n_valid, out, S, H, KV, P, maxp, scale, C, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int launch_paged(const void* q, const void* kp, const void* vp, const void* tables,
                        const void* n_valid, void* out, int S, int H, int KV, int P,
                        int maxp, int hd, float scale, int C, int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S <= 0 || KV <= 0 || H % KV || P <= 0 || maxp <= 0) return (int)cudaErrorInvalidValue;
  if (C != 1 && C != 2 && C != 4 && C != 8) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32: return launch_hd<T, 32>(q, kp, vp, tables, n_valid, out, S, H, KV, P, maxp, scale, C, smem, st);
    case 64: return launch_hd<T, 64>(q, kp, vp, tables, n_valid, out, S, H, KV, P, maxp, scale, C, smem, st);
    case 128: return launch_hd<T, 128>(q, kp, vp, tables, n_valid, out, S, H, KV, P, maxp, scale, C, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int paged_attn_decode_f32(const void* q, const void* kp, const void* vp,
                                     const void* tables, const void* n_valid, void* out,
                                     int S, int H, int KV, int P, int maxp, int hd,
                                     float scale, int C, int smem, void* stream) {
  return launch_paged<float>(q, kp, vp, tables, n_valid, out, S, H, KV, P, maxp, hd, scale,
                             C, smem, stream);
}

extern "C" int paged_attn_decode_bf16(const void* q, const void* kp, const void* vp,
                                      const void* tables, const void* n_valid, void* out,
                                      int S, int H, int KV, int P, int maxp, int hd,
                                      float scale, int C, int smem, void* stream) {
  return launch_paged<__nv_bfloat16>(q, kp, vp, tables, n_valid, out, S, H, KV, P, maxp, hd,
                                     scale, C, smem, stream);
}

