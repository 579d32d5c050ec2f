// Random-gather yardsticks for Hopper (sm_90a): bare gathers of 4-byte
// values at random offsets, beside which the RandK and PermK gathers are
// timed.
//
// No path of the port calls these kernels, and they are not a port of a TPU
// kernel: chip_smoke.py and scripts/serve_kernels_ab.py time them beside the
// gathers. A 4-byte load at a random offset pulls at least a 32-byte sector
// from device memory, so a gather's byte bound (4 bytes a value read) is not
// a time the card can reach; these kernels do the same number of loads with
// as little else as possible. Their fastest time is a yardstick, not a lower
// bound: a kernel whose offsets or pace of issue suit the memory better can
// beat it.
//
// * yardstick_gather: for every flat index k < rows·kb, one 4-byte load at
//   an offset inside row r = k / kb (a row of B f32, 4 KiB at B = 1024) and
//   8 bytes written (the value, the offset), as randk_seeded_workers writes
//   them. The row comes from a multiply-high by the host's
//   ceil(2^32 / kb), exact over every k the wrapper allows, so there is no
//   integer division. The offset is ⌊h·B / 2^32⌋ of h = (k·k)·0x9E3779B9
//   (a multiply-high: the top lg(B) bits of h where B is a power of two,
//   any row width B ≥ 2 otherwise, as the transport's 2816-wide leaves):
//   one multiply of k alone gives Fibonacci-spaced offsets, 20 distinct
//   32-byte sectors in every row of 20, where a random draw (and
//   randk_seeded_workers' murmur3 offsets) touches 18.6; the square spreads
//   them as a random draw does (tests/test_torch_yardstick.py). Each
//   thread issues its U loads before any store.
// * yardstick_affine: permk_seeded_workers' gather done directly: one CTA a
//   block b, a = (murmur(seed, 2b) | 1) & (B − 1), c = murmur(seed, 2b + 1)
//   & (B − 1), and worker w's B/n slots t ∈ [w·B/n, (w + 1)·B/n) load x[w,
//   b, (a·t + c) & (B − 1)] and write the value and the offset (unscaled).
//   B/n is a power of two.
//
// C interface (loaded with ctypes): each entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "murmur.cuh"

template <int U>
__global__ void yardstick_gather_kernel(const float* __restrict__ x,
                                        float* __restrict__ vals,
                                        int32_t* __restrict__ offs, uint32_t total,
                                        int block, int kb, uint32_t magic) {
  const uint32_t base = blockIdx.x * (U * blockDim.x) + threadIdx.x;
  float v[U];
  uint32_t off[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const uint32_t k = base + j * blockDim.x;
    if (k < total) {
      const uint32_t r = kb == 1 ? k : __umulhi(k, magic);
      off[j] = __umulhi(k * k * 0x9E3779B9u, (uint32_t)block);
      v[j] = x[(int64_t)r * block + off[j]];
    }
  }
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const uint32_t k = base + j * blockDim.x;
    if (k < total) {
      vals[k] = v[j];
      offs[k] = (int32_t)off[j];
    }
  }
}

template <int U>
__global__ void yardstick_affine_kernel(const float* __restrict__ x, uint32_t seed,
                                        float* __restrict__ vals,
                                        int32_t* __restrict__ offs, int64_t nblk,
                                        int block, int lg_chunk) {
  const uint32_t b = blockIdx.x;
  const uint32_t mask = (uint32_t)(block - 1);
  const uint32_t a = (murmur_bits(seed, 2u * b) | 1u) & mask;
  const uint32_t c = murmur_bits(seed, 2u * b + 1u) & mask;
  const uint32_t chunk_mask = (1u << lg_chunk) - 1u;
  for (uint32_t t0 = 0; t0 < (uint32_t)block; t0 += U * blockDim.x) {
    float v[U];
    uint32_t off[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const uint32_t t = t0 + j * blockDim.x + threadIdx.x;
      if (t < (uint32_t)block) {
        off[j] = (a * t + c) & mask;
        v[j] = x[((int64_t)(t >> lg_chunk) * nblk + b) * block + off[j]];
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const uint32_t t = t0 + j * blockDim.x + threadIdx.x;
      if (t < (uint32_t)block) {
        const int64_t o = ((int64_t)(t >> lg_chunk) * nblk + b) * (chunk_mask + 1) +
                          (t & chunk_mask);
        vals[o] = v[j];
        offs[o] = (int32_t)off[j];
      }
    }
  }
}

extern "C" int yardstick_gather(const void* x, void* vals, void* offs, long long rows,
                                int block, int kb, unsigned int magic, int unroll,
                                int threads, void* stream) {
  const uint32_t total = (uint32_t)(rows * kb);
  const unsigned grid = (unsigned)(((long long)total + unroll * threads - 1) /
                                   (unroll * threads));
  cudaStream_t st = (cudaStream_t)stream;
#define GATHER_LAUNCH(U)                                                              \
  yardstick_gather_kernel<U><<<grid, threads, 0, st>>>(                               \
      (const float*)x, (float*)vals, (int32_t*)offs, total, block, kb, magic)
  switch (unroll) {
    case 1: GATHER_LAUNCH(1); break;
    case 4: GATHER_LAUNCH(4); break;
    case 8: GATHER_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef GATHER_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int yardstick_affine(const void* x, unsigned int seed, void* vals, void* offs,
                                int n, long long nblk, int block, int unroll,
                                int threads, void* stream) {
  const int lg_chunk = __builtin_ffs(block / n) - 1;
  cudaStream_t st = (cudaStream_t)stream;
#define AFFINE_LAUNCH(U)                                                              \
  yardstick_affine_kernel<U><<<(unsigned)nblk, threads, 0, st>>>(                     \
      (const float*)x, (uint32_t)seed, (float*)vals, (int32_t*)offs, nblk, block, lg_chunk)
  switch (unroll) {
    case 1: AFFINE_LAUNCH(1); break;
    case 4: AFFINE_LAUNCH(4); break;
    case 8: AFFINE_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef AFFINE_LAUNCH
  return (int)cudaGetLastError();
}
