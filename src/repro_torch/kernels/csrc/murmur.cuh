// murmur3 finalizer over (seed, counter): the counter-based RNG shared with
// repro.kernels.ref.murmur_bits_ref. uint32 arithmetic wraps as in the oracle.
// Included by randk.cu, permk.cu and quantize.cu; each is compiled on its own.
#pragma once
#include <stdint.h>

__device__ __forceinline__ uint32_t murmur_bits(uint32_t seed, uint32_t ctr) {
  uint32_t x = ctr * 0x9E3779B9u + seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}
