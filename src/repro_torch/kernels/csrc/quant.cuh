// Blockwise-QSGD arithmetic shared by quantize.cu and epilogue.cu (each is
// compiled on its own). Every operation is rounded once, in the order the
// plain versions in ref.py use.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// sign(x)·floor((s·|x|) / safe + u) as int8, u = (bits >> 8)·2^-24 exactly
__device__ __forceinline__ signed char qsgd_level(float x, float s, float safe,
                                                  uint32_t bits) {
  const float u = __fmul_rn((float)(bits >> 8), 5.9604644775390625e-08f);
  const float level = floorf(__fadd_rn(__fdiv_rn(__fmul_rn(s, fabsf(x)), safe), u));
  const int l = (int)level;
  return (signed char)(x > 0.0f ? l : (x < 0.0f ? -l : 0));
}

// acc[k] = Σ_{w=0..n−1} level[w, i0 + k]·(norm[w, b] / s), k < 4, summed in
// order from 0. levels (n, size) int8 with size = nblk·B; i0 % 4 == 0 and the
// four coordinates lie in block b.
__device__ __forceinline__ void dequant_sum4(const int8_t* __restrict__ levels,
                                             const float* __restrict__ norms, int n,
                                             int64_t nblk, int64_t size, int64_t b,
                                             int64_t i0, float s, float acc[4]) {
  acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;
  for (int w = 0; w < n; ++w) {
    const float scale = __fdiv_rn(norms[(int64_t)w * nblk + b], s);
    const char4 l = *reinterpret_cast<const char4*>(levels + (int64_t)w * size + i0);
    acc[0] = __fadd_rn(acc[0], __fmul_rn((float)l.x, scale));
    acc[1] = __fadd_rn(acc[1], __fmul_rn((float)l.y, scale));
    acc[2] = __fadd_rn(acc[2], __fmul_rn((float)l.z, scale));
    acc[3] = __fadd_rn(acc[3], __fmul_rn((float)l.w, scale));
  }
}
