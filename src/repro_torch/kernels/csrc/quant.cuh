// Blockwise-QSGD arithmetic shared by quantize.cu and epilogue.cu (each is
// compiled on its own). Every operation is rounded once, in the order the
// plain versions in ref.py use.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// sign(x)·floor((s·|x|) / safe + u) as int8
__device__ __forceinline__ signed char qsgd_level_u(float x, float s, float safe,
                                                    float u) {
  const float level = floorf(__fadd_rn(__fdiv_rn(__fmul_rn(s, fabsf(x)), safe), u));
  const int l = (int)level;
  return (signed char)(x > 0.0f ? l : (x < 0.0f ? -l : 0));
}

// the same with the dither u = (bits >> 8)·2^-24 exactly
__device__ __forceinline__ signed char qsgd_level(float x, float s, float safe,
                                                  uint32_t bits) {
  return qsgd_level_u(x, s, safe, __fmul_rn((float)(bits >> 8), 5.9604644775390625e-08f));
}

// ---------------------------------------------------------------------------
// Natural compression: every power of two is built from exponent bits and
// every exponent read from them (never log2f / exp2f, which approximate);
// magnitudes below 2^-126 count as zero on input and after decoding, as the
// TPU's flush of subnormals makes them. nvcc runs without -ftz, so that flush
// is done here, in code.
// ---------------------------------------------------------------------------

#define NATURAL_TINY 1.1754943508222875e-38f  // 2^-126, the smallest normal

// 2^k for integer k in [-126, 128] (k = 128: inf)
__device__ __forceinline__ float pow2_exact(int k) {
  return __uint_as_float((uint32_t)(k + 127) << 23);
}

// |x| with subnormals (and NaN) flushed to 0
__device__ __forceinline__ float natural_abs(float x) {
  const float ax = fabsf(x);
  return ax >= NATURAL_TINY ? ax : 0.0f;
}

// floor(log2(ax)) for a normal positive ax: its unbiased exponent
__device__ __forceinline__ int float_exponent(float ax) {
  return (int)(__float_as_uint(ax) >> 23) - 127;
}

// the row's reference exponent from its flushed max |x|: floor(log2 mx) + 1,
// or 1 for a row of zeros
__device__ __forceinline__ int natural_e_ref(float mx) {
  return (mx > 0.0f ? float_exponent(mx) : 0) + 1;
}

// code of one coordinate: sign(x)·(delta + 1), delta = e_ref − e_q, with
// e_q = e + [u < (|x| − 2^e) / 2^e] (the subtraction and the division exact,
// each rounded once), u = (bits >> 8)·2^-24; 0 for |x| < 2^-126 or delta > 126
__device__ __forceinline__ signed char natural_code(float x, int e_ref, uint32_t bits) {
  const float ax = natural_abs(x);
  if (ax == 0.0f) return 0;
  const int e = float_exponent(ax);
  const float lo = pow2_exact(e);
  const float p_up = __fdiv_rn(__fsub_rn(ax, lo), lo);
  const float u = __fmul_rn((float)(bits >> 8), 5.9604644775390625e-08f);
  const int delta = e_ref - (e + (u < p_up ? 1 : 0));
  if (delta > 126) return 0;
  return (signed char)(x < 0.0f ? -(delta + 1) : delta + 1);
}

// decoded value of one code: sign(c)·scale·2^-(|c|−1), the product rounded
// once and flushed to 0 below 2^-126 (a NaN product too), the sign applied
// after the flush (c < 0 may give −0); +0 for c = 0. Selects, no branch.
__device__ __forceinline__ float natural_value(int c, float scale) {
  const int a = c < 0 ? -c : c;
  const float mag = __fmul_rn(scale, pow2_exact(max(1 - a, -126)));
  const float kept = (c != 0) & (mag >= NATURAL_TINY) ? mag : 0.0f;
  return c < 0 ? -kept : kept;
}

// acc[k] = Σ_{w=0..n−1} decoded code[w, i0 + k] under scale[w, b], k < 4,
// summed in order from 0. codes (n, size) int8 with size = nblk·B; i0 % 4 == 0
// and the four coordinates lie in block b.
__device__ __forceinline__ void natural_sum4(const int8_t* __restrict__ codes,
                                             const float* __restrict__ scales, int n,
                                             int64_t nblk, int64_t size, int64_t b,
                                             int64_t i0, float acc[4]) {
  acc[0] = acc[1] = acc[2] = acc[3] = 0.0f;
  for (int w = 0; w < n; ++w) {
    const float scale = scales[(int64_t)w * nblk + b];
    const char4 c = *reinterpret_cast<const char4*>(codes + (int64_t)w * size + i0);
    acc[0] = __fadd_rn(acc[0], natural_value(c.x, scale));
    acc[1] = __fadd_rn(acc[1], natural_value(c.y, scale));
    acc[2] = __fadd_rn(acc[2], natural_value(c.z, scale));
    acc[3] = __fadd_rn(acc[3], natural_value(c.w, scale));
  }
}
