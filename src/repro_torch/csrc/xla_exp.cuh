// exp_xla: float32 exp bit-identical to repro_torch._xla_math.exp_xla_f32.
//
// XLA:CPU's float32 exp is a Cephes-style scheme (clamp, range reduction
// by n = floor(x*log2(e) + 0.5), a degree-6 Horner polynomial, 2**n from
// the exponent bits), and the JAX package's popularity scores are held
// bit for bit. The torch version evaluates each fused multiply-add as a
// float64 product plus a float64 add, rounded once to float32; the other
// steps are float32. Every step here is an intrinsic with that rounding
// (__dmul_rn, __dadd_rn, __double2float_rn, __fmul_rn, __fadd_rn), so
// nvcc's default contraction of a*b+c into an FMA cannot reach it.
#pragma once

#include <cuda_runtime.h>

namespace etica {

// The constants are the float32 roundings the torch version uses (f32()),
// written as exact hexadecimal literals.

// flush float32 subnormals to (signed) zero, as XLA:CPU does
__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < 0x1p-126f ? copysignf(0.0f, x) : x;
}

// a * b + c with the product and the sum in float64, then one rounding
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

__device__ __forceinline__ float exp_xla(float x) {
  x = fminf(fmaxf(x, -0x1.633334p+6f), 0x1.633334p+6f);
  float n = floorf(fma_f64(x, 0x1.715476p+0f, 0.5f));
  n = fminf(fmaxf(n, -127.0f), 127.0f);
  float a = fma_f64(n, -0x1.63p-1f, x);
  a = fma_f64(n, 0x1.bd0106p-13f, a);
  float z = fma_f64(a, 0x1.a0d2cep-13f, 0x1.6e879cp-10f);
  z = fma_f64(z, a, 0x1.111210p-7f);
  z = fma_f64(z, a, 0x1.555382p-5f);
  z = fma_f64(z, a, 0x1.555554p-3f);
  z = fma_f64(z, a, 0.5f);
  z = __fadd_rn(fma_f64(z, __fmul_rn(a, a), a), 1.0f);
  const float pow2 = __int_as_float(((int)n + 127) << 23);
  return ftz(__fmul_rn(z, pow2));
}

// Eq. 1 contribution of one access: exp(-d / max(cs, 1)) when the access
// is served with a finite distance, else 0 (popularity.contributions)
__device__ __forceinline__ float eq1_contribution(int d, bool served,
                                                  float cs) {
  if (!served || d < 0) return 0.0f;
  return exp_xla(ftz(__fdiv_rn(-(float)d, fmaxf(cs, 1.0f))));
}

}  // namespace etica
