// The batch-norm affine that decides the leaky-ReLU's side, as K2
// (bn_act_fwd.cu) rounds it, shared with the pool-free K3 (bn_act_bwd.cu)
// so that K3's masks are K2's decisions:
// * f32: xhat = (y - mean) * rstd, z = fma(xhat, gamma, beta) (one FMA);
//   spelled with __fsub_rn / __fmul_rn / __fmaf_rn so that no contraction
//   moves it;
// * bf16: every op of the JAX package's bf16 chain rounded to bf16 (y -
//   mean, * rstd, * gamma, + beta), each computed in f32 from bf16
//   values, as the twin (ops/functional.py::_affine_act) computes it; a
//   pair of elements shares each conversion (the conversions, not the
//   bytes, bound a bf16 chain).
#pragma once

#include <cuda_bf16.h>

namespace maml {

// an f32 value rounded to the nearest bf16 (ties to even), kept in f32
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a pair rounded to bf16 (ties to even) in one conversion
__device__ __forceinline__ void rbf2(float& a, float& b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  a = __low2float(h);
  b = __high2float(h);
}

// f32: xhat, and z from it
__device__ __forceinline__ float bn_xhat(float v, float m, float r) {
  return __fmul_rn(__fsub_rn(v, m), r);
}
__device__ __forceinline__ float bn_z(float xhat, float g, float b) {
  return __fmaf_rn(xhat, g, b);
}

// bf16: z of one element by the chain
__device__ __forceinline__ float bn_z_bf16(float v, float m, float r,
                                           float g, float b) {
  float z = rbf(__fsub_rn(v, m));
  z = rbf(__fmul_rn(z, r));
  z = rbf(__fmul_rn(z, g));
  return rbf(__fadd_rn(z, b));
}

// bf16: z of two elements by the chain, a conversion a pair
__device__ __forceinline__ void bn_z_bf16_2(float& z0, float& z1, float m0,
                                            float m1, float r0, float r1,
                                            float g0, float g1, float b0,
                                            float b1) {
  z0 = __fsub_rn(z0, m0), z1 = __fsub_rn(z1, m1);
  rbf2(z0, z1);
  z0 = __fmul_rn(z0, r0), z1 = __fmul_rn(z1, r1);
  rbf2(z0, z1);
  z0 = __fmul_rn(z0, g0), z1 = __fmul_rn(z1, g1);
  rbf2(z0, z1);
  z0 = __fadd_rn(z0, b0), z1 = __fadd_rn(z1, b1);
  rbf2(z0, z1);
}

}  // namespace maml
