// The second launch of K4 wgrad in all three designs (the f32 band kernel
// of conv3x3_bwd_s1.cu, the bf16 tensor-core kernel of
// conv3x3_wgrad_s1_bf16.cu, the stride-2 tile of conv3x3_bwd.cu): dw[t][e]
// = sum_s part_w[t][s][e] and db[t][c] = sum_s part_b[t][s][c] over each
// tenant's S split partials in split order (no atomics: a second launch
// gives the first one's bits), rounded once to the element type at the
// store (f32: stored as summed).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace maml {

__device__ __forceinline__ void store_sum(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_sum(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename E>
__global__ void conv3x3_wgrad_reduce_kernel(const float* __restrict__ part_w,
                                            const float* __restrict__ part_b,
                                            E* __restrict__ dw,
                                            E* __restrict__ db, int T,
                                            int S, int KC, int cout) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per = KC + cout;
  if (idx >= (long long)T * per) return;
  const int t = (int)(idx / per);
  const int e = (int)(idx % per);
  float sum = 0.f;
  if (e < KC) {
    for (int s = 0; s < S; ++s) sum += part_w[((size_t)t * S + s) * KC + e];
    store_sum(dw + (size_t)t * KC + e, sum);
  } else {
    const int c = e - KC;
    for (int s = 0; s < S; ++s) sum += part_b[((size_t)t * S + s) * cout + c];
    store_sum(db + t * cout + c, sum);
  }
}

// The reduce of T tenants' partials (KC = 9 cin cout weights and cout
// biases each) on `st`; returns its launch's CUDA error.
template <typename E>
cudaError_t launch_wgrad_reduce(const float* part_w, const float* part_b,
                                E* dw, E* db, int T, int S, int KC, int cout,
                                cudaStream_t st) {
  const long long total = (long long)T * (KC + cout);
  conv3x3_wgrad_reduce_kernel<E>
      <<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part_w, part_b, dw,
                                                        db, T, S, KC, cout);
  return cudaGetLastError();
}

}  // namespace maml
