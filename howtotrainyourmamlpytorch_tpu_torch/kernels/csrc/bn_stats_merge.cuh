// K1's second launch, shared by every K1 design (the band kernels of
// conv3x3_fwd_s1.cu and conv3x3_s2.cu, the tensor-core kernels of
// conv3x3_s1_bf16.cu and conv3x3_s2.cu): the per-block (count, mean,
// M2) partials of one (tenant, channel) merged with Chan's formula into
// the mean, the BIASED variance and rstd = 1 / sqrt(var + eps). The
// partials lie as (T, P, 3, cout); any P. No atomics: the merge order is
// fixed (each thread's strided run in order, then a pairwise tree), so
// the results are deterministic.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace maml {

// (n, mean, m2) <- the union of itself and (nb, meanb, m2b) (Chan et al.)
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2,
                                           float nb, float meanb, float m2b) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb;
    mean = meanb;
    m2 = m2b;
    return;
  }
  const float nn = n + nb;
  const float d = meanb - mean;
  mean += d * (nb / nn);
  m2 += m2b + d * d * (n * nb / nn);
  n = nn;
}

// The merged statistics stored: f32 as they are, with rstd = 1 / sqrt(var
// + eps); bf16 each rounded once, rstd the f32 rsqrt of the bf16 sum var +
// eps (eps bf16 already), rounded once.
__device__ __forceinline__ void store_stats(float* mean, float* var,
                                            float* rstd, float mu, float v,
                                            float eps) {
  *mean = mu;
  *var = v;
  *rstd = 1.f / sqrtf(v + eps);
}
__device__ __forceinline__ void store_stats(__nv_bfloat16* mean,
                                            __nv_bfloat16* var,
                                            __nv_bfloat16* rstd, float mu,
                                            float v, float eps) {
  const float vb = __bfloat162float(__float2bfloat16_rn(v));
  *mean = __float2bfloat16_rn(mu);
  *var = __float2bfloat16_rn(vb);
  *rstd = __float2bfloat16_rn(
      1.f / sqrtf(__bfloat162float(__float2bfloat16_rn(vb + eps))));
}

constexpr int kMergeThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
bn_stats_merge_kernel(const float* __restrict__ part, T* __restrict__ mean,
                      T* __restrict__ var, T* __restrict__ rstd,
                      int mtiles, int cout, float eps) {
  __shared__ float sn[kMergeThreads];
  __shared__ float sm[kMergeThreads];
  __shared__ float sq[kMergeThreads];
  const int c = blockIdx.x;
  const int t = blockIdx.y;
  const int tid = threadIdx.x;
  float n = 0.f, mu = 0.f, m2 = 0.f;
  for (int i = tid; i < mtiles; i += kMergeThreads) {
    const float* p = part + ((size_t)t * mtiles + i) * 3 * cout + c;
    chan_merge(n, mu, m2, p[0], p[cout], p[2 * cout]);
  }
  sn[tid] = n;
  sm[tid] = mu;
  sq[tid] = m2;
  __syncthreads();
  for (int stride = kMergeThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      float a = sn[tid], b = sm[tid], q = sq[tid];
      chan_merge(a, b, q, sn[tid + stride], sm[tid + stride],
                 sq[tid + stride]);
      sn[tid] = a;
      sm[tid] = b;
      sq[tid] = q;
    }
    __syncthreads();
  }
  if (tid == 0)
    store_stats(mean + t * cout + c, var + t * cout + c, rstd + t * cout + c,
                sm[0], sq[0] / sn[0], eps);
}

}  // namespace maml
