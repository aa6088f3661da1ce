// K1 conv3x3_fwd_stats: the forward 3x3 conv + bias of the slice's block,
// with the batch-norm statistics of its output.
//
// Replaces (JAX package) howtotrainyourmamlpytorch_tpu/ops/functional.py
// ::conv_bn_act :249 — its `_conv2d_raw` :199 (`_im2col` :85 + one GEMM per
// task under vmap) and the statistics pass of `batch_norm` :368.
//
// Bound on an H100 in f32 (FFMA, 67 TFLOP/s; 3.35 TB/s): at layer 1
// (cin = 3, K = 27) the bytes bind — the 48-channel output is 16x the input;
// at layers 2-4 (cin = 48, K = 432) the FLOPs bind, e.g. 1.83 GFLOP against
// 17 MB per tenant at layer 2 (5 shots). The design answers both: the patch
// matrix (9x the input) never touches memory, y is written once, and the
// statistics ride the epilogue on values still in registers, so the
// normalize pass (K2) is the only re-read of y.
//
// Statistics: each block writes (count, mean, M2) of its 256-row tile per
// channel; a second launch merges the partials of one (tenant, channel)
// with Chan's formula into the mean and the BIASED variance, plus
// rstd = 1 / sqrt(var + eps). No atomics, so results are deterministic.
// The variance is within tolerance of both of the JAX package's
// `bn_stats_impl` modes ('twopass' and 'fused').
//
// Stride 2 (the strided model, `max_pooling=False`: 28 -> 14 -> 7 -> 4 ->
// 2 at Omniglot's width) runs the same tile with the row origin at
// (2*oh - 1, 2*ow - 1) of an input of another size (conv3x3_tile.cuh);
// the statistics run over the N*Ho*Wo output pixels, unchanged. Its bound
// is that of the stride-1 conv on a quarter of the pixels: FLOPs at
// layers 2-4 of the strided Omniglot model (e.g. 578 MFLOP against 11 MB
// at layer 2, T = 8, N = 20), bytes at layer 1 (cin = 1). A template
// argument, so the stride-1 instantiation is the code it was, bit for bit.
//
// Pad 0 (the unpadded model, `conv_padding=False`: 84 -> 82 -> 41 -> 39
// ... at mini-ImageNet's width, or 84 -> 41 -> 20 -> 9 -> 4 strided) is a
// runtime argument: the taps' origin moves from -1 to 0 and the host sizes
// the output (H + 2*pad - 3) / stride + 1; the tile, its loads and its FMA
// order are unchanged, so pad 1 computes what it computed, bit for bit.
// The valid conv reads no halo, so at stage 0 (cin 3) the bytes still
// bind (the 48-channel output) and at stages 1-3 the FLOPs.
//
// Stats-free mode (`conv3x3_fwd`): y = conv3x3(x, w) (+ b when b is given),
// the same tile, no statistics and no merge launch. The second-order
// backward of the block needs this conv twice per block and inner step:
// the derivative of dgrad with respect to dy is conv3x3(ddx, w), and that
// of wgrad with respect to dy is conv3x3(x, ddw) + ddb. A dedicated mode
// was chosen over running the dgrad kernel on w.flip(1, 2).transpose(-1,
// -2): that would materialise a flipped copy of every tenant's weights and
// read them flipped twice over. Same bound as the forward: bytes at layer 1,
// FLOPs at layers 2-4.

#include <cuda_runtime.h>

#include "conv3x3_tile.cuh"

namespace maml {

// acc += bias (when given) and the tile's valid rows and columns -> yt.
__device__ __forceinline__ void add_bias_and_store(float acc[kTM][kTN],
                                                   const float* bias,
                                                   float* __restrict__ yt,
                                                   int M, int cout, int m0,
                                                   int n0) {
  const int cg = threadIdx.x % 4;
  const int rg = threadIdx.x / 4;
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int n = n0 + cg * 4 + j;
    const float b = (bias != nullptr && n < cout) ? bias[n] : 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      acc[i][j] += b;
      const int m = m0 + rg + 32 * i;
      if (m < M && n < cout) yt[(size_t)m * cout + n] = acc[i][j];
    }
  }
}

template <int kStride>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* bias, float* __restrict__ y, int N, int H,
                   int W, int Ho, int Wo, int cin, int cout, int pad) {
  __shared__ ConvTileSmem s;
  const int t = blockIdx.z;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int M = N * Ho * Wo;
  float acc[kTM][kTN];
  conv3x3_tile<kStride, false>(x + (size_t)t * N * H * W * cin,
                               w + (size_t)t * 9 * cin * cout, H, W, Ho, Wo,
                               M, cin, cout, pad, m0, n0, s, acc);
  add_bias_and_store(acc, bias == nullptr ? nullptr : bias + t * cout,
                     y + (size_t)t * M * cout, M, cout, m0, n0);
}

template <int kStride>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_stats_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ bias, float* __restrict__ y,
                         float* __restrict__ part, int N, int H, int W,
                         int Ho, int Wo, int cin, int cout, int pad,
                         int mtiles) {
  __shared__ ConvTileSmem s;
  __shared__ float red[32][kBN + 1];
  __shared__ float col_mean[kBN];
  const int tid = threadIdx.x;
  const int t = blockIdx.z;
  const int mt = blockIdx.x;
  const int n0 = blockIdx.y * kBN;
  const int m0 = mt * kBM;
  const int M = N * Ho * Wo;
  float acc[kTM][kTN];
  conv3x3_tile<kStride, false>(x + (size_t)t * N * H * W * cin,
                               w + (size_t)t * 9 * cin * cout, H, W, Ho, Wo,
                               M, cin, cout, pad, m0, n0, s, acc);

  const int cg = tid % 4;
  const int rg = tid / 4;
  add_bias_and_store(acc, bias + t * cout, y + (size_t)t * M * cout, M, cout,
                     m0, n0);

  // per-tile statistics: column sum -> tile mean -> sum of squared
  // deviations from the tile mean (M2), both over the valid rows only
  const int cnt = min(kBM, M - m0);
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i)
      if (m0 + rg + 32 * i < M) sum += acc[i][j];
    red[rg][cg * 4 + j] = sum;
  }
  __syncthreads();
  if (tid < kBN) {
    float sum = 0.f;
    for (int r = 0; r < 32; ++r) sum += red[r][tid];
    col_mean[tid] = sum / (float)cnt;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const float mu = col_mean[cg * 4 + j];
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      if (m0 + rg + 32 * i < M) {
        const float d = acc[i][j] - mu;
        q = fmaf(d, d, q);
      }
    }
    red[rg][cg * 4 + j] = q;
  }
  __syncthreads();
  if (tid < kBN && n0 + tid < cout) {
    float q = 0.f;
    for (int r = 0; r < 32; ++r) q += red[r][tid];
    float* p = part + ((size_t)t * mtiles + mt) * 3 * cout + n0 + tid;
    p[0] = (float)cnt;
    p[cout] = col_mean[tid];
    p[2 * cout] = q;
  }
}

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

constexpr int kMergeThreads = 256;

__global__ void __launch_bounds__(kMergeThreads)
bn_stats_merge_kernel(const float* __restrict__ part, float* __restrict__ mean,
                      float* __restrict__ var, float* __restrict__ rstd,
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
  if (tid == 0) {
    const float v = sq[0] / sn[0];
    mean[t * cout + c] = sm[0];
    var[t * cout + c] = v;
    rstd[t * cout + c] = 1.f / sqrtf(v + eps);
  }
}

}  // namespace maml

extern "C" {

// y = conv3x3(x, w) + b at `stride` (1 or 2) and `pad` (1 or 0) and y's
// per-(tenant, channel) mean / biased var / rstd. x (T, N, H, W, cin), w
// (T, 3, 3, cin, cout), b (T, cout), y (T, N, Ho, Wo, cout) with Ho =
// (H + 2*pad - 3) / stride + 1 (Wo likewise), part scratch (T, mtiles, 3,
// cout) with mtiles = ceil(N*Ho*Wo / 256); mean, var, rstd (T, cout). Two
// launches on `stream`; returns the first CUDA error, 0 on success.
int conv3x3_fwd_stats(const float* x, const float* w, const float* b,
                      float* y, float* part, float* mean, float* var,
                      float* rstd, int T, int N, int H, int W, int stride,
                      int pad, int cin, int cout, int mtiles, float eps,
                      void* stream) {
  if ((stride != 1 && stride != 2) || (pad != 0 && pad != 1) ||
      H + 2 * pad < 3 || W + 2 * pad < 3)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H + 2 * pad - 3) / stride + 1;
  const int Wo = (W + 2 * pad - 3) / stride + 1;
  const int M = N * Ho * Wo;
  if (T < 1 || H < 1 || W < 1 || M < 1 || cin < 1 || cout < 1 ||
      mtiles != maml::ceil_div(M, maml::kBM))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(mtiles, maml::ceil_div(cout, maml::kBN), T);
  if (stride == 1)
    maml::conv3x3_fwd_stats_kernel<1><<<grid, maml::kThreads, 0, st>>>(
        x, w, b, y, part, N, H, W, Ho, Wo, cin, cout, pad, mtiles);
  else
    maml::conv3x3_fwd_stats_kernel<2><<<grid, maml::kThreads, 0, st>>>(
        x, w, b, y, part, N, H, W, Ho, Wo, cin, cout, pad, mtiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  maml::bn_stats_merge_kernel<<<dim3(cout, T), maml::kMergeThreads, 0, st>>>(
      part, mean, var, rstd, mtiles, cout, eps);
  return (int)cudaGetLastError();
}

// y = conv3x3(x, w) (+ b) at `stride` and `pad`: the stats-free mode. x
// (T, N, H, W, cin), w (T, 3, 3, cin, cout), b (T, cout) or null, y (T, N,
// Ho, Wo, cout). One launch on `stream`; returns its CUDA error, 0 on
// success.
int conv3x3_fwd(const float* x, const float* w, const float* b, float* y,
                int T, int N, int H, int W, int stride, int pad, int cin,
                int cout, void* stream) {
  if ((stride != 1 && stride != 2) || (pad != 0 && pad != 1) ||
      H + 2 * pad < 3 || W + 2 * pad < 3)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H + 2 * pad - 3) / stride + 1;
  const int Wo = (W + 2 * pad - 3) / stride + 1;
  const int M = N * Ho * Wo;
  if (T < 1 || H < 1 || W < 1 || M < 1 || cin < 1 || cout < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid(maml::ceil_div(M, maml::kBM), maml::ceil_div(cout, maml::kBN), T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stride == 1)
    maml::conv3x3_fwd_kernel<1><<<grid, maml::kThreads, 0, st>>>(
        x, w, b, y, N, H, W, Ho, Wo, cin, cout, pad);
  else
    maml::conv3x3_fwd_kernel<2><<<grid, maml::kThreads, 0, st>>>(
        x, w, b, y, N, H, W, Ho, Wo, cin, cout, pad);
  return (int)cudaGetLastError();
}

const char* maml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
