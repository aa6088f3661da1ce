// K1 conv3x3_fwd_stats: the forward 3x3 conv + bias of the slice's block,
// with the batch-norm statistics of its output, on the implicit-GEMM tile
// (conv3x3_tile.cuh): at stride 2, in f32 and bf16. The convs at stride 1
// run the band kernels of conv3x3_fwd_s1.cu (f32, every shipped config)
// and the tensor-core kernel of conv3x3_s1_bf16.cu (bf16): the entries here
// refuse stride 1 in both dtypes, and no stride-1 instantiation of the tile
// is compiled.
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
// channel; a second launch (bn_stats_merge.cuh) merges the partials of one
// (tenant, channel) with Chan's formula into the mean and the BIASED
// variance, plus rstd = 1 / sqrt(var + eps). No atomics, so results are
// deterministic.
// The variance is within tolerance of both of the JAX package's
// `bn_stats_impl` modes ('twopass' and 'fused').
//
// Stride 2 (the strided model, `max_pooling=False`: 28 -> 14 -> 7 -> 4 ->
// 2 at Omniglot's width): the tile's row origin is (2*oh - 1, 2*ow - 1) of
// an input of another size (conv3x3_tile.cuh); the statistics run over the
// N*Ho*Wo output pixels. Its bound is that of the stride-1 conv on a
// quarter of the pixels: FLOPs at layers 2-4 of the strided Omniglot model
// (e.g. 578 MFLOP against 11 MB at layer 2, T = 8, N = 20), bytes at
// layer 1 (cin = 1).
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
//
// bf16 (compute_dtype='bfloat16', conv3x3_s2_fwd_stats_bf16 and its pad-0
// and stats-free kin; at stride 1 the tensor-core kernel of
// conv3x3_s1_bf16.cu, which rounds at the same points): the same tile on
// bf16 x, w and bias (conv3x3_tile.cuh widens them to f32 as they load), in
// the JAX package's cast points: the f32 sum of the bf16 products is
// rounded once to bf16 (XLA's bf16 conv), the bias add rounds again, and
// the statistics are those of the ROUNDED y — the epilogue rounds its
// accumulators before the tile's sums, so the statistics never see the f32
// values y was rounded from. mean and var come out of the f32 merge
// rounded once (jnp.mean / jnp.var on bf16: f32 sums), and rstd is the f32
// rsqrt of the bf16 sum var + eps (eps rounded to bf16 by the host),
// rounded once (lax.rsqrt). y, mean, var and rstd are stored in bf16.
// Bound as in f32 (FFMA, the same FLOPs) with half the bytes. The
// stats-free mode in bf16 (conv3x3_fwd_bf16, second-order training) is the
// same epilogue without the statistics: the f32 sum rounded once, and with
// a bias (Wgrad's backward: conv3x3(x, ddw) + ddb) the bias add rounded
// again, as the plain twin's conv then bias add round. Stride 2, pad 1 and
// 0, as in f32.

#include <cuda_runtime.h>

#include "bn_stats_merge.cuh"
#include "conv3x3_tile.cuh"

namespace maml {

// acc += bias (when given) and the tile's valid rows and columns -> yt.
// For a bf16 T the product is rounded to bf16 before the bias add and the
// sum again after it, and acc keeps the stored (rounded) values; for float
// both roundings are the identity.
template <typename T>
__device__ __forceinline__ void add_bias_and_store(float acc[kTM][kTN],
                                                   const T* bias,
                                                   T* __restrict__ yt,
                                                   int M, int cout, int m0,
                                                   int n0) {
  const int cg = threadIdx.x % 4;
  const int rg = threadIdx.x / 4;
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int n = n0 + cg * 4 + j;
    const float b = (bias != nullptr && n < cout) ? to_f32(bias[n]) : 0.f;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      acc[i][j] = round_to<T>(round_to<T>(acc[i][j]) + b);
      const int m = m0 + rg + 32 * i;
      if (m < M && n < cout)
        yt[(size_t)m * cout + n] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* bias, T* __restrict__ y, int N, int H,
                   int W, int Ho, int Wo, int cin, int cout, int pad) {
  __shared__ ConvTileSmem s;
  const int t = blockIdx.z;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int M = N * Ho * Wo;
  float acc[kTM][kTN];
  conv3x3_tile<T, false>(x + (size_t)t * N * H * W * cin,
                                  w + (size_t)t * 9 * cin * cout, H, W, Ho,
                                  Wo, M, cin, cout, pad, m0, n0, s, acc);
  add_bias_and_store<T>(acc, bias == nullptr ? nullptr : bias + t * cout,
                        y + (size_t)t * M * cout, M, cout, m0, n0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const T* __restrict__ bias, T* __restrict__ y,
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
  conv3x3_tile<T, false>(x + (size_t)t * N * H * W * cin,
                                  w + (size_t)t * 9 * cin * cout, H, W, Ho,
                                  Wo, M, cin, cout, pad, m0, n0, s, acc);

  const int cg = tid % 4;
  const int rg = tid / 4;
  add_bias_and_store<T>(acc, bias + t * cout, y + (size_t)t * M * cout, M,
                        cout, m0, n0);

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

template <typename T>
int fwd_stats(const T* x, const T* w, const T* b, T* y, float* part, T* mean,
              T* var, T* rstd, int T_, int N, int H, int W, int stride,
              int pad, int cin, int cout, int mtiles, float eps,
              void* stream) {
  if ((stride != 1 && stride != 2) || (pad != 0 && pad != 1) ||
      H + 2 * pad < 3 || W + 2 * pad < 3)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H + 2 * pad - 3) / stride + 1;
  const int Wo = (W + 2 * pad - 3) / stride + 1;
  const int M = N * Ho * Wo;
  if (T_ < 1 || H < 1 || W < 1 || M < 1 || cin < 1 || cout < 1 ||
      mtiles != ceil_div(M, kBM))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(mtiles, ceil_div(cout, kBN), T_);
  // stride 1: conv3x3_fwd_s1.cu (f32), conv3x3_s1_bf16.cu (bf16)
  if (stride == 1) return (int)cudaErrorInvalidValue;
  conv3x3_fwd_stats_kernel<T><<<grid, kThreads, 0, st>>>(
      x, w, b, y, part, N, H, W, Ho, Wo, cin, cout, pad, mtiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_stats_merge_kernel<T><<<dim3(cout, T_), kMergeThreads, 0, st>>>(
      part, mean, var, rstd, mtiles, cout, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int fwd(const T* x, const T* w, const T* b, T* y, int T_, int N, int H,
        int W, int stride, int pad, int cin, int cout, void* stream) {
  if ((stride != 1 && stride != 2) || (pad != 0 && pad != 1) ||
      H + 2 * pad < 3 || W + 2 * pad < 3)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H + 2 * pad - 3) / stride + 1;
  const int Wo = (W + 2 * pad - 3) / stride + 1;
  const int M = N * Ho * Wo;
  if (T_ < 1 || H < 1 || W < 1 || M < 1 || cin < 1 || cout < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid(ceil_div(M, kBM), ceil_div(cout, kBN), T_);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // stride 1: conv3x3_fwd_s1.cu (f32), conv3x3_s1_bf16.cu (bf16)
  if (stride == 1) return (int)cudaErrorInvalidValue;
  conv3x3_fwd_kernel<T><<<grid, kThreads, 0, st>>>(
      x, w, b, y, N, H, W, Ho, Wo, cin, cout, pad);
  return (int)cudaGetLastError();
}

}  // namespace maml

extern "C" {

// y = conv3x3(x, w) + b at `stride` (2: stride 1 returns an error) and
// `pad` (1 or 0) and y's per-(tenant, channel) mean / biased var / rstd.
// x (T, N, H, W, cin), w (T, 3, 3, cin, cout), b (T, cout), y (T, N, Ho,
// Wo, cout) with Ho = (H + 2*pad - 3) / stride + 1 (Wo likewise), part
// scratch (T, mtiles, 3, cout) with mtiles = ceil(N*Ho*Wo / 256); mean,
// var, rstd (T, cout). Two launches on `stream`; returns the first CUDA
// error, 0 on success.
int conv3x3_fwd_stats(const float* x, const float* w, const float* b,
                      float* y, float* part, float* mean, float* var,
                      float* rstd, int T, int N, int H, int W, int stride,
                      int pad, int cin, int cout, int mtiles, float eps,
                      void* stream) {
  return maml::fwd_stats<float>(x, w, b, y, part, mean, var, rstd, T, N, H,
                                W, stride, pad, cin, cout, mtiles, eps,
                                stream);
}

// The same in bf16: x, w, b, y, mean, var and rstd bf16 (part f32 scratch),
// eps the bf16 value of the batch norm's eps.
int conv3x3_fwd_stats_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                           const __nv_bfloat16* b, __nv_bfloat16* y,
                           float* part, __nv_bfloat16* mean,
                           __nv_bfloat16* var, __nv_bfloat16* rstd, int T,
                           int N, int H, int W, int stride, int pad, int cin,
                           int cout, int mtiles, float eps, void* stream) {
  return maml::fwd_stats<__nv_bfloat16>(x, w, b, y, part, mean, var, rstd, T,
                                        N, H, W, stride, pad, cin, cout,
                                        mtiles, eps, stream);
}

// y = conv3x3(x, w) (+ b) at `stride` (2: stride 1 returns an error) and
// `pad`: the stats-free mode. x (T, N, H, W, cin), w (T, 3, 3, cin, cout),
// b (T, cout) or null, y (T, N, Ho, Wo, cout). One launch on `stream`;
// returns its CUDA error, 0 on success.
int conv3x3_fwd(const float* x, const float* w, const float* b, float* y,
                int T, int N, int H, int W, int stride, int pad, int cin,
                int cout, void* stream) {
  return maml::fwd<float>(x, w, b, y, T, N, H, W, stride, pad, cin, cout,
                          stream);
}

// The same in bf16: x, w, b and y bf16; y the f32 sum rounded once, and
// with b the bias add rounded again.
int conv3x3_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                     const __nv_bfloat16* b, __nv_bfloat16* y, int T, int N,
                     int H, int W, int stride, int pad, int cin, int cout,
                     void* stream) {
  return maml::fwd<__nv_bfloat16>(x, w, b, y, T, N, H, W, stride, pad, cin,
                                  cout, stream);
}

const char* maml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
