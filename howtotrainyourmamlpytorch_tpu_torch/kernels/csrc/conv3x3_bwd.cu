// K4 conv3x3_wgrad at stride 2 (pad 1 or 0), f32 and bf16: the weight and
// bias gradients of the stride-2 conv on the tile kernel, and the last
// caller of the tile design (conv3x3_tile.cuh). At stride 1 wgrad runs the
// f32 band kernel of conv3x3_bwd_s1.cu and the bf16 tensor-core kernel of
// conv3x3_wgrad_s1_bf16.cu: the entries here refuse stride 1. The stride-2
// dgrad runs conv3x3_s2.cu's band kernels.
//
// Replaces (JAX package) the gradient XLA derives for
// howtotrainyourmamlpytorch_tpu/ops/functional.py::_conv2d_raw :199 with
// respect to w and b, in the inner-loop support gradient
// (core/maml.py::_task_learner :177-189): the transposed GEMM of the
// `gemm`/`im2col` lowering.
//
// dW[t] = patches(x[t])^T dy[t] and db[t] = sum dy[t]: a GEMM whose
// reduction runs over the M = N*Ho*Wo output pixels, x read at (2*oh - pad
// + kh, 2*ow - pad + kw). FLOP-bound at the strided Omniglot model's layers
// 2-4, byte-bound at layer 1. The pixel axis is split over S blocks per
// tenant into partial buffers, reduced by a second launch in a fixed order
// (wgrad_reduce.cuh) — deterministic, no atomics. Patches are gathered
// from x on the fly through a bounds check. At Omniglot's layer 4 (2x2
// outputs, 80 pixels a tenant) the split rule gives one split, 288 blocks
// at T = 8. (The redesign stride 1 had — x and dy staged once per band,
// the tensor cores in bf16 — is queued.)
//
// bf16 (conv3x3_s2_wgrad_bf16 and its pad-0 kin): bf16 x and dy, widened to
// f32 as they load; the pixel reduction and its split partials accumulate
// in f32 and are rounded once to bf16 at the store: dw and db come out bf16
// (the caller hands them to the f32 leaves as f32). Bound as in f32 (FFMA,
// the same FLOPs), with half the bytes.

#include <cuda_runtime.h>

#include "conv3x3_tile.cuh"
#include "wgrad_reduce.cuh"

namespace maml {

constexpr int kWK = 64;  // rows of K (= 9*cin) per block
constexpr int kWN = 16;  // output channels per block
constexpr int kWM = 32;  // pixels per shared-memory stage

// Block (k tile, channel tile, tenant * S + split). Thread (kg = tid % 16,
// cp = tid / 16) owns dW rows k0 + kg*4 .. +3 and channels n0 + cp*2, +1.
// The reduction runs over the M = N*Ho*Wo output pixels; x is H x W.
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     float* __restrict__ part_w, float* __restrict__ part_b,
                     int N, int H, int W, int Ho, int Wo, int cin, int cout,
                     int pad, int S, int chunk) {
  __shared__ __align__(16) float ps[kWM][kWK];
  __shared__ __align__(16) float ds[kWM][kWN];
  __shared__ int k_dh[kWK], k_dw[kWK], k_delta[kWK];
  __shared__ int row_h[kWM], row_w[kWM], row_base[kWM];
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kWK;
  const int n0 = blockIdx.y * kWN;
  const int t = blockIdx.z / S;
  const int split = blockIdx.z % S;
  const int M = N * Ho * Wo;
  const int HWo = Ho * Wo;
  const int K = 9 * cin;
  const int mb = split * chunk;
  const int me = min(M, mb + chunk);
  const T* xt = x + (size_t)t * N * H * W * cin;
  const T* dyt = dy + (size_t)t * M * cout;

  if (tid < kWK) {
    const int k = k0 + tid;
    if (k < K) {
      const int kpos = k / cin;
      const int ci = k - kpos * cin;
      const int dh = kpos / 3 - pad;
      const int dw = kpos % 3 - pad;
      k_dh[tid] = dh;
      k_dw[tid] = dw;
      k_delta[tid] = (dh * W + dw) * cin + ci;
    } else {
      k_dh[tid] = kOutOfImage;
      k_dw[tid] = 0;
      k_delta[tid] = 0;
    }
  }
  const int kg = tid % 16;
  const int cp = tid / 16;
  const bool bias_owner = blockIdx.x == 0 && kg == 0;
  float acc[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
  float dbias[2] = {0.f, 0.f};

  for (int mc = mb; mc < me; mc += kWM) {
    if (tid < kWM) {
      const int m = mc + tid;
      if (m < me) {
        const int img = m / HWo;
        const int hw = m - img * HWo;
        const int h = 2 * (hw / Wo);
        const int ww = 2 * (hw % Wo);
        row_h[tid] = h;
        row_w[tid] = ww;
        row_base[tid] = ((img * H + h) * W + ww) * cin;
      } else {
        row_h[tid] = kOutOfImage;
        row_w[tid] = 0;
        row_base[tid] = 0;
      }
    }
    __syncthreads();
    {
      const int kk = tid % kWK;
      const int dh = k_dh[kk], dw = k_dw[kk], delta = k_delta[kk];
#pragma unroll 4
      for (int j = 0; j < kWM / 2; ++j) {
        const int mm = tid / kWK + 2 * j;
        const int h = row_h[mm] + dh;
        const int ww = row_w[mm] + dw;
        float v = 0.f;
        if (h >= 0 && h < H && ww >= 0 && ww < W)
          v = to_f32(xt[row_base[mm] + delta]);
        ps[mm][kk] = v;
      }
    }
    {
      const int nn = tid % kWN;
      const int n = n0 + nn;
#pragma unroll
      for (int j = 0; j < kWM / 8; ++j) {
        const int mm = tid / kWN + 8 * j;
        const int m = mc + mm;
        ds[mm][nn] =
            (m < me && n < cout) ? to_f32(dyt[(size_t)m * cout + n]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int mm = 0; mm < kWM; ++mm) {
      const float4 p = *reinterpret_cast<const float4*>(&ps[mm][kg * 4]);
      const float2 d = *reinterpret_cast<const float2*>(&ds[mm][cp * 2]);
      acc[0][0] = fmaf(p.x, d.x, acc[0][0]);
      acc[0][1] = fmaf(p.x, d.y, acc[0][1]);
      acc[1][0] = fmaf(p.y, d.x, acc[1][0]);
      acc[1][1] = fmaf(p.y, d.y, acc[1][1]);
      acc[2][0] = fmaf(p.z, d.x, acc[2][0]);
      acc[2][1] = fmaf(p.z, d.y, acc[2][1]);
      acc[3][0] = fmaf(p.w, d.x, acc[3][0]);
      acc[3][1] = fmaf(p.w, d.y, acc[3][1]);
      if (bias_owner) {
        dbias[0] += d.x;
        dbias[1] += d.y;
      }
    }
    __syncthreads();
  }

  float* pw = part_w + ((size_t)t * S + split) * K * cout;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int k = k0 + kg * 4 + a;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int n = n0 + cp * 2 + b;
      if (k < K && n < cout) pw[(size_t)k * cout + n] = acc[a][b];
    }
  }
  if (bias_owner) {
    float* pb = part_b + ((size_t)t * S + split) * cout;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int n = n0 + cp * 2 + b;
      if (n < cout) pb[n] = dbias[b];
    }
  }
}

template <typename T>
int wgrad(const T* x, const T* dy, float* part_w, float* part_b, T* dw,
          T* db, int T_, int N, int H, int W, int stride, int pad, int cin,
          int cout, int S, void* stream) {
  if ((stride != 1 && stride != 2) || (pad != 0 && pad != 1) ||
      H + 2 * pad < 3 || W + 2 * pad < 3)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H + 2 * pad - 3) / stride + 1;
  const int Wo = (W + 2 * pad - 3) / stride + 1;
  const int M = N * Ho * Wo;
  if (T_ < 1 || H < 1 || W < 1 || M < 1 || cin < 1 || cout < 1 || S < 1 ||
      S > M || T_ * S > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunk = ceil_div(M, S);
  dim3 grid(ceil_div(9 * cin, kWK), ceil_div(cout, kWN), T_ * S);
  // stride 1: conv3x3_bwd_s1.cu (f32), conv3x3_wgrad_s1_bf16.cu (bf16)
  if (stride == 1) return (int)cudaErrorInvalidValue;
  conv3x3_wgrad_kernel<T><<<grid, kThreads, 0, st>>>(
      x, dy, part_w, part_b, N, H, W, Ho, Wo, cin, cout, pad, S, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wgrad_reduce<T>(part_w, part_b, dw, db, T_, S,
                                     9 * cin * cout, cout, st);
}

}  // namespace maml

extern "C" {

// dw (T, 3, 3, cin, cout) and db (T, cout) of the conv at `stride` (2:
// stride 1 returns an error) and `pad` from x (T, N, H, W, cin) and dy (T,
// N, Ho, Wo, cout); part_w (T, S, 9*cin*cout) and part_b (T, S, cout) are
// scratch. Two launches on `stream`.
int conv3x3_wgrad(const float* x, const float* dy, float* part_w,
                  float* part_b, float* dw, float* db, int T, int N, int H,
                  int W, int stride, int pad, int cin, int cout, int S,
                  void* stream) {
  return maml::wgrad<float>(x, dy, part_w, part_b, dw, db, T, N, H, W,
                            stride, pad, cin, cout, S, stream);
}

// The same in bf16: x, dy, dw and db bf16 (part_w and part_b f32 scratch).
int conv3x3_wgrad_bf16(const __nv_bfloat16* x, const __nv_bfloat16* dy,
                       float* part_w, float* part_b, __nv_bfloat16* dw,
                       __nv_bfloat16* db, int T, int N, int H, int W,
                       int stride, int pad, int cin, int cout, int S,
                       void* stream) {
  return maml::wgrad<__nv_bfloat16>(x, dy, part_w, part_b, dw, db, T, N, H,
                                    W, stride, pad, cin, cout, S, stream);
}

}  // extern "C"
