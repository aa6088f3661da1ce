// K4 conv3x3_bwd: the first backward of the slice's 3x3 conv, two entry
// points.
//
// Replaces (JAX package) the gradient XLA derives for
// howtotrainyourmamlpytorch_tpu/ops/functional.py::_conv2d_raw :199 in the
// inner-loop support gradient (core/maml.py::_task_learner :177-189): the
// transposed GEMMs of the `gemm`/`im2col` lowering.
//
// * conv3x3_dgrad: dx = the transposed 3x3 conv of dy with each tenant's
//   weights — K1's implicit-GEMM tile (conv3x3_tile.cuh) reading the weights
//   flipped in space and transposed in channels. FLOP-bound at the slice's
//   layers 2-4 (the only layers that need it: layer 1's input is the raw
//   image), exactly like the forward.
// * conv3x3_wgrad: dW[t] = patches(x[t])^T dy[t] and db[t] = sum dy[t]: a
//   GEMM whose reduction runs over the M = N*H*W pixels. FLOP-bound at
//   layers 2-4, byte-bound at layer 1. The pixel axis is split over S
//   blocks per tenant into partial buffers, reduced by a second launch in a
//   fixed order — deterministic, no atomics. Patches are again gathered from
//   x on the fly.

#include <cuda_runtime.h>

#include "conv3x3_tile.cuh"

namespace maml {

__global__ void __launch_bounds__(kThreads)
conv3x3_dgrad_kernel(const float* __restrict__ dy, const float* __restrict__ w,
                     float* __restrict__ dx, int N, int H, int W, int cin_fwd,
                     int cout_fwd) {
  __shared__ ConvTileSmem s;
  const int tid = threadIdx.x;
  const int t = blockIdx.z;
  const int n0 = blockIdx.y * kBN;
  const int m0 = blockIdx.x * kBM;
  const int M = N * H * W;
  float acc[kTM][kTN];
  // the transposed conv reads dy (cout_fwd channels) and writes dx
  // (cin_fwd channels)
  conv3x3_tile<true>(dy + (size_t)t * M * cout_fwd,
                     w + (size_t)t * 9 * cin_fwd * cout_fwd, H, W, M,
                     cout_fwd, cin_fwd, m0, n0, s, acc);
  const int cg = tid % 4;
  const int rg = tid / 4;
  float* dxt = dx + (size_t)t * M * cin_fwd;
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int n = n0 + cg * 4 + j;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int m = m0 + rg + 32 * i;
      if (m < M && n < cin_fwd) dxt[(size_t)m * cin_fwd + n] = acc[i][j];
    }
  }
}

constexpr int kWK = 64;  // rows of K (= 9*cin) per block
constexpr int kWN = 16;  // output channels per block
constexpr int kWM = 32;  // pixels per shared-memory stage

// Block (k tile, channel tile, tenant * S + split). Thread (kg = tid % 16,
// cp = tid / 16) owns dW rows k0 + kg*4 .. +3 and channels n0 + cp*2, +1.
__global__ void __launch_bounds__(kThreads)
conv3x3_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                     float* __restrict__ part_w, float* __restrict__ part_b,
                     int N, int H, int W, int cin, int cout, int S,
                     int chunk) {
  __shared__ __align__(16) float ps[kWM][kWK];
  __shared__ __align__(16) float ds[kWM][kWN];
  __shared__ int k_dh[kWK], k_dw[kWK], k_delta[kWK];
  __shared__ int row_h[kWM], row_w[kWM];
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kWK;
  const int n0 = blockIdx.y * kWN;
  const int t = blockIdx.z / S;
  const int split = blockIdx.z % S;
  const int M = N * H * W;
  const int HW = H * W;
  const int K = 9 * cin;
  const int mb = split * chunk;
  const int me = min(M, mb + chunk);
  const float* xt = x + (size_t)t * M * cin;
  const float* dyt = dy + (size_t)t * M * cout;

  if (tid < kWK) {
    const int k = k0 + tid;
    if (k < K) {
      const int kpos = k / cin;
      const int ci = k - kpos * cin;
      const int dh = kpos / 3 - 1;
      const int dw = kpos % 3 - 1;
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
        const int hw = m % HW;
        row_h[tid] = hw / W;
        row_w[tid] = hw % W;
      } else {
        row_h[tid] = kOutOfImage;
        row_w[tid] = 0;
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
          v = xt[(long long)(mc + mm) * cin + delta];
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
        ds[mm][nn] = (m < me && n < cout) ? dyt[(size_t)m * cout + n] : 0.f;
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

// dw[t][e] = sum_s part_w[t][s][e] and db[t][c] = sum_s part_b[t][s][c], in
// split order.
__global__ void conv3x3_wgrad_reduce_kernel(const float* __restrict__ part_w,
                                            const float* __restrict__ part_b,
                                            float* __restrict__ dw,
                                            float* __restrict__ db, int T,
                                            int S, int KC, int cout) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per = KC + cout;
  if (idx >= (long long)T * per) return;
  const int t = (int)(idx / per);
  const int e = (int)(idx % per);
  float sum = 0.f;
  if (e < KC) {
    for (int s = 0; s < S; ++s) sum += part_w[((size_t)t * S + s) * KC + e];
    dw[(size_t)t * KC + e] = sum;
  } else {
    const int c = e - KC;
    for (int s = 0; s < S; ++s) sum += part_b[((size_t)t * S + s) * cout + c];
    db[t * cout + c] = sum;
  }
}

}  // namespace maml

extern "C" {

// dx (T, N, H, W, cin_fwd) = dgrad of the forward conv with weights
// w (T, 3, 3, cin_fwd, cout_fwd), from dy (T, N, H, W, cout_fwd).
int conv3x3_dgrad(const float* dy, const float* w, float* dx, int T, int N,
                  int H, int W, int cin_fwd, int cout_fwd, void* stream) {
  const int M = N * H * W;
  if (T < 1 || M < 1 || cin_fwd < 1 || cout_fwd < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid(maml::ceil_div(M, maml::kBM), maml::ceil_div(cin_fwd, maml::kBN),
            T);
  maml::conv3x3_dgrad_kernel<<<grid, maml::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      dy, w, dx, N, H, W, cin_fwd, cout_fwd);
  return (int)cudaGetLastError();
}

// dw (T, 3, 3, cin, cout) and db (T, cout) from x (T, N, H, W, cin) and
// dy (T, N, H, W, cout); part_w (T, S, 9*cin*cout) and part_b (T, S, cout)
// are scratch. Two launches on `stream`.
int conv3x3_wgrad(const float* x, const float* dy, float* part_w,
                  float* part_b, float* dw, float* db, int T, int N, int H,
                  int W, int cin, int cout, int S, void* stream) {
  const int M = N * H * W;
  if (T < 1 || M < 1 || cin < 1 || cout < 1 || S < 1 || S > M ||
      T * S > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunk = maml::ceil_div(M, S);
  dim3 grid(maml::ceil_div(9 * cin, maml::kWK), maml::ceil_div(cout, maml::kWN),
            T * S);
  maml::conv3x3_wgrad_kernel<<<grid, maml::kThreads, 0, st>>>(
      x, dy, part_w, part_b, N, H, W, cin, cout, S, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int KC = 9 * cin * cout;
  const long long total = (long long)T * (KC + cout);
  const int threads = 256;
  maml::conv3x3_wgrad_reduce_kernel<<<(unsigned)((total + threads - 1) / threads),
                                      threads, 0, st>>>(part_w, part_b, dw, db,
                                                        T, S, KC, cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
