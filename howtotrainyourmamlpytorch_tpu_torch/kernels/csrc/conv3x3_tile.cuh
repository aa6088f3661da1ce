// Shared main loop of the task-batched 3x3 implicit GEMM at stride 2 (pad 1
// or 0, NHWC activations, HWIO weights), used by K1's forward
// (conv3x3_fwd.cu) and by K4's dgrad (conv3x3_bwd.cu), in f32 and bf16. The
// convs at stride 1 run other kernels: f32 the band kernels of
// conv3x3_fwd_s1.cu and conv3x3_bwd_s1.cu, bf16 the tensor-core kernels of
// conv3x3_s1_bf16.cu and conv3x3_wgrad_s1_bf16.cu. The f32 dgrad band
// kernel, with one group over cout, sums over (tap, channel) in the order
// of this loop.
//
// Per tenant t the conv is the GEMM  out[M, cout] = patches[M, K] x W[K, cout]
// with M = N*Ho*Wo output pixels and K = 9*cin in the order (kh, kw, cin) —
// the order of the JAX package's `_im2col` concatenation and of the HWIO
// weight reshape (ops/functional.py in both packages). The patch matrix is
// never written to memory: each block loads its A tile straight from x,
// zero-padding the halo by a bounds check.
//
// Geometry: the GEMM's rows are the pixels of an Hr x Wr grid; A reads a
// source grid of Hs x Ws pixels. The forward (kFlipW = false) at pad p (org
// = p): row (oh, ow) is an output pixel, Hs x Ws the input, and tap (kh,
// kw) reads input (2*oh - p + kh, 2*ow - p + kw), an input of another size
// than the output (28 -> 14, 7 -> 4 at pad 1: the bottom pad row of an odd
// input is read, and the bounds check zeroes it; 84 -> 41 at pad 0: the
// last row is read by no output). The dgrad (kFlipW = true, org = 2 - p):
// row (ih, iw) is an input pixel, the source is dy, and the weights are
// read flipped in space and transposed in channels; tap (kh', kw') reads dy
// at ((ih - org + kh') / 2, (iw - org + kw') / 2) where both are even and
// inside dy, and nothing otherwise: all 9 taps are masked by parity (1, 2,
// 2 or 4 live, by the parity of (ih, iw)), the simple design, which spends
// about 4x the useful FMAs.
// The pad moves the taps' origin only: the loop, its loads and its FMA
// order are those of pad 1.
//
// Tile: 256 pixels x 16 channels per block of 128 threads; K in stages of 16
// through shared memory. Thread (rg = tid / 4, cg = tid % 4) owns rows
// rg + 32*i (i < 8) and the 4 contiguous columns cg*4 .. cg*4+3, so each
// shared-memory step feeds 32 FFMAs from 8 scalar A reads and one float4 B
// read. f32 FFMA only: the JAX package multiplies f32 in true f32.
//
// The element type T of x and w is a template argument: float, or
// __nv_bfloat16 for compute_dtype='bfloat16'. A bf16 element is widened to
// f32 as it is loaded into shared memory, so the tiles, the FMA loop and
// its order are the f32 ones: a bf16 x bf16 product is exact in f32 and the
// sum accumulates in f32, as XLA's bf16 conv does (one rounding, at the
// caller's store). (FFMA on bf16 loads; at stride 1 the bf16 convs run on
// the tensor cores, mma.sync with f32 sums.)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace maml {

// An element widened to f32, and an f32 value rounded to the element type
// (round to nearest even; the identity for float).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T and widened back: what a T store would hold
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

constexpr int kThreads = 128;
constexpr int kBM = 256;  // output pixels per block
constexpr int kBN = 16;   // output channels per block
constexpr int kBK = 16;   // reduction depth per shared-memory stage
constexpr int kTM = 8;    // rows per thread, strided by 32
constexpr int kTN = 4;    // contiguous columns per thread
constexpr int kPadM = 4;  // keeps the transposed A stores at 2-way conflicts
constexpr int kOutOfImage = -1000000;  // a row or tap that never lands in bounds

struct __align__(16) ConvTileSmem {
  float a[kBK][kBM + kPadM];  // A tile, transposed: a[k][pixel]
  float b[kBK][kBN];          // B tile: b[k][channel]
  int row_h[kBM];             // the source coordinates of tap (1, 1)
  int row_w[kBM];             // of each tile row
  int row_base[kBM];          // element offset of that pixel (dgrad: of
                              // its image) in the source
  int k_dh[kBK];              // tap offsets of each k in the stage
                              // (kh - org, kw - org)
  int k_dw[kBK];
  int k_delta[kBK];           // element offset of the tap from the pixel
                              // (dgrad: its channel)
};

// acc[i][j] accumulates out[m0 + rg + 32*i][n0 + cg*4 + j].
// x, w: this tenant's source (N*Hs*Ws*cin) and weights; the rows are the
// M = N*Hr*Wr pixels of the Hr x Wr grid. kFlipW selects the dgrad weight
// view: w then holds the FORWARD weights (3, 3, cout, cin) and the kernel
// reads w'[kh][kw][ci][co] = w[2-kh][2-kw][co][ci], the transposed conv
// that maps dy to dx. org is the taps' origin: the pad for the forward,
// 2 - pad for the dgrad.
template <typename T, bool kFlipW>
__device__ __forceinline__ void conv3x3_tile(
    const T* __restrict__ x, const T* __restrict__ w, int Hs, int Ws,
    int Hr, int Wr, int M, int cin, int cout, int org, int m0, int n0,
    ConvTileSmem& s, float acc[kTM][kTN]) {
  // the dgrad gathers dy by parity; the forward reads the source at a
  // fixed offset from the row's pixel
  constexpr bool kParity = kFlipW;
  const int tid = threadIdx.x;
  const int HWr = Hr * Wr;
  for (int r = tid; r < kBM; r += kThreads) {
    const int m = m0 + r;
    if (m < M) {
      const int img = m / HWr;
      const int hw = m - img * HWr;
      const int ph = hw / Wr;
      const int pw = hw - ph * Wr;
      if (kParity) {
        s.row_h[r] = ph;
        s.row_w[r] = pw;
        s.row_base[r] = img * Hs * Ws * cin;
      } else {
        const int h = 2 * ph;
        const int ww = 2 * pw;
        s.row_h[r] = h;
        s.row_w[r] = ww;
        s.row_base[r] = ((img * Hs + h) * Ws + ww) * cin;
      }
    } else {
      s.row_h[r] = kOutOfImage;
      s.row_w[r] = 0;
      s.row_base[r] = 0;
    }
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int K = 9 * cin;
  const int kk_ld = tid % kBK;  // the k this thread loads into the A tile
  const int r_ld = tid / kBK;   // its first row; rows r_ld + 8*j
  const int cg = tid % 4;
  const int rg = tid / 4;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    if (tid < kBK) {
      const int k = k0 + tid;
      if (k < K) {
        const int kpos = k / cin;
        const int ci = k - kpos * cin;
        const int dh = kpos / 3 - org;
        const int dw = kpos % 3 - org;
        s.k_dh[tid] = dh;
        s.k_dw[tid] = dw;
        s.k_delta[tid] = kParity ? ci : (dh * Ws + dw) * cin + ci;
      } else {
        s.k_dh[tid] = kOutOfImage;
        s.k_dw[tid] = 0;
        s.k_delta[tid] = 0;
      }
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN;
      const int nn = e % kBN;
      const int k = k0 + kk;
      const int n = n0 + nn;
      float v = 0.f;
      if (k < K && n < cout) {
        if (!kFlipW) {
          v = to_f32(w[k * cout + n]);
        } else {
          const int kpos = k / cin;
          const int ci = k - kpos * cin;
          v = to_f32(w[((8 - kpos) * cout + n) * cin + ci]);
        }
      }
      s.b[kk][nn] = v;
    }
    __syncthreads();
    const int dh = s.k_dh[kk_ld];
    const int dw = s.k_dw[kk_ld];
    const int delta = s.k_delta[kk_ld];
#pragma unroll 4
    for (int j = 0; j < kBM / 8; ++j) {
      const int r = r_ld + 8 * j;
      const int h = s.row_h[r] + dh;
      const int ww = s.row_w[r] + dw;
      float v = 0.f;
      if (kParity) {
        // dy pixel (h / 2, ww / 2), where h and ww are even
        if (h >= 0 && ww >= 0 && ((h | ww) & 1) == 0 && (h >> 1) < Hs &&
            (ww >> 1) < Ws)
          v = to_f32(
              x[s.row_base[r] + ((h >> 1) * Ws + (ww >> 1)) * cin + delta]);
      } else if (h >= 0 && h < Hs && ww >= 0 && ww < Ws) {
        v = to_f32(x[s.row_base[r] + delta]);
      }
      s.a[kk_ld][r] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(&s.b[kk][cg * 4]);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float av = s.a[kk][rg + 32 * i];
        acc[i][0] = fmaf(av, bv.x, acc[i][0]);
        acc[i][1] = fmaf(av, bv.y, acc[i][1]);
        acc[i][2] = fmaf(av, bv.z, acc[i][2]);
        acc[i][3] = fmaf(av, bv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace maml
