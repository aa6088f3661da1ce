// K1 (with statistics and stats-free) and K4 dgrad at stride 2, pad 1 or 0,
// in f32 and bf16, on bands staged once in shared memory: the f32 kernels
// multiply on FFMA in the order of the tile they replaced, the bf16 kernel
// on the tensor cores (mma.sync m16n8k16, f32 sums).
//
// Replaces (JAX package) howtotrainyourmamlpytorch_tpu/ops/functional.py
// ::conv_bn_act :249 at stride 2 — its `_conv2d_raw` :199 (`_im2col` :85 +
// one GEMM over the (kh, kw, cin) patch rows) and the statistics pass of
// `batch_norm` :368 — in conv3x3_s2_fwd_stats (and its _p0 and _bf16 kin);
// `_conv2d_raw` at stride 2 in XLA's second derivative (conv3x3(ddx, w),
// and conv3x3(x, ddw) + ddb) in conv3x3_s2_fwd; and the gradient XLA
// derives for `_conv2d_raw` at stride 2 with respect to x in
// conv3x3_s2_dgrad. The stride-2 wgrad runs conv3x3_wgrad_s2.cu (the
// stride-1 band and tensor-core wgrad designs, with these planes in bf16).
//
// Bound on an H100 (67 TFLOP/s FFMA, 989 dense bf16; 3.35 TB/s): the useful
// FLOPs in f32 at 48 and 64 channels, the bytes at cin 1 and 3 and in bf16
// (a stride-2 conv does 2 * 9 * cin * cout FLOPs an output pixel against
// about 4 input pixels and one output pixel moved). So: the source is
// staged from memory once a band, the dgrad takes only the live taps, and
// every output is written once.
//
// The dgrad's parity classes (kernels/conv_block.py::s2_dgrad_taps states
// them): dx row ih reads dy row (ih + pad - kh) / 2 where that is an
// integer inside dy. With a = ih + pad and A = a / 2: a even reads dy rows
// A - 1 (kh 2) and A (kh 0), a odd dy row A (kh 1); the columns alike with
// b = iw + pad, B = b / 2. So the quad a = 2A, 2A + 1 x b = 2B, 2B + 1
// reads the dy window (A - 1 .. A, B - 1 .. B), and its four pixels take
// the 9 taps once between them: class (a & 1, b & 1) = (0, 0) the taps
// (2, 2), (2, 0), (0, 2), (0, 0); (0, 1) (2, 1), (0, 1); (1, 0) (1, 2),
// (1, 0); (1, 1) (1, 1) — each class a GEMM of M = its pixels, N = cin, K =
// its taps x cout, the four in that order (kS2Taps). dx rows and columns
// that no output reads (ih = 83 of 84 -> 41 at pad 0) read dy rows or
// columns outside dy, staged as zeros: an exact zero.
//
// * f32 (conv3x3_s2_fwd_kernel, conv3x3_s2_dgrad_kernel): FFMA only, no
//   TF32. Each output's sum runs in one thread in the tile's order: the
//   forward over (kh, kw, ci), the dgrad over its class's taps in the order
//   (kh, kw) descending — the tile's K = (2 - kh, 2 - kw, co) — and co
//   within a tap. A tap the tile masked added fmaf(0, w, acc) = acc (acc is
//   never -0: it starts at +0 and an exact zero sum rounds to +0), so
//   skipping it, or reading a staged zero, keeps the tile's bits. y and dx
//   are the tile's bit for bit; the statistics are summed in another order
//   than the tile's (per band, as the stride-1 kernels), within the gate.
//   - The forward block owns a band of CR output rows of one image and all
//     cout channels. Its 2 CR + 1 input rows (with the halo at pad 1) are
//     staged once by cp.async, each row split into an even and an odd
//     column plane of Wo + 1 pixels: band column c (input column c - pad)
//     goes to plane c & 1, index c / 2, so tap (kh, kw) of output pixel
//     (r, ow) reads plane row 2 (2 r + kh) + (kw & 1), index ow + kw / 2:
//     a unit-stride run in one plane. A thread holds a run of 8 output
//     pixels x 4 channels (8 at cin <= 4, where the bytes bind, where that
//     fills the card) and streams the weights one tap at a time (all nine
//     at cin <= 4) through a two-slot ring, as the stride-1 band kernel
//     (conv3x3_fwd_s1.cu) does; the statistics ride the epilogue on values
//     still in registers.
//   - The dgrad block owns a band of CR quad rows of one image and all cin
//     channels: dy rows A0 - 1 .. A0 + CR - 1, columns -1 .. NB - 1 (NB
//     quad columns), staged once, a pixel's cout floats on a stride that
//     keeps the float4 reads free of bank conflicts. A thread holds 8 quads
//     x 4 channels (1 at cin 1) and takes the classes one after the other,
//     each on its 8 x 4 accumulators: the weights stream one tap at a time
//     in kS2Taps' order through a two-slot ring, and a class's dx pixels
//     are stored when its last tap is done. The sum over cout runs in
//     float4 steps along both operands' contiguous axis. (8 x 8
//     accumulators spilled within 128 registers, and ran slower in float2
//     steps than 8 x 4 in float4.)
// * bf16 (conv3x3_s2_mma_kernel): bf16 inputs, every product and sum in
//   f32 on the tensor cores, the f32 sum rounded once to bf16 at the store
//   and the bias add rounded again; the statistics are those of the rounded
//   y (the tile's cast points). Within one bf16 ulp of the twins (the sums
//   run in another order than the tile's). A block owns up to 64 output
//   channels of one tenant (32 where its weights would take more than 64
//   KB: Omniglot's 64 x 64 layers) and walks `per` consecutive bands; the
//   tenant's
//   weights load once into shared memory, each band's source once by
//   cp.async, and A fragments come by ldmatrix from per-lane row addresses
//   (a lane's pixel and the tap's shift), so neither the planes nor the
//   quads need a patch matrix:
//   - forward: the planes above, a warp 32 output pixels x the block's
//     channels, K = 9 taps x round16(cin); at cin <= 3 (Omniglot layer 1,
//     the unpadded stage 0) the 9 cin patch values of each pixel packed
//     into K = 16 or 32 in shared memory (a thread a pixel) from the band's
//     input rows as they lie in memory;
//   - dgrad: the dy band above, a warp 32 quads of one class at a time x
//     the block's channels, K = the class's taps x round16(cout); the
//     weights w[kh][kw] read in place (cout is K and contiguous).
//   Epilogues as conv3x3_s1_bf16.cu's: the statistics per band and channel
//   (count, mean, M2) from the warps in order; y staged through shared
//   memory for 16-byte stores; dx stored from the fragments (a class's
//   pixels are every other one of a row).
// No atomics anywhere: a second launch gives the first's bits. The launch
// plans are pure functions of the shape (kernels/conv_block.py::fwd_plan,
// dgrad_plan, kernels "s2" and "s2_mma"); the entry points check the plan's
// threads, shared memory and grid against the geometry here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bn_stats_merge.cuh"
#include "mma_common.cuh"

namespace maml {

constexpr int kRun = 8;  // f32: output pixels (forward) or quads a thread

// The dgrad's taps (3 kh + kw) in the kernels' order: class (0, 0) 8, 6, 2,
// 0; (0, 1) 7, 1; (1, 0) 5, 3; (1, 1) 4 (kernels/conv_block.py
// ::s2_dgrad_taps). Stage i belongs to class kS2Class(i); a class's last
// stage stores it.
__host__ __device__ __forceinline__ int kS2Taps(int i) {
  return (int)((0x435170268ull >> (4 * i)) & 15ull);
}
__host__ __device__ __forceinline__ int kS2Class(int i) {
  return i < 4 ? 0 : i < 6 ? 1 : i < 8 ? 2 : 3;
}
__host__ __device__ __forceinline__ bool kS2ClassEnds(int i) {
  return i == 3 || i == 5 || i == 7 || i == 8;
}
// the staged row and column of a tap relative to the quad's first: kh 2
// reads dy row A - 1 (staged row 0 of the quad), kh 0 and 1 row A
__host__ __device__ __forceinline__ int s2_tap_shift(int tap, int Wb) {
  const int kh = tap / 3;
  const int kw = tap - 3 * kh;
  return (kh == 2 ? 0 : Wb) + (kw == 2 ? 0 : 1);
}

// Where staged pixel p starts (f32): CS floats a pixel, and 4 more after
// every 8 pixels, so that runs of a warp 8 pixels apart fall in distinct
// banks.
__host__ __device__ __forceinline__ int band_off(int p, int CS) {
  return p * CS + ((p >> 3) << 2);
}

// --- f32 forward -----------------------------------------------------------

struct S2FwdGeom {
  int N, H, W, Ho, Wo, cin, cout, pad;
  int Wq;    // Wo + 1: a plane row's pixels
  int CR;    // output rows a band
  int nb;    // bands an image
  int CS;    // floats a staged pixel (cin rounded up to 4)
  int G;     // channel groups of kCh; cout is padded to kCh G
  int runs;  // runs of 8 output pixels a band
  int TPS;   // taps a weight stage (9 at cin <= 4, else 1)
  int band_floats, slot_floats;
  int vec_x, vec_w, vec_y;
};

// Block (image * nb + band, 1, tenant). Thread (run, channel group grp):
// the band's output pixels q = 8 run .. 8 run + 7 (q = r Wo + ow), output
// channels 4 grp .. 4 grp + 3 and, with kCh = 8, 4 (G + grp) .. + 3.
template <bool kStats, int kCh>
__global__ void __launch_bounds__(kMaxThreads, 2)
conv3x3_s2_fwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ y,
                      float* __restrict__ part, S2FwdGeom g) {
  extern __shared__ __align__(16) float smem[];
  float* band = smem;
  float* ring = smem + g.band_floats;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int t = blockIdx.z;
  const int img = blockIdx.x / g.nb;
  const int oh0 = (blockIdx.x - img * g.nb) * g.CR;
  const int rows = min(g.CR, g.Ho - oh0);
  const int npx = rows * g.Wo;
  const float* xi = x + ((size_t)t * g.N + img) * g.H * g.W * g.cin;
  const float* wt = w + (size_t)t * 9 * g.cin * g.cout;
  const int coutp = kCh * g.G;
  const int half = 4 * g.G;  // a thread's second 4 channels: 4 G on
  const int wrows = g.TPS * g.cin;

  // the columns cout .. coutp - 1 of every weight row are zero in both
  // slots
  if (coutp != g.cout) {
    const int padc = coutp - g.cout;
    for (int e = tid; e < 2 * wrows * padc; e += nthreads) {
      const int row = e / padc;
      const int s = row / wrows;
      ring[s * g.slot_floats + (row - s * wrows) * coutp + g.cout +
           (e - row * padc)] = 0.f;
    }
  }
  // the band: input rows 2 oh0 - pad + rr (rr < 2 CR + 1), band columns c
  // < 2 Wq (input column c - pad), zero outside the image and past the
  // band's rows; column c to plane row 2 rr + (c & 1), index c / 2
  {
    const int width = g.vec_x ? 4 : 1;
    const int per = g.cin / width;  // copies a pixel
    const int cols = 2 * g.Wq;
    const int total = (2 * g.CR + 1) * cols * per;
    for (int e = tid; e < total; e += nthreads) {
      const int pc = e / per;
      const int cu = e - pc * per;
      const int rr = pc / cols;
      const int c = pc - rr * cols;
      const int ih = 2 * oh0 - g.pad + rr;
      const int iw = c - g.pad;
      float* dst =
          band + band_off((2 * rr + (c & 1)) * g.Wq + (c >> 1), g.CS) +
          cu * width;
      if (rr < 2 * rows + 1 && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W) {
        const float* src = xi + ((size_t)ih * g.W + iw) * g.cin + cu * width;
        if (g.vec_x)
          cp_async16(dst, src);
        else
          cp_async4(dst, src);
      } else if (g.vec_x) {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        *dst = 0.f;
      }
    }
  }
  // stage s: taps s * TPS .. s * TPS + TPS - 1, (kh, kw) in order, rows of
  // cout floats as they lie in HWIO
  const int nstages = 9 / g.TPS;
  auto load_stage = [&](int s, int slot) {
    float* dst = ring + slot * g.slot_floats;
    const float* src = wt + (size_t)s * wrows * g.cout;
    if (g.vec_w) {
      const int c4n = g.cout >> 2;
      for (int e = tid; e < wrows * c4n; e += nthreads) {
        const int row = e / c4n;
        const int c4 = e - row * c4n;
        cp_async16(dst + row * coutp + 4 * c4, src + 4 * (size_t)e);
      }
    } else {
      for (int e = tid; e < wrows * g.cout; e += nthreads) {
        const int row = e / g.cout;
        cp_async4(dst + row * coutp + (e - row * g.cout), src + e);
      }
    }
    cp_async_commit();
  };
  load_stage(0, 0);  // one group with the band's copies

  const int run = tid / g.G;
  const int grp = tid - run * g.G;
  const int q0 = kRun * run;
  // the run's first pixel: band row r0, column c0 (the run's pixels are
  // walked from it, across row ends, at every tap)
  const int r0 = q0 / g.Wo;
  const int c0 = q0 - r0 * g.Wo;
  float acc[kRun][kCh];
#pragma unroll
  for (int i = 0; i < kRun; ++i)
#pragma unroll
    for (int j = 0; j < kCh; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < nstages; ++s) {
    if (s + 1 < nstages) {
      load_stage(s + 1, (s + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 1
    for (int tl = 0; tl < g.TPS; ++tl) {
      const int tap = s * g.TPS + tl;
      const int kh = tap / 3;
      const int kw = tap - 3 * kh;
      const int dp = (2 * kh + (kw & 1)) * g.Wq + (kw >> 1);
      // pixel (r, ow) reads plane pixel 4 r Wq + ow + dp; a pixel past the
      // band's rows reads its last row's (computed, not stored)
      int xo[kRun];
      {
        int r = r0, c = c0;
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          xo[i] = band_off(4 * min(r, g.CR - 1) * g.Wq + c + dp, g.CS);
          if (++c == g.Wo) c = 0, ++r;
        }
      }
      const float* wr =
          ring + (s & 1) * g.slot_floats + tl * g.cin * coutp + grp * 4;
#pragma unroll 4
      for (int ci = 0; ci < g.cin; ++ci) {
        float xv[kRun];
#pragma unroll
        for (int i = 0; i < kRun; ++i) xv[i] = band[xo[i] + ci];
        float wv[kCh];
#pragma unroll
        for (int h = 0; h < kCh / 4; ++h) {
          const float4 wh = *reinterpret_cast<const float4*>(wr + h * half);
          wv[4 * h] = wh.x;
          wv[4 * h + 1] = wh.y;
          wv[4 * h + 2] = wh.z;
          wv[4 * h + 3] = wh.w;
        }
#pragma unroll
        for (int i = 0; i < kRun; ++i)
#pragma unroll
          for (int j = 0; j < kCh; ++j)
            acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
        wr += coutp;
      }
    }
    __syncthreads();
  }

  // pixel i is valid where q0 + i is within the band's rows; accumulator j
  // is channel co(j) = 4 grp + j for j < 4, 4 (G + grp) + j - 4 above
  unsigned valid = 0;
#pragma unroll
  for (int i = 0; i < kRun; ++i)
    if (q0 + i < npx) valid |= 1u << i;
  auto co = [&](int j) { return 4 * grp + j + (j >= 4 ? half - 4 : 0); };
  if (bias != nullptr) {
    const float* bt = bias + (size_t)t * g.cout;
#pragma unroll
    for (int j = 0; j < kCh; ++j) {
      const float bj = co(j) < g.cout ? bt[co(j)] : 0.f;
#pragma unroll
      for (int i = 0; i < kRun; ++i) acc[i][j] += bj;
    }
  }
  {
    // the band's output pixels are contiguous in y: pixel q at oh0 Wo + q
    float* yb = y + (((size_t)t * g.N + img) * g.Ho * g.Wo +
                     (size_t)oh0 * g.Wo) * g.cout;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if ((valid >> i) & 1u) {
        float* dst = yb + (size_t)(q0 + i) * g.cout;
#pragma unroll
        for (int h = 0; h < kCh / 4; ++h) {
          const int cb = co(4 * h);
          if (g.vec_y && cb + 4 <= g.cout) {
            *reinterpret_cast<float4*>(dst + cb) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                            acc[i][4 * h + 2], acc[i][4 * h + 3]);
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (cb + k < g.cout) dst[cb + k] = acc[i][4 * h + k];
          }
        }
      }
    }
  }
  if (kStats) {
    // per channel over the band's valid pixels: the sum, then the band's
    // mean, then the sum of squared deviations from it (M2); each pass sums
    // a thread's valid pixels, then a warp's lanes of one channel group (G
    // apart) by a shuffle tree, then the warps in order
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = (nthreads + 31) >> 5;
    const int lanes = min(32, nthreads - 32 * warp);
    const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
    float* wsum = smem;                    // nwarps x coutp
    float* cmean = wsum + nwarps * coutp;  // coutp
    auto warp_sums = [&](float v[kCh]) {
      for (int off = g.G; off < 32; off <<= 1) {
#pragma unroll
        for (int j = 0; j < kCh; ++j) {
          const float o = __shfl_down_sync(mask, v[j], off);
          if (lane + off < lanes) v[j] += o;
        }
      }
      if (lane < g.G) {
#pragma unroll
        for (int j = 0; j < kCh; ++j) wsum[warp * coutp + co(j)] = v[j];
      }
    };
    auto block_sum = [&](int cc) {
      const int grp_cc = (cc >> 2) % g.G;
      float sum = 0.f;
      for (int wp = 0; wp < nwarps; ++wp) {
        const int first = ((grp_cc - 32 * wp) % g.G + g.G) % g.G;
        if (first < min(g.G, min(32, nthreads - 32 * wp)))
          sum += wsum[wp * coutp + cc];
      }
      return sum;
    };
    float v[kCh];
#pragma unroll
    for (int j = 0; j < kCh; ++j) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kRun; ++i)
        if ((valid >> i) & 1u) sum += acc[i][j];
      v[j] = sum;
    }
    warp_sums(v);
    __syncthreads();
    for (int cc = tid; cc < coutp; cc += nthreads)
      cmean[cc] = block_sum(cc) / (float)npx;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCh; ++j) {
      const float mu = cmean[co(j)];
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        if ((valid >> i) & 1u) {
          const float d = acc[i][j] - mu;
          q = fmaf(d, d, q);
        }
      }
      v[j] = q;
    }
    warp_sums(v);
    __syncthreads();
    for (int cc = tid; cc < g.cout; cc += nthreads) {
      float* p = part + ((size_t)t * gridDim.x + blockIdx.x) * 3 * g.cout + cc;
      p[0] = (float)npx;
      p[g.cout] = cmean[cc];
      p[2 * g.cout] = block_sum(cc);
    }
  }
}

// The geometry of the plan (kernels/conv_block.py::fwd_plan, kernel "s2")
// at this shape; false where the shape or the plan's threads and shared
// memory do not match it.
bool s2_fwd_geom(S2FwdGeom& g, int T, int N, int H, int W, int pad, int cin,
                 int cout, int band_rows, int channels, int threads,
                 int smem) {
  if ((pad != 0 && pad != 1) || H + 2 * pad < 3 || W + 2 * pad < 3)
    return false;
  g.N = N, g.H = H, g.W = W, g.cin = cin, g.cout = cout, g.pad = pad;
  g.Ho = (H + 2 * pad - 3) / 2 + 1;
  g.Wo = (W + 2 * pad - 3) / 2 + 1;
  if (T < 1 || N < 1 || H < 1 || W < 1 || cin < 1 || cout < 1 ||
      band_rows < 1 || band_rows > g.Ho || T > 65535 ||
      (channels != 8 && channels != 4))
    return false;
  g.Wq = g.Wo + 1;
  g.CR = band_rows;
  g.nb = cdiv(g.Ho, band_rows);
  g.CS = round4(cin);
  g.G = cdiv(cout, channels);
  g.runs = cdiv(band_rows * g.Wo, kRun);
  g.TPS = cin <= 4 ? 9 : 1;
  g.band_floats = round4(band_off((2 * band_rows + 1) * 2 * g.Wq, g.CS));
  g.slot_floats = g.TPS * cin * channels * g.G;
  const int coutp = channels * g.G;
  const int stage = g.band_floats + 2 * g.slot_floats;
  const int stats = ((threads + 31) / 32 + 1) * coutp;
  const int want = (stage > stats ? stage : stats) * 4;
  return threads == g.runs * g.G && threads <= kMaxThreads &&
         smem == want && smem <= kMaxSmem &&
         (long long)N * g.nb <= 0x7fffffffLL &&
         (long long)N * H * W * cin < (1ll << 31) &&
         (long long)N * g.Ho * g.Wo * cout < (1ll << 31);
}

template <bool kStats, int kCh>
cudaError_t launch_s2_fwd(const float* x, const float* w, const float* b,
                          float* y, float* part, const S2FwdGeom& g, int T,
                          int threads, int smem, cudaStream_t st) {
  static bool done[64] = {};
  cudaError_t err = allow_smem(conv3x3_s2_fwd_kernel<kStats, kCh>, done);
  if (err != cudaSuccess) return err;
  conv3x3_s2_fwd_kernel<kStats, kCh>
      <<<dim3(g.N * g.nb, 1, T), threads, smem, st>>>(x, w, b, y, part, g);
  return cudaGetLastError();
}

void s2_fwd_vectors(S2FwdGeom& g, const void* x, const void* w,
                    const void* y) {
  g.vec_x = g.cin % 4 == 0 && aligned16(x);
  g.vec_w = g.cout % 4 == 0 && aligned16(w);
  g.vec_y = g.cout % 4 == 0 && aligned16(y);
}

// --- f32 dgrad ---------------------------------------------------------------

struct S2DgradGeom {
  int N, H, W, Ho, Wo, cin, cout, pad;
  int NA, NB;  // quad rows and columns an image: (H + pad + 1) / 2, ...
  int Wb;      // NB + 1: a staged dy row's pixels (column -1 first)
  int CR;      // quad rows a band
  int nb;      // bands an image
  int CP;      // floats a dy pixel and a weight row in shared memory
  int coutp;   // cout rounded up to 4: the float4 steps of the sum
  int CG;      // channel groups
  int PG;      // quad groups
  int band_floats, slot_floats;
  int vec_dy, vec_w;
};

// Block (image * nb + band, 1, tenant). Thread (quad group pg, channel
// group cg): the band's quads pg + PG i (i < 8; quad m at row m / NB,
// column m % NB), channels cg + CG j (j < TN), one class at a time.
template <int TN>
__global__ void __launch_bounds__(kMaxThreads, 2)
conv3x3_s2_dgrad_kernel(const float* __restrict__ dy,
                        const float* __restrict__ w, float* __restrict__ dx,
                        S2DgradGeom g) {
  extern __shared__ __align__(16) float smem[];
  float* band = smem;
  float* ring = smem + g.band_floats;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int t = blockIdx.z;
  const int img = blockIdx.x / g.nb;
  const int A0 = (blockIdx.x - img * g.nb) * g.CR;
  const int rows = min(g.CR, g.NA - A0);
  const int nquads = rows * g.NB;
  const float* dyi = dy + ((size_t)t * g.N + img) * g.Ho * g.Wo * g.cout;
  const float* wt = w + (size_t)t * 9 * g.cin * g.cout;

  // the weight rows' columns cout .. coutp - 1 are zero in both slots
  if (g.coutp != g.cout) {
    const int padc = g.coutp - g.cout;
    for (int e = tid; e < 2 * g.cin * padc; e += nthreads) {
      const int r = e / padc;
      const int s = r / g.cin;
      ring[s * g.slot_floats + (r - s * g.cin) * g.CP + g.cout +
           (e - r * padc)] = 0.f;
    }
  }
  // the band: dy rows A0 - 1 + br (br <= CR), columns bc - 1 (bc < Wb),
  // zero outside dy and past the band's rows
  {
    const int pixels = (g.CR + 1) * g.Wb;
    const int per = g.vec_dy ? g.cout >> 2 : g.coutp;
    for (int e = tid; e < pixels * per; e += nthreads) {
      const int pix = e / per;
      const int c = e - pix * per;
      const int br = pix / g.Wb;
      const int oh = A0 - 1 + br;
      const int ow = pix - br * g.Wb - 1;
      float* dst = band + pix * g.CP;
      if (br > rows || oh < 0 || oh >= g.Ho || ow < 0 || ow >= g.Wo) {
        if (g.vec_dy)
          reinterpret_cast<float4*>(dst)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        else
          dst[c] = 0.f;
        continue;
      }
      const float* src = dyi + ((size_t)oh * g.Wo + ow) * g.cout;
      if (g.vec_dy)
        cp_async16(dst + 4 * c, src + 4 * c);
      else if (c < g.cout)
        cp_async4(dst + c, src + c);
      else
        dst[c] = 0.f;
    }
  }
  // stage i: the cin x cout slab w[kh][kw] of tap kS2Taps(i), rows of cout
  // floats as they lie in HWIO
  const int wrow = g.vec_w ? g.cout >> 2 : g.cout;  // copies a weight row
  auto load_tap = [&](int i, int s) {
    const float* src = wt + (size_t)kS2Taps(i) * g.cin * g.cout;
    float* dst = ring + s * g.slot_floats;
    for (int e = tid; e < g.cin * wrow; e += nthreads) {
      const int ci = e / wrow;
      const int c = e - ci * wrow;
      if (g.vec_w)
        cp_async16(dst + ci * g.CP + 4 * c, src + 4 * (size_t)e);
      else
        cp_async4(dst + ci * g.CP + c, src + e);
    }
    cp_async_commit();
  };
  load_tap(0, 0);  // one group with the band's copies

  const int cg = tid % g.CG;
  const int pg = tid / g.CG;
  int boff[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    int m = pg + g.PG * i;
    if (m >= nquads) m = 0;  // past the band: computed, not stored
    const int r = m / g.NB;
    boff[i] = (r * g.Wb + (m - r * g.NB)) * g.CP;
  }
  float acc[kRun][TN];
  const int wstep = g.CG * g.CP;

  for (int i = 0; i < 9; ++i) {
    if (i + 1 < 9) {
      load_tap(i + 1, (i + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (i == 0 || i == 4 || i == 6 || i == 8) {
#pragma unroll
      for (int p = 0; p < kRun; ++p)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[p][j] = 0.f;
    }
    const float* bt = band + s2_tap_shift(kS2Taps(i), g.Wb) * g.CP;
    const float* ws = ring + (i & 1) * g.slot_floats + cg * g.CP;
#pragma unroll 1
    for (int co = 0; co < g.coutp; co += 4) {
      float4 bv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        bv[j] = *reinterpret_cast<const float4*>(ws + j * wstep + co);
#pragma unroll
      for (int p = 0; p < kRun; ++p) {
        const float4 av = *reinterpret_cast<const float4*>(bt + boff[p] + co);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[p][j] = fmaf(av.x, bv[j].x, acc[p][j]);
          acc[p][j] = fmaf(av.y, bv[j].y, acc[p][j]);
          acc[p][j] = fmaf(av.z, bv[j].z, acc[p][j]);
          acc[p][j] = fmaf(av.w, bv[j].w, acc[p][j]);
        }
      }
    }
    if (kS2ClassEnds(i)) {
      // the class's dx pixels: (2 (A0 + r) + cr - pad, 2 b + cc - pad)
      const int cls = kS2Class(i);
      const int cr = cls >> 1;
      const int cc = cls & 1;
      float* dxi = dx + ((size_t)t * g.N + img) * g.H * g.W * g.cin;
#pragma unroll
      for (int p = 0; p < kRun; ++p) {
        const int m = pg + g.PG * p;
        if (m >= nquads) continue;
        const int r = m / g.NB;
        const int ih = 2 * (A0 + r) + cr - g.pad;
        const int iw = 2 * (m - r * g.NB) + cc - g.pad;
        if (ih < 0 || ih >= g.H || iw < 0 || iw >= g.W) continue;
        float* dst = dxi + ((size_t)ih * g.W + iw) * g.cin;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int ci = cg + g.CG * j;
          if (ci < g.cin) dst[ci] = acc[p][j];
        }
      }
    }
    __syncthreads();
  }
}

// The geometry of the plan (kernels/conv_block.py::dgrad_plan, kernel
// "s2") at this shape; false where it or the plan's threads and shared
// memory do not match it.
bool s2_dgrad_geom(S2DgradGeom& g, int T, int N, int H, int W, int pad,
                   int cin, int cout, int band_rows, int channels,
                   int threads, int smem) {
  if ((pad != 0 && pad != 1) || H + 2 * pad < 3 || W + 2 * pad < 3)
    return false;
  g.N = N, g.H = H, g.W = W, g.cin = cin, g.cout = cout, g.pad = pad;
  g.Ho = (H + 2 * pad - 3) / 2 + 1;
  g.Wo = (W + 2 * pad - 3) / 2 + 1;
  g.NA = (H + pad + 1) / 2;
  g.NB = (W + pad + 1) / 2;
  if (T < 1 || N < 1 || H < 1 || W < 1 || cin < 1 || cout < 1 ||
      band_rows < 1 || band_rows > g.NA || T > 65535 ||
      (channels != 4 && channels != 1))
    return false;
  g.Wb = g.NB + 1;
  g.CR = band_rows;
  g.nb = cdiv(g.NA, band_rows);
  g.coutp = round4(cout);
  g.CP = g.coutp + ((g.coutp / 4) % 2 == 0 ? 4 : 0);
  g.CG = cdiv(cin, channels);
  g.PG = cdiv(band_rows * g.NB, kRun);
  g.band_floats = (band_rows + 1) * g.Wb * g.CP;
  g.slot_floats = g.CG * channels * g.CP;
  const int want = (g.band_floats + 2 * g.slot_floats) * 4;
  return threads == g.PG * g.CG && threads <= kMaxThreads && smem == want &&
         smem <= kMaxSmem && (long long)N * g.nb <= 0x7fffffffLL &&
         (long long)N * H * W * cin < (1ll << 31) &&
         (long long)N * g.Ho * g.Wo * cout < (1ll << 31);
}

template <int TN>
cudaError_t launch_s2_dgrad(const float* dy, const float* w, float* dx,
                            const S2DgradGeom& g, int T, int threads,
                            int smem, cudaStream_t st) {
  static bool done[64] = {};
  cudaError_t err = allow_smem(conv3x3_s2_dgrad_kernel<TN>, done);
  if (err != cudaSuccess) return err;
  conv3x3_s2_dgrad_kernel<TN>
      <<<dim3(g.N * g.nb, 1, T), threads, smem, st>>>(dy, w, dx, g);
  return cudaGetLastError();
}

// --- bf16: the tensor-core kernel --------------------------------------------

constexpr int kMmaThreads = 256;  // most threads a block: 8 warps
constexpr int kWarpPixels = 32;   // GEMM rows a warp: two m16 tiles

struct S2MmaGeom {
  int N;
  int H, W;         // the forward conv's input (dx at dgrad)
  int Ho, Wo;       // its output (dy at dgrad)
  int pad;
  int Cs, Co;       // source and output channels: forward cin, cout;
                    // dgrad cout, cin
  int R, Wr;        // GEMM rows: output rows (Ho) x Wo pixels, or quad
                    // rows (NA) x NB quads
  int Wq;           // forward: Wo + 1, a plane row; dgrad: NB + 1, a
                    // staged dy row
  int CR, nb;       // GEMM rows a band, bands an image
  int warps;        // warps a block
  int packed;       // forward at cin <= 3: the patch rows packed in K
  int taps;         // 9, or 1 packed
  int KC;           // K of a tap: round16(Cs), or round16(9 Cs) packed
  int SA;           // bf16 a staged (or patch) pixel: KC + 8
  int NB;           // output channels a block: 8 NT
  int WS;           // bf16 a weight row (forward: k, NB wide; dgrad: n, KC)
  int OS;           // bf16 a staged output pixel
  int band_px;      // pixels of the band (or patch rows) in shared memory
  int raw_elems;    // packed: the band's input rows, bf16 (even)
  // the regions: the patch matrix and output staging (packed; else 0), the
  // slot (the staged band, or packed its input rows), the weights, the
  // statistics
  int a_bytes, slot_bytes, w_bytes, s_bytes;
  int per;          // bands a block
  int vec_x, vec_w, vec_y;
};

// The tenant's weights for the block's channels [n0, n0 + nvalid), once.
// Forward: taps slabs of KC rows k x NB columns n (row stride WS); slab
// `tap` row k is w[tap][k] (packed: row k of the flattened (9 cin, cout)
// matrix). Dgrad: 9 slabs of NB rows n x KC columns k; slab `tap` row n is
// w[tap][n0 + n][0 .. cout_fwd), read in place.
template <bool kDgrad>
__device__ __forceinline__ void s2_stage_weights(bf16* sw, const bf16* wt,
                                                 const S2MmaGeom& g, int n0,
                                                 int nvalid) {
  const int tid = threadIdx.x;
  if (!kDgrad) {
    const int units = g.NB / 8;
    const int rows = g.taps * g.KC;
    for (int e = tid; e < rows * units; e += blockDim.x) {
      const int row = e / units;
      const int u = e - row * units;
      const int tap = row / g.KC;
      const int k = row - tap * g.KC;
      const bool ok = g.packed ? k < 9 * g.Cs : k < g.Cs;
      const int krow = g.packed ? k : tap * g.Cs + k;
      const int valid = ok ? min(8, nvalid - 8 * u) : 0;
      stage8(sw + row * g.WS + 8 * u,
             wt + (size_t)krow * g.Co + n0 + 8 * u, valid, g.vec_w != 0);
    }
  } else {
    const int units = g.KC / 8;
    const int rows = 9 * g.NB;
    for (int e = tid; e < rows * units; e += blockDim.x) {
      const int row = e / units;  // tap * NB + n
      const int u = e - row * units;
      const int tap = row / g.NB;
      const int n = row - tap * g.NB;
      const int valid = n < nvalid ? min(8, g.Cs - 8 * u) : 0;
      stage8(sw + row * g.WS + 8 * u,
             wt + ((size_t)tap * g.Co + n0 + n) * g.Cs + 8 * u, valid,
             g.vec_w != 0);
    }
  }
}

// The band at GEMM row `row0` (`rows` rows) into the slot, in flight
// (cp.async) until the caller waits. Forward: input rows 2 row0 - pad + rr
// (rr < 2 CR + 1), band columns c < 2 Wq (input column c - pad) to plane
// pixel (2 rr + (c & 1)) Wq + c / 2, each KC channels (zero past Cs,
// outside the image and past the band's rows). Dgrad: dy rows row0 - 1 +
// br (br <= CR), columns bc - 1 (bc < Wq), zero outside dy and past the
// band's rows. Packed: the input rows inside the image as they lie in
// memory (W x Cs bf16 a row), by 4-byte cp.async where `vec_x`.
template <bool kDgrad>
__device__ __forceinline__ void s2_stage_band(bf16* slot, const bf16* src,
                                              const S2MmaGeom& g, int row0,
                                              int rows) {
  const int tid = threadIdx.x;
  if (!kDgrad && g.packed) {
    const int ih_lo = max(0, 2 * row0 - g.pad);
    const int ih_hi = min(g.H, 2 * row0 - g.pad + 2 * rows + 1);
    const int n = (ih_hi - ih_lo) * g.W * g.Cs;
    const bf16* from = src + (size_t)ih_lo * g.W * g.Cs;
    if (g.vec_x) {
      for (int e = tid; e < n / 2; e += blockDim.x)
        cp_async4(slot + 2 * e, from + 2 * e);
    } else {
      for (int e = tid; e < n; e += blockDim.x) slot[e] = from[e];
    }
    return;
  }
  const int units = g.KC / 8;
  const int cols = kDgrad ? g.Wq : 2 * g.Wq;
  for (int e = tid; e < g.band_px * units; e += blockDim.x) {
    const int p = e / units;
    const int u = e - p * units;
    const int rr = p / cols;
    const int c = p - rr * cols;
    int sh, sw, at;
    bool live;
    if (kDgrad) {
      sh = row0 - 1 + rr;
      sw = c - 1;
      at = p;
      live = rr <= rows;
    } else {
      sh = 2 * row0 - g.pad + rr;
      sw = c - g.pad;
      at = (2 * rr + (c & 1)) * g.Wq + (c >> 1);
      live = rr < 2 * rows + 1;
    }
    const int Hs = kDgrad ? g.Ho : g.H;
    const int Ws = kDgrad ? g.Wo : g.W;
    bf16* dst = slot + at * g.SA + 8 * u;
    if (live && sh >= 0 && sh < Hs && sw >= 0 && sw < Ws) {
      stage8(dst, src + ((size_t)sh * Ws + sw) * g.Cs + 8 * u,
             min(8, g.Cs - 8 * u), g.vec_x != 0);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Packed (forward at cin <= 3): the band's patch matrix from its input rows
// in `raw`. A thread a GEMM row q = r Wo + ow of the warps' rows: its 9 CIN
// patch values, column (3 kh + kw) CIN + ci, input (2 (row0 + r) - pad +
// kh, 2 ow - pad + kw), zero past 9 CIN and outside the image, then KP / 8
// 16-byte stores.
template <int CIN>
__device__ __forceinline__ void s2_build_patches(bf16* sa, const bf16* raw,
                                                 const S2MmaGeom& g,
                                                 int row0, int rows) {
  constexpr int KP = (9 * CIN + 15) & ~15;
  const int ih_lo = max(0, 2 * row0 - g.pad);
  const int ih_hi = min(g.H, 2 * row0 - g.pad + 2 * rows + 1);
  for (int q = threadIdx.x; q < g.warps * kWarpPixels; q += blockDim.x) {
    const int r = q / g.Wo;
    const int ih0 = 2 * (row0 + r) - g.pad;
    const int iw0 = 2 * (q - r * g.Wo) - g.pad;
    __align__(16) bf16 v[KP];
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int ih = ih0 + kh;
      const bool row = r < rows && ih >= ih_lo && ih < ih_hi;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int iw = iw0 + kw;
        const bool ok = row && iw >= 0 && iw < g.W;
        const bf16* p = raw + ((size_t)(ih - ih_lo) * g.W + iw) * CIN;
#pragma unroll
        for (int ci = 0; ci < CIN; ++ci)
          v[(3 * kh + kw) * CIN + ci] = ok ? p[ci] : __float2bfloat16_rn(0.f);
      }
    }
#pragma unroll
    for (int k = 9 * CIN; k < KP; ++k) v[k] = __float2bfloat16_rn(0.f);
#pragma unroll
    for (int u = 0; u < KP / 8; ++u)
      *reinterpret_cast<uint4*>(sa + q * g.SA + 8 * u) =
          reinterpret_cast<const uint4*>(v)[u];
  }
}

// Block (chunk of bands, channel chunk, tenant). Warp w: GEMM rows q = 32 w
// .. 32 w + 31 of the band x the block's NB channels; lane (g8 = lane / 4,
// t4 = lane % 4) holds accumulator acc[mt][nt][i] of row 32 w + 16 mt + g8
// + 8 (i / 2) and channel 8 nt + 2 t4 + i % 2 (the m16n8 C fragment). The
// forward's rows are output pixels (q = r Wo + ow); the dgrad's quads (q =
// r NB + b), taken class by class.
template <int NT, bool kStats, bool kDgrad>
__global__ void __launch_bounds__(kMmaThreads, 2)
conv3x3_s2_mma_kernel(const bf16* __restrict__ src,
                      const bf16* __restrict__ w, const bf16* bias,
                      bf16* __restrict__ out, float* __restrict__ part,
                      S2MmaGeom g) {
  constexpr int NB = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* slot = reinterpret_cast<bf16*>(smem_b + g.a_bytes);
  bf16* sw = reinterpret_cast<bf16*>(smem_b + g.a_bytes + g.slot_bytes);
  float* wsum = reinterpret_cast<float*>(smem_b + g.a_bytes + g.slot_bytes +
                                         g.w_bytes);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int t = blockIdx.z;
  const int n0 = blockIdx.y * NB;
  const int nvalid = min(NB, g.Co - n0);
  const int Hs = kDgrad ? g.Ho : g.H;
  const int Ws = kDgrad ? g.Wo : g.W;
  const int Ho_out = kDgrad ? g.H : g.Ho;
  const int Wo_out = kDgrad ? g.W : g.Wo;
  const bf16* srct = src + (size_t)t * g.N * Hs * Ws * g.Cs;
  s2_stage_weights<kDgrad>(sw, w + (size_t)t * 9 * g.Cs * g.Co, g, n0,
                           nvalid);

  // B: forward row k = lane & 15, columns 8 (lane / 16) of each 16-column
  // pair (ldmatrix.trans); dgrad row n = 8 (lane / 16) + (lane & 7) of each
  // pair, k half (lane / 8) & 1 (plain ldmatrix)
  const uint32_t b_lane =
      kDgrad ? smem_addr(sw) + 2u * ((((lane >> 4) << 3) + (lane & 7)) * g.WS +
                                     ((lane >> 3) & 1) * 8)
             : smem_addr(sw) + 2u * ((lane & 15) * g.WS + (lane >> 4) * 8);
  const uint32_t b_tap = 2u * (kDgrad ? NB * g.WS : g.KC * g.WS);
  const uint32_t b_pair = 2u * (kDgrad ? 16 * g.WS : 16);
  const uint32_t b_k16 = 2u * (kDgrad ? 16 : 16 * g.WS);
  bf16* sa = g.packed ? reinterpret_cast<bf16*>(smem_b) : slot;

  const int total = g.N * g.nb;
  const int first = blockIdx.x * g.per;
  const int last = min(total, first + g.per);
  for (int band = first; band < last; ++band) {
    const int img = band / g.nb;
    const int row0 = (band - img * g.nb) * g.CR;
    const int rows = min(g.CR, g.R - row0);
    const int npx = rows * g.Wr;
    s2_stage_band<kDgrad>(slot, srct + (size_t)img * Hs * Ws * g.Cs, g, row0,
                          rows);
    cp_async_commit();  // the first band's with the weights
    cp_async_wait<0>();
    __syncthreads();
    if (!kDgrad && g.packed) {
      if (g.Cs == 1)
        s2_build_patches<1>(sa, slot, g, row0, rows);
      else if (g.Cs == 2)
        s2_build_patches<2>(sa, slot, g, row0, rows);
      else
        s2_build_patches<3>(sa, slot, g, row0, rows);
      __syncthreads();
    }
    // the lanes' A row addresses: row 16 mt + (lane & 15) of the warp's,
    // k half lane / 16; a row past the band reads row 0's (computed, not
    // stored)
    uint32_t a_lane[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      int q = warp * kWarpPixels + 16 * mt + (lane & 15);
      if (q >= npx) q = 0;
      const int r = q / g.Wr;
      const int c = q - r * g.Wr;
      const int p = g.packed ? q : kDgrad ? r * g.Wq + c : 4 * r * g.Wq + c;
      a_lane[mt] = smem_addr(sa) + 2u * (p * g.SA + (lane >> 4) * 8);
    }

    float acc[2][NT][4];
    const int classes = kDgrad ? 4 : 1;
    for (int cls = 0; cls < classes; ++cls) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
      const int i0 = kDgrad ? (cls == 0 ? 0 : 2 + 2 * cls) : 0;
      const int i1 = kDgrad ? (cls == 3 ? 9 : 4 + 2 * cls) : g.taps;
#pragma unroll 1
      for (int i = i0; i < i1; ++i) {
        int tap, shift;
        if (kDgrad) {
          tap = kS2Taps(i);
          shift = s2_tap_shift(tap, g.Wq);
        } else {
          tap = i;
          const int kh = tap / 3;
          const int kw = tap - 3 * kh;
          shift = g.packed ? 0 : (2 * kh + (kw & 1)) * g.Wq + (kw >> 1);
        }
        uint32_t a0 = a_lane[0] + 2u * shift * g.SA;
        uint32_t a1 = a_lane[1] + 2u * shift * g.SA;
        uint32_t b_addr = b_lane + tap * b_tap;
#pragma unroll 1
        for (int k0 = 0; k0 < g.KC; k0 += 16) {
          uint32_t a[2][4];
          ldsm_x4(a[0], a0);
          ldsm_x4(a[1], a1);
          uint32_t b[NT][2];
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t r4[4];
            if (kDgrad)
              ldsm_x4(r4, b_addr + np * b_pair);
            else
              ldsm_x4_t(r4, b_addr + np * b_pair);
            b[2 * np][0] = r4[0];
            b[2 * np][1] = r4[1];
            b[2 * np + 1][0] = r4[2];
            b[2 * np + 1][1] = r4[3];
          }
          if (NT % 2) {
            if (kDgrad)
              ldsm_x2(b[NT - 1][0], b[NT - 1][1], b_addr + (NT / 2) * b_pair);
            else
              ldsm_x2_t(b[NT - 1][0], b[NT - 1][1],
                        b_addr + (NT / 2) * b_pair);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
          a0 += 32u;  // 16 bf16
          a1 += 32u;
          b_addr += b_k16;
        }
      }
      if (kDgrad) {
        // the class's dx pixels, each sum rounded once, two channels a
        // store where dx's rows keep them 4-byte aligned
        const int cr = cls >> 1;
        const int cc = cls & 1;
        bf16* oi = out + ((size_t)t * g.N + img) * Ho_out * Wo_out * g.Co +
                   n0;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int q = warp * kWarpPixels + 16 * mt + g8 + 8 * h;
            if (q >= npx) continue;
            const int r = q / g.Wr;
            const int ih = 2 * (row0 + r) + cr - g.pad;
            const int iw = 2 * (q - r * g.Wr) + cc - g.pad;
            if (ih < 0 || ih >= Ho_out || iw < 0 || iw >= Wo_out) continue;
            bf16* dst = oi + ((size_t)ih * Wo_out + iw) * g.Co;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const int n = 8 * nt + 2 * t4;
              const __nv_bfloat162 v = __floats2bfloat162_rn(
                  acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
              if (g.vec_y && n + 1 < nvalid) {
                *reinterpret_cast<__nv_bfloat162*>(dst + n) = v;
              } else {
                if (n < nvalid) dst[n] = __low2bfloat16(v);
                if (n + 1 < nvalid) dst[n + 1] = __high2bfloat16(v);
              }
            }
          }
      }
    }
    if (kDgrad) {
      __syncthreads();  // every warp is done with the band
      continue;
    }
    __syncthreads();  // every warp is done with the band

    // 1. the sum rounded once, the bias add rounded again, two channels a
    // conversion; 3. (first half) the rounded pixels into shared memory
    // (the band's or the patch matrix's space)
    unsigned valid = 0;  // bit 2 mt + h: row 16 mt + g8 + 8 h
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (warp * kWarpPixels + 16 * mt + g8 + 8 * h < npx)
          valid |= 1u << (2 * mt + h);
    {
      bf16* st = sa + warp * kWarpPixels * g.OS;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = 8 * nt + 2 * t4;
        float2 bj = make_float2(0.f, 0.f);
        if (bias != nullptr) {
          const bf16* bt = bias + t * g.Co + n0 + n;
          if (n < nvalid) bj.x = __bfloat162float(bt[0]);
          if (n + 1 < nvalid) bj.y = __bfloat162float(bt[1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            __nv_bfloat162 r = __floats2bfloat162_rn(acc[mt][nt][2 * h],
                                                     acc[mt][nt][2 * h + 1]);
            if (bias != nullptr) {
              const float2 f = __bfloat1622float2(r);
              r = __floats2bfloat162_rn(f.x + bj.x, f.y + bj.y);
            }
            const float2 f = __bfloat1622float2(r);
            acc[mt][nt][2 * h] = f.x;
            acc[mt][nt][2 * h + 1] = f.y;
            *reinterpret_cast<__nv_bfloat162*>(
                st + (16 * mt + g8 + 8 * h) * g.OS + n) = r;
          }
      }
      // 3. 16-byte stores of each valid pixel's channels; the band's
      // output pixels are contiguous in y from row0 Wo on
      __syncwarp();
      bf16* oi = out + (((size_t)t * g.N + img) * Ho_out * Wo_out +
                        (size_t)row0 * Wo_out) * g.Co + n0;
      for (int e = lane; e < kWarpPixels * NT; e += 32) {
        const int px = e / NT;
        const int ch = 8 * (e - px * NT);
        const int q = warp * kWarpPixels + px;
        if (q >= npx || ch >= nvalid) continue;
        bf16* dst = oi + (size_t)q * g.Co + ch;
        const bf16* s = st + px * g.OS + ch;
        if (g.vec_y && ch + 8 <= nvalid) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(s);
        } else {
          for (int j = 0; j < 8 && ch + j < nvalid; ++j) dst[j] = s[j];
        }
      }
    }
    if (kStats) {
      // 2. per warp and channel over its valid pixels: the count, the sum,
      // and M2 about the warp's mean (a thread's pixels, then the xor tree
      // over the 8 lanes of a channel pair), into the warp's rows of shared
      // memory; then per channel the band's count, mean and M2 from the
      // warps in order (as conv3x3_s1_bf16.cu)
      int cnt = __popc(valid);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
      const float wn = (float)cnt;
      const float rn = cnt ? 1.f / wn : 0.f;
      float s[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float sum = 0.f;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if ((valid >> (2 * mt + h)) & 1u) sum += acc[mt][nt][2 * h + j];
          s[nt][j] = sum;
        }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            s[nt][j] += __shfl_xor_sync(0xffffffffu, s[nt][j], off);
      float* wst = wsum + warp * 3 * NB;
      float q[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float mu = s[nt][j] * rn;
          float m2 = 0.f;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if ((valid >> (2 * mt + h)) & 1u) {
                const float d = acc[mt][nt][2 * h + j] - mu;
                m2 = fmaf(d, d, m2);
              }
          q[nt][j] = m2;
        }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            q[nt][j] += __shfl_xor_sync(0xffffffffu, q[nt][j], off);
      if (g8 == 0) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int n = 8 * nt + 2 * t4 + j;
            wst[n] = wn;
            wst[NB + n] = s[nt][j];
            wst[2 * NB + n] = q[nt][j];
          }
      }
      __syncthreads();
      for (int cc = tid; cc < nvalid; cc += blockDim.x) {
        float n = 0.f, sum = 0.f;
        for (int wp = 0; wp < g.warps; ++wp) {
          n += wsum[wp * 3 * NB + cc];
          sum += wsum[wp * 3 * NB + NB + cc];
        }
        const float mu = sum / n;
        float m2 = 0.f;
        for (int wp = 0; wp < g.warps; ++wp) {
          const float* o = wsum + wp * 3 * NB + cc;
          if (o[0] > 0.f) {
            const float d = o[NB] / o[0] - mu;
            m2 += o[2 * NB] + o[0] * d * d;
          }
        }
        float* p = part + ((size_t)t * total + band) * 3 * g.Co + n0 + cc;
        p[0] = n;
        p[g.Co] = mu;
        p[2 * g.Co] = m2;
      }
    }
    __syncthreads();  // the staging and the sums are read: the next band
  }
  cp_async_wait<0>();  // a block without bands: its weights' copies
}

inline int round16(int a) { return (a + 15) & ~15; }

// The geometry of the plan (kernels/conv_block.py::fwd_plan / dgrad_plan,
// kernel "s2_mma") at this shape; false where the shape or the plan's
// `channels` (NB), `blocks` (grid.x), `threads` and `smem` do not match
// it. H, W, cin, cout are the forward conv's (dx's size and channels at
// dgrad).
bool s2_mma_geom(S2MmaGeom& g, bool dgrad, int T, int N, int H, int W,
                 int pad, int cin, int cout, int band_rows, int channels,
                 int blocks, int threads, int smem) {
  if ((pad != 0 && pad != 1) || T < 1 || T > 65535 || N < 1 || H < 1 ||
      W < 1 || H + 2 * pad < 3 || W + 2 * pad < 3 || cin < 1 || cout < 1 ||
      band_rows < 1)
    return false;
  g.N = N, g.H = H, g.W = W, g.pad = pad;
  g.Ho = (H + 2 * pad - 3) / 2 + 1;
  g.Wo = (W + 2 * pad - 3) / 2 + 1;
  if (!dgrad) {
    g.Cs = cin, g.Co = cout, g.R = g.Ho, g.Wr = g.Wo, g.Wq = g.Wo + 1;
  } else {
    g.Cs = cout, g.Co = cin;
    g.R = (H + pad + 1) / 2, g.Wr = (W + pad + 1) / 2, g.Wq = g.Wr + 1;
  }
  if (band_rows > g.R) return false;
  const int NT = channels / 8;
  if (channels % 8 || (NT != 1 && NT != 2 && NT != 4 && NT != 6 && NT != 8))
    return false;
  g.CR = band_rows;
  g.nb = cdiv(g.R, band_rows);
  g.warps = cdiv(band_rows * g.Wr, kWarpPixels);
  g.packed = !dgrad && g.Cs <= 3;
  g.taps = g.packed ? 1 : 9;
  g.KC = g.packed ? round16(9 * g.Cs) : round16(g.Cs);
  g.SA = g.KC + 8;
  g.NB = channels;
  g.OS = NT % 2 ? channels : channels + 8;
  g.WS = dgrad ? g.KC + 8 : g.OS;
  const int rows_px = kWarpPixels * g.warps;
  g.band_px = g.packed ? rows_px
              : dgrad  ? (band_rows + 1) * g.Wq
                       : (2 * band_rows + 1) * 2 * g.Wq;
  const int band_b = dgrad ? round16(2 * g.band_px * g.SA)
                           : round16(std::max(2 * g.band_px * g.SA,
                                              2 * rows_px * g.OS));
  g.raw_elems = ((2 * band_rows + 1) * g.W * g.Cs + 1) & ~1;
  g.a_bytes = g.packed ? band_b : 0;
  g.slot_bytes = g.packed ? round16(2 * g.raw_elems) : band_b;
  g.w_bytes = dgrad ? 2 * 9 * channels * g.WS : 2 * g.taps * g.KC * g.WS;
  g.s_bytes = dgrad ? 0 : 4 * 3 * g.warps * channels;
  const long long X = (long long)N * g.nb;
  if (blocks < 1 || blocks > X) return false;
  g.per = (int)((X + blocks - 1) / blocks);
  const int want = g.a_bytes + g.slot_bytes + g.w_bytes + g.s_bytes;
  return threads == kWarpPixels * g.warps && threads <= kMmaThreads &&
         smem == want && smem <= kMaxSmem && cdiv(g.Co, channels) <= 65535 &&
         (long long)N * g.H * g.W * cin < (1ll << 31) &&
         (long long)N * g.Ho * g.Wo * cout < (1ll << 31);
}

template <int NT, bool kStats, bool kDgrad>
cudaError_t launch_s2_mma(const bf16* src, const bf16* w, const bf16* b,
                          bf16* out, float* part, const S2MmaGeom& g, int T,
                          int blocks, int threads, int smem,
                          cudaStream_t st) {
  static bool done[64] = {};
  cudaError_t err =
      allow_smem(conv3x3_s2_mma_kernel<NT, kStats, kDgrad>, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, cdiv(g.Co, g.NB), T);
  conv3x3_s2_mma_kernel<NT, kStats, kDgrad>
      <<<grid, threads, smem, st>>>(src, w, b, out, part, g);
  return cudaGetLastError();
}

template <bool kStats, bool kDgrad>
cudaError_t dispatch_s2_mma(const bf16* src, const bf16* w, const bf16* b,
                            bf16* out, float* part, const S2MmaGeom& g,
                            int T, int blocks, int threads, int smem,
                            cudaStream_t st) {
  switch (g.NB / 8) {
    case 1:
      return launch_s2_mma<1, kStats, kDgrad>(src, w, b, out, part, g, T,
                                              blocks, threads, smem, st);
    case 2:
      return launch_s2_mma<2, kStats, kDgrad>(src, w, b, out, part, g, T,
                                              blocks, threads, smem, st);
    case 4:
      return launch_s2_mma<4, kStats, kDgrad>(src, w, b, out, part, g, T,
                                              blocks, threads, smem, st);
    case 6:
      return launch_s2_mma<6, kStats, kDgrad>(src, w, b, out, part, g, T,
                                              blocks, threads, smem, st);
    case 8:
      return launch_s2_mma<8, kStats, kDgrad>(src, w, b, out, part, g, T,
                                              blocks, threads, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// 16-byte copies where every row of 8 bf16 starts on 16 bytes: the source
// rows of Cs (packed: 4-byte copies of the rows, W Cs even), the weights'
// rows (forward: cout; dgrad: cout_fwd = Cs); the output: forward 16-byte
// stores (Co % 8), dgrad two channels a store (Co even, 4-byte aligned)
void s2_mma_vectors(S2MmaGeom& g, bool dgrad, const void* src, const void* w,
                    const void* out) {
  const unsigned long long o = reinterpret_cast<unsigned long long>(out);
  g.vec_x = g.packed ? (g.W * g.Cs) % 2 == 0 &&
                           (reinterpret_cast<unsigned long long>(src) & 3) == 0
                     : g.Cs % 8 == 0 && aligned16(src);
  g.vec_w = (dgrad ? g.Cs : g.Co) % 8 == 0 && aligned16(w);
  g.vec_y = dgrad ? g.Co % 2 == 0 && (o & 3) == 0
                  : g.Co % 8 == 0 && aligned16(out);
}

}  // namespace maml

extern "C" {

// y (T, N, Ho, Wo, cout) = the stride-2 conv at `pad` (1 or 0) of x (T, N,
// H, W, cin) with w (T, 3, 3, cin, cout), + b (T, cout) where b is not null;
// Ho = (H + 2 pad - 3) / 2 + 1 (Wo likewise); f32. The plan
// (kernels/conv_block.py::fwd_plan, kernel "s2"): `band_rows`, `channels`
// a thread (8 or 4), `threads` and `smem`, checked here against the
// geometry they follow from. One launch on `stream`; returns its CUDA
// error, 0 on success.
int conv3x3_s2_fwd(const float* x, const float* w, const float* b, float* y,
                   int T, int N, int H, int W, int pad, int cin, int cout,
                   int band_rows, int channels, int threads, int smem,
                   void* stream) {
  using namespace maml;
  S2FwdGeom g;
  if (!s2_fwd_geom(g, T, N, H, W, pad, cin, cout, band_rows, channels,
                   threads, smem))
    return (int)cudaErrorInvalidValue;
  s2_fwd_vectors(g, x, w, y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(channels == 8 ? launch_s2_fwd<false, 8>(x, w, b, y, nullptr,
                                                       g, T, threads, smem,
                                                       st)
                             : launch_s2_fwd<false, 4>(x, w, b, y, nullptr,
                                                       g, T, threads, smem,
                                                       st));
}

// The same with b (T, cout) required, and y's per-(tenant, channel) mean,
// biased var and rstd = 1 / sqrt(var + eps) (T, cout) each; part (T, N *
// bands, 3, cout) is scratch, bands = ceil(Ho / band_rows). Two launches on
// `stream` (the conv, the merge); returns the first CUDA error.
int conv3x3_s2_fwd_stats(const float* x, const float* w, const float* b,
                         float* y, float* part, float* mean, float* var,
                         float* rstd, int T, int N, int H, int W, int pad,
                         int cin, int cout, int band_rows, int channels,
                         int threads, int smem, float eps, void* stream) {
  using namespace maml;
  S2FwdGeom g;
  if (b == nullptr || !s2_fwd_geom(g, T, N, H, W, pad, cin, cout, band_rows,
                                   channels, threads, smem))
    return (int)cudaErrorInvalidValue;
  s2_fwd_vectors(g, x, w, y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      channels == 8
          ? launch_s2_fwd<true, 8>(x, w, b, y, part, g, T, threads, smem, st)
          : launch_s2_fwd<true, 4>(x, w, b, y, part, g, T, threads, smem, st);
  if (err != cudaSuccess) return (int)err;
  bn_stats_merge_kernel<float><<<dim3(cout, T), kMergeThreads, 0, st>>>(
      part, mean, var, rstd, N * g.nb, cout, eps);
  return (int)cudaGetLastError();
}

// dx (T, N, H, W, cin) = the input gradient of the stride-2 conv at `pad`
// with weights w (T, 3, 3, cin, cout), from dy (T, N, Ho, Wo, cout); f32.
// The plan (kernels/conv_block.py::dgrad_plan, kernel "s2"): `band_rows`
// quad rows a band, `channels` a thread (4, or 1 at cin 1), `threads` and
// `smem`,
// checked here. One launch on `stream`.
int conv3x3_s2_dgrad(const float* dy, const float* w, float* dx, int T,
                     int N, int H, int W, int pad, int cin, int cout,
                     int band_rows, int channels, int threads, int smem,
                     void* stream) {
  using namespace maml;
  S2DgradGeom g;
  if (!s2_dgrad_geom(g, T, N, H, W, pad, cin, cout, band_rows, channels,
                     threads, smem))
    return (int)cudaErrorInvalidValue;
  g.vec_dy = cout % 4 == 0 && aligned16(dy);
  g.vec_w = cout % 4 == 0 && aligned16(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(channels == 4
                   ? launch_s2_dgrad<4>(dy, w, dx, g, T, threads, smem, st)
                   : launch_s2_dgrad<1>(dy, w, dx, g, T, threads, smem, st));
}

// The bf16 entries: the same convs with bf16 x, w, b, y (dy, dx), mean,
// var and rstd (part f32 scratch, eps the bf16 value of the batch norm's
// eps). The plan (kernels/conv_block.py::fwd_plan / dgrad_plan, kernel
// "s2_mma"): `band_rows`, `channels` a block, `blocks` (grid.x),
// `threads`, `smem`, checked here against the geometry they follow from.
int conv3x3_s2_fwd_mma(const __nv_bfloat16* x, const __nv_bfloat16* w,
                       const __nv_bfloat16* b, __nv_bfloat16* y, int T,
                       int N, int H, int W, int pad, int cin, int cout,
                       int band_rows, int channels, int blocks, int threads,
                       int smem, void* stream) {
  using namespace maml;
  S2MmaGeom g;
  if (!s2_mma_geom(g, false, T, N, H, W, pad, cin, cout, band_rows, channels,
                   blocks, threads, smem))
    return (int)cudaErrorInvalidValue;
  s2_mma_vectors(g, false, x, w, y);
  return (int)dispatch_s2_mma<false, false>(
      x, w, b, y, nullptr, g, T, blocks, threads, smem,
      static_cast<cudaStream_t>(stream));
}

// With b required and the statistics: part (T, N * bands, 3, cout). Two
// launches on `stream` (the conv, the merge).
int conv3x3_s2_fwd_stats_mma(const __nv_bfloat16* x, const __nv_bfloat16* w,
                             const __nv_bfloat16* b, __nv_bfloat16* y,
                             float* part, __nv_bfloat16* mean,
                             __nv_bfloat16* var, __nv_bfloat16* rstd, int T,
                             int N, int H, int W, int pad, int cin, int cout,
                             int band_rows, int channels, int blocks,
                             int threads, int smem, float eps,
                             void* stream) {
  using namespace maml;
  S2MmaGeom g;
  if (b == nullptr ||
      !s2_mma_geom(g, false, T, N, H, W, pad, cin, cout, band_rows, channels,
                   blocks, threads, smem))
    return (int)cudaErrorInvalidValue;
  s2_mma_vectors(g, false, x, w, y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch_s2_mma<true, false>(x, w, b, y, part, g, T,
                                                 blocks, threads, smem, st);
  if (err != cudaSuccess) return (int)err;
  bn_stats_merge_kernel<__nv_bfloat16>
      <<<dim3(cout, T), kMergeThreads, 0, st>>>(part, mean, var, rstd,
                                                N * g.nb, cout, eps);
  return (int)cudaGetLastError();
}

// dx (T, N, H, W, cin) from dy (T, N, Ho, Wo, cout) and the forward weights
// w (T, 3, 3, cin, cout) in bf16, `band_rows` quad rows a band, `channels`
// of cin a block. One launch on `stream`.
int conv3x3_s2_dgrad_mma(const __nv_bfloat16* dy, const __nv_bfloat16* w,
                         __nv_bfloat16* dx, int T, int N, int H, int W,
                         int pad, int cin, int cout, int band_rows,
                         int channels, int blocks, int threads, int smem,
                         void* stream) {
  using namespace maml;
  S2MmaGeom g;
  if (!s2_mma_geom(g, true, T, N, H, W, pad, cin, cout, band_rows, channels,
                   blocks, threads, smem))
    return (int)cudaErrorInvalidValue;
  s2_mma_vectors(g, true, dy, w, dx);
  return (int)dispatch_s2_mma<false, true>(
      dy, w, nullptr, dx, nullptr, g, T, blocks, threads, smem,
      static_cast<cudaStream_t>(stream));
}

const char* maml_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
