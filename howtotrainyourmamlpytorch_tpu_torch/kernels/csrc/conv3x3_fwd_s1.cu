// K1 at stride 1 in f32: the forward 3x3 conv (pad 1 or 0) with the
// batch-norm statistics of its output (conv3x3_fwd_stats_band) and
// without them (conv3x3_fwd_band, K1's stats-free mode), on band tiles
// staged once in shared memory.
//
// Replaces (JAX package) howtotrainyourmamlpytorch_tpu/ops/functional.py
// ::conv_bn_act :249 — its `_conv2d_raw` :199 (`_im2col` :85 + one GEMM per
// task under vmap) and the statistics pass of `batch_norm` :368 — and, in
// the stats-free mode, `_conv2d_raw` in XLA's second derivative (the
// derivative of dgrad in dy, conv3x3(ddx, w), and of wgrad in dy,
// conv3x3(x, ddw) + ddb). bf16 at stride 1 runs conv3x3_s1_bf16.cu, both
// dtypes at stride 2 conv3x3_s2.cu.
//
// f32 FFMA only (no TF32, no tensor cores: the JAX package multiplies f32 in
// true f32). No atomics: every sum is taken in a fixed order, so two
// launches on the same inputs give the same bits. The launch plan is a pure
// function of the shape (kernels/conv_block.py::fwd_plan); the entry points
// check its threads and shared memory against the geometry here.
//
// Bound on an H100 (67 TFLOP/s FFMA; 3.35 TB/s): at cin 1 and 3 (Omniglot
// layer 1, mini-ImageNet stage 0) the bytes of y bind (813 MB at stage 0,
// N = 75, T = 8: the 48-channel output is 16x the input); at cin 48 and 64
// the FLOPs (2 * 9 * cin * cout a pixel).
//
// * A block owns a band of CR output rows of one image of one tenant and all
//   cout channels, so each patch is gathered once. The band's CR + 2 input
//   rows, each with its halo (zero columns and rows outside the image at
//   pad 1, none at pad 0), go into shared memory once by 16-byte cp.async
//   (4-byte where cin % 4 != 0 or x is not 16-byte aligned), a pixel's cin
//   floats on a stride CS (cin rounded up to 4) and 4 floats more after
//   every 8 pixels (band_off). The row is Wp = Wo + 2 pixels wide at either
//   pad.
// * Output pixel (r, c) of the band is q = r * Wp + c on the Wp-wide grid:
//   tap (kh, kw) reads band pixel q + kh * Wp + kw, so 8 consecutive q read
//   8 consecutive band pixels, across a row's end too. The columns c = Wo,
//   Wo + 1 of each row are computed and dropped (2 of Wp).
// * Each thread holds 8 consecutive q (a run) x 8 output channels: the
//   4-channel chunks grp and G + grp of the G = cout / 8 groups. For each
//   tap and input channel it reads the run's 8 input values and 8 weights
//   (two float4) and runs 64 FFMAs. Where the card would hold too few
//   threads (the small maps), a thread holds 8 x 4 (the chunk grp of G =
//   cout / 4): twice the threads, each with half the chain. Lanes are ordered run-major over the
//   channel groups, so a warp reads at most 8 runs (broadcast among a
//   run's lanes), which the 4 floats after every 8 pixels put in distinct
//   banks, and the lanes of a run read (and store) contiguous 16-byte
//   chunks.
// * Each output's sum runs over (kh, kw, ci) in order with FFMA, one thread
//   from the first product to the last: the order of the tile kernel it
//   replaced and of the plain conv's GEMM over the
//   (kh, kw, ci) patch rows where that GEMM sums in order too: y is the
//   tile's bit for bit and, at the main path's shapes, the plain conv's, so
//   a block built on it takes the plain block's pool and sign decisions
//   (chip_smoke.py's unreplayed block checks rest on that). No split of the
//   sum: small maps (Omniglot 7 x 7 and 3 x 3, mini-ImageNet 10 x 10, the
//   unpadded 8 x 8 -> 6 x 6) take bands of fewer rows and threads of fewer
//   channels instead.
// * The weights stream one tap at a time (all nine at cin <= 4): the
//   tap's cin rows of cout floats as they lie in HWIO (no transposed or
//   flipped copy), each padded with zeros to 8 G, by 16-byte cp.async
//   (4-byte where cout % 4 != 0 or w is not 16-byte aligned) into a
//   two-slot ring: the next tap is in flight while this one computes.
// * Stores: a run's lanes write a pixel's cout floats as float4s (192 or
//   256 contiguous bytes, in two instructions of whole 32-byte sectors),
//   the bias added first.
// * Statistics (conv3x3_fwd_stats_band): in the epilogue, from the
//   registers: per block and channel the count, the mean and M2 (the sum of
//   squared deviations from the block's mean) over the band's valid
//   pixels, each sum taken over a thread's pixels, then a warp's lanes of
//   the channel by a fixed shuffle tree, then the warps in order; a
//   second launch (bn_stats_merge.cuh) merges the (T, N * bands, 3, cout)
//   partials with Chan's formula into the mean, the BIASED variance and
//   rstd = 1 / sqrt(var + eps). The statistics are summed in another order
//   than the tile's, so they may differ from its in the last bits, within
//   the twin's tolerance.

#include <cuda_runtime.h>

#include "band_common.cuh"
#include "bn_stats_merge.cuh"

namespace maml {

constexpr int kRun = 8;    // output pixels a thread (one run of q)
constexpr int kSlack = 8;  // band pixels past the last row a run reads

// Where band pixel q starts in shared memory: CS floats a pixel, and 4
// more after every 8 pixels, so that the runs of a warp (8 pixels apart)
// fall in distinct banks.
__host__ __device__ __forceinline__ int band_off(int q, int CS) {
  return q * CS + ((q >> 3) << 2);
}

struct FwdGeom {
  int N, H, W, Ho, Wo, cin, cout, pad;
  int Wp;    // Wo + 2: a band row's pixels in shared memory
  int CR;    // output rows per band
  int nb;    // bands per image
  int CS;    // floats a band pixel in shared memory (cin rounded up to 4)
  int G;     // channel groups of a thread's kCh; cout is padded to kCh G
  int runs;  // runs of 8 q a band
  int TPS;   // taps a weight stage (9 at cin <= 4, else 1)
  int band_floats, slot_floats;
  int vec_x, vec_w, vec_y;
};

// Block (image * nb + band, 1, tenant). Thread (run, channel group grp):
// band pixels q = 8 run .. 8 run + 7, output channels 4 grp .. 4 grp + 3
// and, with kCh = 8, 4 (G + grp) .. 4 (G + grp) + 3.
template <bool kStats, int kCh>
__global__ void __launch_bounds__(kMaxThreads, 2)
conv3x3_fwd_band_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ bias,
                        float* __restrict__ y, float* __restrict__ part,
                        FwdGeom g) {
  extern __shared__ __align__(16) float smem[];
  float* band = smem;
  float* ring = smem + g.band_floats;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int t = blockIdx.z;
  const int img = blockIdx.x / g.nb;
  const int oh0 = (blockIdx.x - img * g.nb) * g.CR;
  const int rows = min(g.CR, g.Ho - oh0);
  const float* xi = x + ((size_t)t * g.N + img) * g.H * g.W * g.cin;
  const float* wt = w + (size_t)t * 9 * g.cin * g.cout;
  const int coutp = kCh * g.G;
  const int half = 4 * g.G;  // a thread's second 4 channels: 4 G on
  const int wrows = g.TPS * g.cin;  // weight rows a slot

  // the columns cout .. coutp - 1 of every weight row are zero in both
  // slots
  if (coutp != g.cout) {
    const int padc = coutp - g.cout;
    for (int e = tid; e < 2 * wrows * padc; e += nthreads) {
      const int row = e / padc;  // slot * wrows + tap * cin + ci
      const int s = row / wrows;
      ring[s * g.slot_floats + (row - s * wrows) * coutp + g.cout +
           (e - row * padc)] = 0.f;
    }
  }
  // the band: input rows oh0 - pad .. oh0 - pad + CR + 1, columns -pad ..
  // Wp - 1 - pad, zero outside the image and past the band's last row, in
  // units of 4 floats (16-byte copies) or 1, walked from each thread's
  // first unit without a division; then the slack past its last row
  {
    const int width = g.vec_x ? 4 : 1;
    const int per = g.cin / width;  // units a pixel
    const int per_row = g.Wp * per;
    const int total = (g.CR + 2) * per_row;
    int r = tid / per_row;
    int px = (tid - r * per_row) / per;
    int cu = tid - r * per_row - px * per;
    const int dr = nthreads / per_row;
    const int dpx = (nthreads - dr * per_row) / per;
    const int dcu = nthreads - dr * per_row - dpx * per;
    for (int e = tid; e < total; e += nthreads) {
      const int ih = oh0 - g.pad + r;
      const int iw = px - g.pad;
      float* dst = band + band_off(r * g.Wp + px, g.CS) + cu * width;
      if (r < rows + 2 && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W) {
        const float* src = xi + (ih * g.W + iw) * g.cin + cu * width;
        if (g.vec_x)
          cp_async16(dst, src);
        else
          cp_async4(dst, src);
      } else if (g.vec_x) {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        *dst = 0.f;
      }
      cu += dcu;
      px += dpx;
      r += dr;
      if (cu >= per) cu -= per, ++px;
      if (px >= g.Wp) px -= g.Wp, ++r;
    }
    const int slack = band_off((g.CR + 2) * g.Wp, g.CS);
    for (int e = slack + tid; e < g.band_floats; e += nthreads) band[e] = 0.f;
  }
  // stage s: taps s * TPS .. s * TPS + TPS - 1, (kh, kw) in order
  const int nstages = 9 / g.TPS;
  auto load_stage = [&](int s, int slot) {
    float* dst = ring + slot * g.slot_floats;
    const float* src = wt + (size_t)s * wrows * g.cout;
    if (g.vec_w) {
      const int c4n = g.cout >> 2;
      for (int e = tid; e < wrows * c4n; e += nthreads) {
        const int row = e / c4n;  // tap * cin + ci
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
      // the run's 8 band pixels of tap (kh, kw): q0 + kh * Wp + kw + i, at
      // band_off(q0 + kh * Wp + kw) + xo[i]
      const int tap = s * g.TPS + tl;
      const int kh = tap / 3;
      const int m = q0 + kh * g.Wp + tap - 3 * kh;
      const float* xb = band + band_off(m, g.CS);
      const int u = m & 7;
      int xo[kRun];
#pragma unroll
      for (int i = 0; i < kRun; ++i)
        xo[i] = i * g.CS + (((u + i) >> 3) << 2);
      const float* wr =
          ring + (s & 1) * g.slot_floats + tl * g.cin * coutp + grp * 4;
#pragma unroll 4
      for (int ci = 0; ci < g.cin; ++ci) {
        float xv[kRun];
#pragma unroll
        for (int i = 0; i < kRun; ++i) xv[i] = xb[xo[i] + ci];
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

  // the run's first pixel: band row r0, column c0; pixel i is valid where
  // its row is within the band and its column within Wo. Accumulator j is
  // channel co(j) = 4 grp + j for j < 4, 4 (G + grp) + j - 4 above.
  const int r0 = q0 / g.Wp;
  const int c0 = q0 - r0 * g.Wp;
  unsigned valid = 0;
  {
    int r = r0, c = c0;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if (r < rows && c < g.Wo) valid |= 1u << i;
      if (++c == g.Wp) c = 0, ++r;
    }
  }
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
  // a pixel's two float4s: the run's lanes write 4-channel chunks grp and
  // G + grp, each instruction whole 32-byte sectors of the pixel's row
  {
    float* yi = y + ((size_t)t * g.N + img) * g.Ho * g.Wo * g.cout;
    int r = r0, c = c0;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      if ((valid >> i) & 1u) {
        float* dst = yi + ((size_t)(oh0 + r) * g.Wo + c) * g.cout;
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
      if (++c == g.Wp) c = 0, ++r;
    }
  }
  if (kStats) {
    // per channel over the band's valid pixels: the sum, then the block's
    // mean, then the sum of squared deviations from it (M2). Each pass
    // sums a thread's valid pixels, then a warp's lanes of one channel
    // group (G apart) by a shuffle tree, then the warps in order.
    const int cnt = rows * g.Wo;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = (nthreads + 31) >> 5;
    const int lanes = min(32, nthreads - 32 * warp);
    const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
    float* wsum = smem;                    // nwarps x coutp
    float* cmean = wsum + nwarps * coutp;  // coutp
    // a warp's sums of v over its lanes of each channel group, written by
    // its first G lanes (lane l holds channel group (32 warp + l) % G)
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
    // the warps' sums of channel cc, in warp order (a warp whose lanes
    // hold no group of cc adds nothing)
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
      cmean[cc] = block_sum(cc) / (float)cnt;
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
      p[0] = (float)cnt;
      p[g.cout] = cmean[cc];
      p[2 * g.cout] = block_sum(cc);
    }
  }
}

// The geometry of the plan (kernels/conv_block.py::fwd_plan) at this shape;
// false where the shape or the plan's `threads` and `smem` do not match it.
bool fwd_geom(FwdGeom& g, int T, int N, int H, int W, int pad, int cin,
              int cout, int band_rows, int channels, int threads,
              int smem) {
  if (pad != 0 && pad != 1) return false;
  g.N = N, g.H = H, g.W = W, g.cin = cin, g.cout = cout, g.pad = pad;
  g.Ho = H + 2 * pad - 2;
  g.Wo = W + 2 * pad - 2;
  if (T < 1 || N < 1 || g.Ho < 1 || g.Wo < 1 || cin < 1 || cout < 1 ||
      band_rows < 1 || band_rows > g.Ho || T > 65535 ||
      (channels != 8 && channels != 4))
    return false;
  g.Wp = g.Wo + 2;
  g.CR = band_rows;
  g.nb = cdiv(g.Ho, band_rows);
  g.CS = round4(cin);
  g.G = cdiv(cout, channels);
  g.runs = cdiv((band_rows - 1) * g.Wp + g.Wo, kRun);
  g.TPS = cin <= 4 ? 9 : 1;
  g.band_floats = round4(band_off((band_rows + 2) * g.Wp + kSlack, g.CS));
  g.slot_floats = g.TPS * cin * channels * g.G;
  const int coutp = channels * g.G;
  const int stage = g.band_floats + 2 * g.slot_floats;
  const int stats = ((threads + 31) / 32 + 1) * coutp;
  const int want = (stage > stats ? stage : stats) * 4;
  return threads == g.runs * g.G && threads <= kMaxThreads &&
         smem == want && smem <= kMaxSmem &&
         (long long)N * g.nb <= 0x7fffffffLL;
}

template <bool kStats, int kCh>
cudaError_t launch_fwd(const float* x, const float* w, const float* b,
                       float* y, float* part, const FwdGeom& g, dim3 grid,
                       int threads, int smem, cudaStream_t st) {
  static bool done[64] = {};
  cudaError_t err = allow_smem(conv3x3_fwd_band_kernel<kStats, kCh>, done);
  if (err != cudaSuccess) return err;
  conv3x3_fwd_band_kernel<kStats, kCh>
      <<<grid, threads, smem, st>>>(x, w, b, y, part, g);
  return cudaGetLastError();
}

}  // namespace maml

extern "C" {

// y (T, N, Ho, Wo, cout) = the stride-1 conv at `pad` (1 or 0) of x (T, N,
// H, W, cin) with w (T, 3, 3, cin, cout), + b (T, cout) where b is not
// null; Ho = H + 2*pad - 2 (Wo likewise). The launch plan
// (kernels/conv_block.py::fwd_plan): `band_rows`, `channels` a thread (8 or
// 4); `threads` and `smem` are the plan's, checked here against the
// geometry they follow from. One launch on `stream`; returns
// its CUDA error, 0 on success.
int conv3x3_fwd_band(const float* x, const float* w, const float* b,
                     float* y, int T, int N, int H, int W, int pad, int cin,
                     int cout, int band_rows, int channels, int threads,
                     int smem, void* stream) {
  using namespace maml;
  FwdGeom g;
  if (!fwd_geom(g, T, N, H, W, pad, cin, cout, band_rows, channels, threads,
                smem))
    return (int)cudaErrorInvalidValue;
  g.vec_x = cin % 4 == 0 && aligned16(x);
  g.vec_w = cout % 4 == 0 && aligned16(w);
  g.vec_y = cout % 4 == 0 && aligned16(y);
  const dim3 grid(N * g.nb, 1, T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(channels == 8
                   ? launch_fwd<false, 8>(x, w, b, y, nullptr, g, grid,
                                          threads, smem, st)
                   : launch_fwd<false, 4>(x, w, b, y, nullptr, g, grid,
                                          threads, smem, st));
}

// The same with b (T, cout) required, and y's per-(tenant, channel) mean,
// biased var and rstd = 1 / sqrt(var + eps) (T, cout) each; part (T, N *
// bands, 3, cout) is scratch, bands = ceil(Ho / band_rows). Two launches
// on `stream` (the conv, the merge); returns the first CUDA error.
int conv3x3_fwd_stats_band(const float* x, const float* w, const float* b,
                           float* y, float* part, float* mean, float* var,
                           float* rstd, int T, int N, int H, int W, int pad,
                           int cin, int cout, int band_rows, int channels,
                           int threads, int smem, float eps, void* stream) {
  using namespace maml;
  FwdGeom g;
  if (b == nullptr || !fwd_geom(g, T, N, H, W, pad, cin, cout, band_rows,
                                channels, threads, smem))
    return (int)cudaErrorInvalidValue;
  g.vec_x = cin % 4 == 0 && aligned16(x);
  g.vec_w = cout % 4 == 0 && aligned16(w);
  g.vec_y = cout % 4 == 0 && aligned16(y);
  const dim3 grid(N * g.nb, 1, T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      channels == 8
          ? launch_fwd<true, 8>(x, w, b, y, part, g, grid, threads, smem, st)
          : launch_fwd<true, 4>(x, w, b, y, part, g, grid, threads, smem, st);
  if (err != cudaSuccess) return (int)err;
  bn_stats_merge_kernel<float><<<dim3(cout, T), kMergeThreads, 0, st>>>(
      part, mean, var, rstd, N * g.nb, cout, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
