// K4 at stride 1 in f32: the dgrad and the wgrad of the 3x3 conv (pad 1 or
// 0), on band tiles staged once in shared memory.
//
// Replaces (JAX package) the gradient XLA derives for
// howtotrainyourmamlpytorch_tpu/ops/functional.py::_conv2d_raw :199 in the
// inner-loop support gradient (core/maml.py::_task_learner :177-189) and in
// the outer backward: the transposed GEMMs of the `gemm`/`im2col` lowering.
// bf16 at stride 1 runs conv3x3_s1_bf16.cu (dgrad) and
// conv3x3_wgrad_s1_bf16.cu (wgrad); at stride 2 dgrad runs conv3x3_s2.cu,
// wgrad conv3x3_wgrad_s2.cu (the same band kernel, wgrad_band.cuh, with
// the source's pixel stride doubled).
//
// f32 FFMA only (no TF32, no tensor cores: the JAX package multiplies f32 in
// true f32). No atomics: every sum is taken in a fixed order, so two
// launches on the same inputs give the same bits. The launch plans are
// pure functions of the shape (kernels/conv_block.py::wgrad_plan,
// dgrad_plan); the entry points check the plan's threads and shared memory
// against the geometry here.
//
// * conv3x3_wgrad_band: dW[t] = patches(x[t])^T dy[t], db[t] = sum dy[t],
//   the band kernel of wgrad_band.cuh at stride 1. The reduction runs over
//   the M = N*Ho*Wo output pixels (176,400 a tenant at mini-ImageNet stage
//   0), the output is small (27 x 48 at stage 0, 432 x 48 at stage 1).
//   Bound by bytes at cin <= 4 (dy alone is 271 MB at T = 8, N = 25, stage
//   0) and by FLOPs above.
// * conv3x3_dgrad_band: dx = the transposed conv of dy with each tenant's
//   weights, the GEMM dx[M_in, cin] = patches(dy)[M_in, 9*cout] W'[9*cout,
//   cin]. Bound by FLOPs at cin 48 and 64.
//   - A block owns a band of CR input rows of one image and all cin
//     channels, so each dy patch is gathered once. The band's dy rows and
//     their halo (2 - pad rows and columns on each side, zero outside dy)
//     go into shared memory once, each pixel's cout floats on a stride of
//     cout (+ 4 where needed) that keeps the float4 reads free of bank
//     conflicts. The 9 taps read dy from there.
//   - The weights stream one tap at a time: the tap's cin x cout slab,
//     rows of cout floats as they lie in HWIO, by 16-byte cp.async into a
//     two-slot ring (the next tap in flight while this one computes). No
//     transposed read: the reduction runs over cout in float4 steps, and
//     both operands are read along it.
//   - Each thread holds 8 pixels x 8 channels (8 x 4 at cin <= 4): per
//     float4 step 8 + 8 float4 reads feed 256 FFMAs. Pixels are strided by
//     the pixel groups and channels by the channel groups, so neighbouring
//     lanes read neighbouring pixels and weight rows.
//   - The plan sizes the band for at least two blocks a SM, at most 4
//     warps and 75 KB of shared memory (dynamic, above 48 KB): three
//     blocks a SM. Where a band has few pixels (cin <= 4, whose channels
//     are one group; the 7 x 7 and 3 x 3 maps), KS groups of threads split
//     the sum over cout and their tiles are summed in a fixed pairwise tree.
//   With KS = 1 the sum of each output runs over (tap, cout) in order with
//   FFMA, the order of the earlier tile kernel it replaced.
//
// Both kernels' 8 x 8 tiles read 16 floats from shared memory per 64
// FFMAs, which is the SM's shared-memory rate against its FFMA rate: the
// two pipes bound them together, near half the FFMA peak at the 48- and
// 64-channel maps.

#include <cuda_runtime.h>

#include "band_common.cuh"
#include "wgrad_band.cuh"

namespace maml {

constexpr int kTM = 8;            // dgrad: pixels per thread

// --- wgrad ------------------------------------------------------------------

// The band kernel (wgrad_band.cuh) at stride 1.
template <int TK, bool kVecA>
__global__ void __launch_bounds__(kMaxThreads, 2)
conv3x3_wgrad_band_kernel(const float* __restrict__ x,
                          const float* __restrict__ dy,
                          float* __restrict__ part_w,
                          float* __restrict__ part_b, WgradGeom g) {
  wgrad_band_body<1, TK, kVecA>(x, dy, part_w, part_b, g);
}

struct S1Band {
  template <int TK, bool kVecA>
  static auto kernel() {
    return conv3x3_wgrad_band_kernel<TK, kVecA>;
  }
};

// --- dgrad ------------------------------------------------------------------

struct DgradGeom {
  int N, H, W, Ho, Wo, cin, cout, org;  // org = 2 - pad
  int CR;     // input rows per band
  int nb;     // bands per image
  int CP;     // floats a dy pixel and a weight row in shared memory
  int coutp;  // cout rounded up to 4: the float4 steps of the reduction
  int CG;     // channel groups
  int PG;     // pixel groups
  int KS;     // groups splitting the sum over cout (float4 steps)
  int band_floats, slot_floats;
  int vec_dy, vec_w;
};

// Block (image * nb + band, 1, tenant). Thread (cout group ks, pixel group
// pg, channel group cg): pixels pg + PG*i of the band (i < 8), channels
// cg + CG*j (j < TN), the float4 steps ks, ks + KS, ... of each tap's sum
// over cout; the KS groups' tiles are summed in a fixed pairwise tree.
template <int TN>
__global__ void __launch_bounds__(kMaxThreads, 2)
conv3x3_dgrad_band_kernel(const float* __restrict__ dy,
                          const float* __restrict__ w,
                          float* __restrict__ dx, DgradGeom g) {
  extern __shared__ __align__(16) float smem[];
  float* band = smem;
  float* ring = smem + g.band_floats;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int t = blockIdx.z;
  const int img = blockIdx.x / g.nb;
  const int ih0 = (blockIdx.x - img * g.nb) * g.CR;
  const int rows = min(g.CR, g.H - ih0);
  const int npix = rows * g.W;
  const int Wb = g.W + 2;
  const float* dyt = dy + (size_t)t * g.N * g.Ho * g.Wo * g.cout;
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
  // the band: rows ih0 - org .. ih0 - org + rows + 1 of dy, columns -org ..
  // W + 1 - org, zero outside dy
  {
    const int pixels = (rows + 2) * Wb;
    const int per = g.vec_dy ? g.cout >> 2 : g.coutp;
    for (int e = tid; e < pixels * per; e += nthreads) {
      const int pix = e / per;
      const int c = e - pix * per;
      const int r = pix / Wb;
      const int oh = ih0 - g.org + r;
      const int ow = pix - r * Wb - g.org;
      float* dst = band + pix * g.CP;
      if (oh < 0 || oh >= g.Ho || ow < 0 || ow >= g.Wo) {
        if (g.vec_dy)
          reinterpret_cast<float4*>(dst)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        else
          dst[c] = 0.f;
        continue;
      }
      const float* src =
          dyt + (((size_t)img * g.Ho + oh) * g.Wo + ow) * g.cout;
      if (g.vec_dy)
        cp_async16(dst + 4 * c, src + 4 * c);
      else if (c < g.cout)
        cp_async4(dst + c, src + c);
      else
        dst[c] = 0.f;
    }
  }
  // a thread's copies of a tap's weights: chunks (16 or 4 bytes) tid,
  // tid + nthreads, ... of the cin x cout slab, walked without a division
  const int wrow = g.vec_w ? g.cout >> 2 : g.cout;  // chunks a weight row
  const int ci0 = tid / wrow;
  const int wc0 = tid - ci0 * wrow;
  const int dci = nthreads / wrow;
  const int dwc = nthreads - dci * wrow;
  auto load_tap = [&](int tap, int s) {
    // tap (kh', kw') of the transposed conv reads w[2 - kh'][2 - kw']
    const float* src = wt + (size_t)(8 - tap) * g.cin * g.cout;
    float* dst = ring + s * g.slot_floats;
    int ci = ci0, c = wc0;
    for (int e = tid; e < g.cin * wrow; e += nthreads) {
      if (g.vec_w)
        cp_async16(dst + ci * g.CP + 4 * c, src + 4 * (size_t)e);
      else
        cp_async4(dst + ci * g.CP + c, src + e);
      ci += dci;
      c += dwc;
      if (c >= wrow) c -= wrow, ++ci;
    }
    cp_async_commit();
  };
  load_tap(0, 0);  // one group with the band's copies

  const int PC = g.PG * g.CG;
  const int ks = tid / PC;
  const int lt = tid - ks * PC;
  const int cg = lt % g.CG;
  const int pg = lt / g.CG;
  int boff[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    int m = pg + g.PG * i;
    if (m >= npix) m = 0;  // a row past the band: computed, not stored
    const int r = m / g.W;
    boff[i] = (r * Wb + (m - r * g.W)) * g.CP;
  }
  float acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const int wstep = g.CG * g.CP;

  for (int tap = 0; tap < 9; ++tap) {
    if (tap + 1 < 9) {
      load_tap(tap + 1, (tap + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int kh = tap / 3;
    const float* bt = band + (kh * Wb + (tap - 3 * kh)) * g.CP;
    const float* ws = ring + (tap & 1) * g.slot_floats + cg * g.CP;
#pragma unroll 1
    for (int co = 4 * ks; co < g.coutp; co += 4 * g.KS) {
      float4 bv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        bv[j] = *reinterpret_cast<const float4*>(ws + j * wstep + co);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(bt + boff[i] + co);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(av.x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av.y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(av.z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(av.w, bv[j].w, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
  for (int cur = g.KS; cur > 1;) {
    const int half = (cur + 1) >> 1;
    if (ks >= half && ks < cur) {
      float* buf = smem + (size_t)(ks - half) * kTM * TN * PC + lt;
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) buf[(i * TN + j) * PC] = acc[i][j];
    }
    __syncthreads();
    if (ks < cur - half) {
      const float* buf = smem + (size_t)ks * kTM * TN * PC + lt;
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += buf[(i * TN + j) * PC];
    }
    __syncthreads();
    cur = half;
  }
  if (ks != 0) return;

  float* dxt = dx + ((size_t)t * g.N * g.H + (size_t)img * g.H + ih0) *
                        g.W * g.cin;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = pg + g.PG * i;
    if (m >= npix) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int ci = cg + g.CG * j;
      if (ci < g.cin) dxt[(size_t)m * g.cin + ci] = acc[i][j];
    }
  }
}

template <int TN>
cudaError_t launch_dgrad(const float* dy, const float* w, float* dx,
                         const DgradGeom& g, dim3 grid, int threads, int smem,
                         cudaStream_t st) {
  static bool done[64] = {};
  cudaError_t err = allow_smem(conv3x3_dgrad_band_kernel<TN>, done);
  if (err != cudaSuccess) return err;
  conv3x3_dgrad_band_kernel<TN><<<grid, threads, smem, st>>>(dy, w, dx, g);
  return cudaGetLastError();
}

}  // namespace maml

extern "C" {

// dw (T, 3, 3, cin, cout) and db (T, cout) of the stride-1 conv at `pad` (1
// or 0) from x (T, N, H, W, cin) and dy (T, N, Ho, Wo, cout), Ho = H + 2*pad
// - 2 (Wo likewise); part_w (T, S, 9*cin*cout) and part_b (T, S, cout) are
// scratch. The arguments come packed (wgrad_reduce.cuh: WgradCall); the
// launch plan (kernels/conv_block.py::wgrad_plan, kernel "band"): `splits`,
// `band_rows`, `kernel_rows` (3 or 1), `groups` (8-channel groups a block),
// `replicas`; `threads` and `smem` are the plan's, checked here against the
// geometry they follow from. Two launches on the stream.
int conv3x3_wgrad_band(const long long* a) {
  return maml::run_wgrad_band<maml::S1Band>(a, 1);
}

// dx (T, N, H, W, cin) = dgrad of the stride-1 conv at `pad` (1 or 0) with
// weights w (T, 3, 3, cin, cout), from dy (T, N, Ho, Wo, cout). The launch
// plan (kernels/conv_block.py::dgrad_plan): `band_rows`, `splits` of the
// sum over cout; `threads` and `smem` are the plan's, checked here. One
// launch on `stream`.
int conv3x3_dgrad_band(const float* dy, const float* w, float* dx, int T,
                       int N, int H, int W, int pad, int cin, int cout,
                       int band_rows, int splits, int threads, int smem,
                       void* stream) {
  using namespace maml;
  if (pad != 0 && pad != 1) return (int)cudaErrorInvalidValue;
  DgradGeom g;
  g.N = N, g.H = H, g.W = W, g.cin = cin, g.cout = cout, g.org = 2 - pad;
  g.Ho = H + 2 * pad - 2;
  g.Wo = W + 2 * pad - 2;
  if (T < 1 || N < 1 || g.Ho < 1 || g.Wo < 1 || cin < 1 || cout < 1 ||
      band_rows < 1 || band_rows > H || T > 65535 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int TN = cin <= 4 ? 4 : 8;
  g.CR = band_rows;
  g.nb = cdiv(H, band_rows);
  g.coutp = round4(cout);
  g.CP = g.coutp + ((g.coutp / 4) % 2 == 0 ? 4 : 0);
  g.CG = cdiv(cin, TN);
  g.PG = cdiv(band_rows * W, kTM);
  g.KS = splits;
  g.band_floats = (band_rows + 2) * (W + 2) * g.CP;
  g.slot_floats = g.CG * TN * g.CP;
  const int stage = g.band_floats + 2 * g.slot_floats;
  const int tree = (splits / 2) * kTM * TN * g.PG * g.CG;
  const int want_smem = (stage > tree ? stage : tree) * 4;
  if (threads != splits * g.PG * g.CG || threads > kMaxThreads ||
      splits > g.coutp / 4 || smem != want_smem ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  g.vec_dy = cout % 4 == 0 && aligned16(dy);
  g.vec_w = cout % 4 == 0 && aligned16(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N * g.nb, 1, T);
  cudaError_t err =
      TN == 4 ? launch_dgrad<4>(dy, w, dx, g, grid, threads, smem, st)
              : launch_dgrad<8>(dy, w, dx, g, grid, threads, smem, st);
  return (int)err;
}

}  // extern "C"
