// K4 at stride 1 in f32: the dgrad and the wgrad of the 3x3 conv (pad 1 or
// 0), on band tiles staged once in shared memory.
//
// Replaces (JAX package) the gradient XLA derives for
// howtotrainyourmamlpytorch_tpu/ops/functional.py::_conv2d_raw :199 in the
// inner-loop support gradient (core/maml.py::_task_learner :177-189) and in
// the outer backward: the transposed GEMMs of the `gemm`/`im2col` lowering.
// bf16 at stride 1 runs conv3x3_s1_bf16.cu (dgrad) and
// conv3x3_wgrad_s1_bf16.cu (wgrad); at stride 2 dgrad runs conv3x3_s2.cu,
// wgrad conv3x3_bwd.cu's tile.
//
// f32 FFMA only (no TF32, no tensor cores: the JAX package multiplies f32 in
// true f32). No atomics: every sum is taken in a fixed order, so two
// launches on the same inputs give the same bits. The launch plans are
// pure functions of the shape (kernels/conv_block.py::wgrad_plan,
// dgrad_plan); the entry points check the plan's threads and shared memory
// against the geometry here.
//
// * conv3x3_wgrad_band: dW[t] = patches(x[t])^T dy[t], db[t] = sum dy[t].
//   The reduction runs over the M = N*Ho*Wo output pixels (176,400 a
//   tenant at mini-ImageNet stage 0), the output is small (27 x 48 at
//   stage 0, 432 x 48 at stage 1). Bound by bytes at cin <= 4 (dy alone is
//   271 MB at T = 8, N = 25, stage 0) and by FLOPs above.
//   - A block owns one (tenant, pixel split), a slice of kernel rows (all
//     three at cin <= 4, one above) and whole channel rows (up to 224
//     FFMA threads' worth of 8-channel groups; every main-path cout is one
//     tile): its K tile follows the data, one kernel row is 3*cin
//     contiguous floats of x, so no zero rows are padded up to a fixed
//     tile.
//   - The split's pixels come in bands of CR output rows of one image. A
//     band's x rows (with the kernel-row halo, zero where the image ends)
//     and its dy rows go into shared memory once, by 16-byte cp.async
//     (4-byte where a row is not 16-byte aligned), into a ring of two
//     stages: the next band's loads are in flight while this band's FFMAs
//     run. The 9 taps read x from shared memory, and dy rows are loaded
//     whole (192 or 256 B a pixel), each once per block.
//   - Each thread holds TK x 8 accumulators: a run of TK = 8 (or 9 at cin
//     <= 3: a whole kernel row) consecutive k of one kernel row, times 8
//     channels; 64 or 72 FFMAs per 16 or 17 floats read from shared memory
//     (two or zero float4 x reads, two float4 dy reads). A warp of its own
//     sums db, so no FFMA thread holds the bias.
//   - At small channel counts a block holds R replicas of the output tile,
//     each summing every R-th pixel of the band; the replicas are summed in
//     a fixed pairwise tree through shared memory at the end.
//   - 8 warps a block, two blocks a SM (128 registers a thread: the
//     accumulators spill a little, and one block of 255 registers ran
//     slower); the split count gives the card two blocks a SM, one wave;
//     a second launch sums the T*S partials in split order.
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
//   FFMA, the order of the tile kernel it replaces (conv3x3_tile.cuh).
//
// Both kernels' 8 x 8 tiles read 16 floats from shared memory per 64
// FFMAs, which is the SM's shared-memory rate against its FFMA rate: the
// two pipes bound them together, near half the FFMA peak at the 48- and
// 64-channel maps.

#include <cuda_runtime.h>

#include "band_common.cuh"
#include "wgrad_reduce.cuh"

namespace maml {

constexpr int kTN = 8;            // wgrad: channels per thread
constexpr int kTM = 8;            // dgrad: pixels per thread

// --- wgrad ------------------------------------------------------------------

struct WgradGeom {
  int N, H, W, Ho, Wo, cin, cout, pad;
  int S;    // pixel splits per tenant (gridDim.x)
  int CR;   // output rows per band
  int nb;   // bands per image
  int KH;   // kernel rows per block: 3, or 1 (gridDim.y = 3 / KH * tiles)
  int ks;   // kernel-row slices = 3 / KH
  int NGB;  // 8-channel groups per block
  int R;    // replicas of the output tile
  int L;    // 3 * cin: the k of one kernel row
  int KGR;  // k runs per kernel row
  int NP;   // dy floats a pixel in shared memory (8 * channel groups)
  int RS;   // x floats a row in shared memory
  int off;  // where a row's data starts (16-byte aligned copies)
  int xs_floats, ds_floats;  // a ring stage's x and dy regions
  int bias_at;               // db's running sums: past the ring and tree
  int vec_x, vec_dy;         // 16-byte copies of x rows, of dy pixels
};

template <int TK>
struct WgradTile {
  static constexpr int kQ = TK * kTN;  // accumulators a thread
};

// Block (split, kernel-row slice * tiles + channel tile, tenant). The first
// R * TPR threads compute: thread (replica rep, k run kg, channel group ng)
// sums dW rows of kernel row kh0 + kg / KGR, k = (kg % KGR) * TK .. + TK -
// 1 within it, channels n0 .. n0 + 7, over every R-th pixel of each band.
// A warp of its own, the last, sums db over the bands (in the first slice
// and channel tile only), so that no FFMA thread carries the bias.
template <int TK, bool kVecA>
__global__ void __launch_bounds__(kMaxThreads, 2)
conv3x3_wgrad_band_kernel(const float* __restrict__ x,
                          const float* __restrict__ dy,
                          float* __restrict__ part_w,
                          float* __restrict__ part_b, WgradGeom g) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kQ = WgradTile<TK>::kQ;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int split = blockIdx.x;
  const int slice = blockIdx.y % g.ks;
  const int kh0 = slice * g.KH;
  const int t = blockIdx.z;
  const int TPR = g.KH * g.KGR * g.NGB;
  const int rep = tid / TPR;
  const int lt = tid - rep * TPR;
  const bool ffma = rep < g.R;
  const bool bias = blockIdx.y == 0 && tid >= nthreads - 32;
  const int kg = lt / g.NGB;
  const int ngl = lt - kg * g.NGB;
  const int khl = kg / g.KGR;
  const int j0 = (kg - khl * g.KGR) * TK;
  const int n0 = (blockIdx.y / g.ks * g.NGB + ngl) * kTN;

  const int bands = g.N * g.nb;
  const int b_begin = (int)((long long)bands * split / g.S);
  const int b_end = (int)((long long)bands * (split + 1) / g.S);
  const int rowlen = g.W * g.cin;
  const float* xt = x + (size_t)t * g.N * g.H * rowlen;
  const float* dyt = dy + (size_t)t * g.N * g.Ho * g.Wo * g.cout;
  const int slot_floats = g.xs_floats + g.ds_floats;
  float* bsum = smem + g.bias_at;  // db of the split, by the bias warp

  // the x regions of both stages start zero: the halo columns stay so
  for (int e = tid; e < 2 * slot_floats / 4; e += nthreads)
    reinterpret_cast<float4*>(smem)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = tid; e < g.NP; e += nthreads) bsum[e] = 0.f;
  __syncthreads();

  auto load_band = [&](int b, int stage) {
    float* xs = smem + stage * slot_floats;
    float* ds = xs + g.xs_floats;
    const int img = b / g.nb;
    const int oh0 = (b - img * g.nb) * g.CR;
    const int rows = min(g.CR, g.Ho - oh0);
    const int npix = rows * g.Wo;
    const float* src = dyt + ((size_t)img * g.Ho + oh0) * g.Wo * g.cout;
    if (g.vec_dy && g.NP == g.cout) {  // the band's rows lie as in dy
      for (int e = tid; e < npix * g.cout / 4; e += nthreads)
        cp_async16(ds + 4 * e, src + 4 * (size_t)e);
    } else if (g.vec_dy) {
      const int c4n = g.cout >> 2;
      for (int e = tid; e < npix * c4n; e += nthreads) {
        const int p = e / c4n;
        cp_async16(ds + p * g.NP + 4 * (e - p * c4n), src + 4 * (size_t)e);
      }
    } else {
      for (int e = tid; e < npix * g.cout; e += nthreads) {
        const int p = e / g.cout;
        cp_async4(ds + p * g.NP + (e - p * g.cout), src + e);
      }
    }
    // x rows oh0 - pad + kh0 .. + rows + KH - 2, each at column pad
    const int xrows = rows + g.KH - 1;
    const int ih0 = oh0 - g.pad + kh0;
    const int per = g.vec_x ? rowlen >> 2 : rowlen;
    for (int r = 0; r < xrows; ++r) {
      const int ih = ih0 + r;
      float* dst = xs + g.off + g.pad * g.cin + r * g.RS;
      const float* row = xt + ((size_t)img * g.H + ih) * rowlen;
      const bool inside = ih >= 0 && ih < g.H;
      for (int c = tid; c < per; c += nthreads) {
        if (!inside) {
          if (g.vec_x)
            reinterpret_cast<float4*>(dst)[c] =
                make_float4(0.f, 0.f, 0.f, 0.f);
          else
            dst[c] = 0.f;
        } else if (g.vec_x) {
          cp_async16(dst + 4 * c, row + 4 * c);
        } else {
          cp_async4(dst + c, row + c);
        }
      }
    }
    cp_async_commit();
  };

  float acc[TK][kTN];
#pragma unroll
  for (int i = 0; i < TK; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  // a replica's first pixel of a band (band row r0, column c0) and the
  // step to its next: R pixels on, Rr rows and Rc columns (one wrap at most)
  int r0 = 0, c0 = rep;
  while (c0 >= g.Wo) c0 -= g.Wo, ++r0;
  const int Rr = g.R / g.Wo;
  const int Rc = g.R - Rr * g.Wo;
  const int astep = Rr * g.RS + Rc * g.cin;
  const int awrap = g.RS - g.Wo * g.cin;
  const int a0 = khl * g.RS + g.off + j0 + r0 * g.RS + c0 * g.cin;
  const int d0 = rep * g.NP + n0;
  const int dstep = g.R * g.NP;

  load_band(b_begin, 0);
  for (int b = b_begin; b < b_end; ++b) {
    const int stage = (b - b_begin) & 1;
    if (b + 1 < b_end) {
      load_band(b + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xs = smem + stage * slot_floats;
    const float* ds = xs + g.xs_floats;
    const int img = b / g.nb;
    const int npix = min(g.CR, g.Ho - (b - img * g.nb) * g.CR) * g.Wo;
    if (ffma) {
      const float* a = xs + a0;
      const float* d = ds + d0;
      int c = c0;
      for (int p = rep; p < npix; p += g.R) {
        float av[TK];
        if (kVecA) {
#pragma unroll
          for (int q = 0; q < TK / 4; ++q) {
            const float4 v = reinterpret_cast<const float4*>(a)[q];
            av[4 * q] = v.x;
            av[4 * q + 1] = v.y;
            av[4 * q + 2] = v.z;
            av[4 * q + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < TK; ++i) av[i] = a[i];
        }
        const float4 dA = reinterpret_cast<const float4*>(d)[0];
        const float4 dB = reinterpret_cast<const float4*>(d)[1];
        const float dv[kTN] = {dA.x, dA.y, dA.z, dA.w, dB.x, dB.y, dB.z, dB.w};
#pragma unroll
        for (int i = 0; i < TK; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            acc[i][j] = fmaf(av[i], dv[j], acc[i][j]);
        a += astep;
        d += dstep;
        c += Rc;
        if (c >= g.Wo) {
          c -= g.Wo;
          a += awrap;
        }
      }
    } else if (bias) {
      for (int n = tid - (nthreads - 32); n < g.NP; n += 32) {
        float s = 0.f;
        for (int p = 0; p < npix; ++p) s += ds[p * g.NP + n];
        bsum[n] += s;
      }
    }
    __syncthreads();
  }

  // the replicas' sums, pairwise in a fixed tree through the ring's
  // memory: at each round replica r of the upper half hands its tile to
  // replica r - half
  for (int cur = g.R; cur > 1;) {
    const int half = (cur + 1) >> 1;
    if (ffma && rep >= half && rep < cur) {
      float* buf = smem + (size_t)(rep - half) * kQ * TPR + lt;
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) buf[(i * kTN + j) * TPR] = acc[i][j];
    }
    __syncthreads();
    if (ffma && rep < cur - half) {
      const float* buf = smem + (size_t)rep * kQ * TPR + lt;
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] += buf[(i * kTN + j) * TPR];
    }
    __syncthreads();
    cur = half;
  }
  if (bias) {
    float* pb = part_b + ((size_t)t * g.S + split) * g.cout;
    for (int n = tid - (nthreads - 32); n < g.cout; n += 32) pb[n] = bsum[n];
  }
  if (!ffma || rep != 0) return;
  const int KC = 9 * g.cin * g.cout;
  float* pw = part_w + ((size_t)t * g.S + split) * KC;
  const int kh = kh0 + khl;
#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const int j = j0 + i;
    if (j < g.L) {
      float* row = pw + (size_t)(kh * g.L + j) * g.cout;
#pragma unroll
      for (int jj = 0; jj < kTN; ++jj)
        if (n0 + jj < g.cout) row[n0 + jj] = acc[i][jj];
    }
  }
}

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

template <int TK, bool kVecA>
cudaError_t launch_wgrad(const float* x, const float* dy, float* part_w,
                         float* part_b, const WgradGeom& g, dim3 grid,
                         int threads, int smem, cudaStream_t st) {
  static bool done[64] = {};
  cudaError_t err = allow_smem(conv3x3_wgrad_band_kernel<TK, kVecA>, done);
  if (err != cudaSuccess) return err;
  conv3x3_wgrad_band_kernel<TK, kVecA>
      <<<grid, threads, smem, st>>>(x, dy, part_w, part_b, g);
  return cudaGetLastError();
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
// scratch. The launch plan (kernels/conv_block.py::wgrad_plan): `splits`,
// `band_rows`, `kernel_rows` (3 or 1), `groups` (8-channel groups a block),
// `replicas`; `threads` and `smem` are the plan's, checked here against the
// geometry they follow from. Two launches on `stream`.
int conv3x3_wgrad_band(const float* x, const float* dy, float* part_w,
                       float* part_b, float* dw, float* db, int T, int N,
                       int H, int W, int pad, int cin, int cout, int splits,
                       int band_rows, int kernel_rows, int groups,
                       int replicas, int threads, int smem, void* stream) {
  using namespace maml;
  if (pad != 0 && pad != 1) return (int)cudaErrorInvalidValue;
  WgradGeom g;
  g.N = N, g.H = H, g.W = W, g.cin = cin, g.cout = cout, g.pad = pad;
  g.Ho = H + 2 * pad - 2;
  g.Wo = W + 2 * pad - 2;
  if (T < 1 || N < 1 || g.Ho < 1 || g.Wo < 1 || cin < 1 || cout < 1 ||
      (kernel_rows != 1 && kernel_rows != 3) || band_rows < 1 ||
      band_rows > g.Ho || groups < 1 || replicas < 1 || T > 65535)
    return (int)cudaErrorInvalidValue;
  const int TK = cin <= 3 ? 9 : 8;
  g.CR = band_rows;
  g.nb = cdiv(g.Ho, band_rows);
  g.S = splits;
  g.KH = kernel_rows;
  g.ks = 3 / kernel_rows;
  g.L = 3 * cin;
  g.KGR = cdiv(g.L, TK);
  const int NG = cdiv(cout, kTN);
  g.NGB = groups;
  g.R = replicas;
  g.NP = kTN * NG;
  g.off = (4 - (pad * cin) % 4) % 4;
  g.RS = round4(g.off + (g.Wo + 2) * cin);
  g.xs_floats = round4((band_rows + kernel_rows - 1) * g.RS + TK);
  g.ds_floats = band_rows * g.Wo * g.NP;
  const int TPR = g.KH * g.KGR * g.NGB;
  const int ring = 2 * (g.xs_floats + g.ds_floats);
  const int tree = (replicas / 2) * TK * kTN * TPR;
  g.bias_at = ring > tree ? ring : tree;
  const int want_smem = (g.bias_at + g.NP) * 4;
  if (splits < 1 || splits > N * g.nb || groups > NG ||
      threads != (replicas * TPR + 31) / 32 * 32 + 32 ||
      threads > kMaxThreads ||
      smem != want_smem || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  g.vec_x = (W * cin) % 4 == 0 && aligned16(x);
  g.vec_dy = cout % 4 == 0 && aligned16(dy);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(splits, g.ks * cdiv(NG, groups), T);
  cudaError_t err;
  if (TK == 9)
    err = launch_wgrad<9, false>(x, dy, part_w, part_b, g, grid, threads,
                                 smem, st);
  else if (cin % 4 == 0)
    err = launch_wgrad<8, true>(x, dy, part_w, part_b, g, grid, threads,
                                smem, st);
  else
    err = launch_wgrad<8, false>(x, dy, part_w, part_b, g, grid, threads,
                                 smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wgrad_reduce<float>(part_w, part_b, dw, db, T, splits,
                                         9 * cin * cout, cout, st);
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
