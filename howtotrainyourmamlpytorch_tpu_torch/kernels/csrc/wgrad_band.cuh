// The f32 wgrad band kernel at stride S (1: conv3x3_bwd_s1.cu, 2:
// conv3x3_wgrad_s2.cu, each a __global__ of its own name around the body
// here), its geometry and its two launches. dW[t] = patches(x[t])^T dy[t]
// and db[t] = sum dy[t] on FFMA, no TF32, no atomics.
// * A block owns one (tenant, split of bands), a slice of kernel rows (all
//   three at cin <= 4, one above) and whole channel rows (up to 224 FFMA
//   threads' worth of 8-channel groups): its K tile follows the data, one
//   kernel row is 3 cin contiguous floats of a source row (the three taps
//   at output column ow read from source column S ow - pad), so no zero
//   rows are padded up to a fixed tile.
// * The split's pixels come in bands of CR output rows of one image. A
//   band's source rows (all three kernel rows: S (CR - 1) + 3 rows from S
//   oh0 - pad; one kernel row kh: the CR rows S (oh0 + r) - pad + kh its
//   outputs read), zero where the image ends, and its dy rows go into
//   shared memory once, by 16-byte cp.async (4-byte where a row is not
//   16-byte aligned), into a ring of two stages: the next band's loads are
//   in flight while this band's FFMAs run. Only the source pixel stride
//   (S cin floats) and the staged row step depend on the stride.
// * Each thread holds TK x 8 accumulators: a run of TK = 8 (or 9 at cin <=
//   3: a whole kernel row) consecutive k of one kernel row, times 8
//   channels; 64 or 72 FFMAs per 16 or 17 floats read from shared memory.
//   A warp of its own sums db, so no FFMA thread holds the bias.
// * At small channel counts a block holds R replicas of the output tile,
//   each summing every R-th pixel of the band; the replicas are summed in
//   a fixed pairwise tree through shared memory at the end.
// * 8 warps a block, two blocks a SM (128 registers a thread: the
//   accumulators spill a little, and one block of 255 registers ran
//   slower); the split count gives the card two blocks a SM, one wave; a
//   second launch sums the T * S partials in split order.
// Each output's sum runs over its split's pixels in band order in one
// thread, then the replicas' tree, then the splits in order: a second
// launch gives the first launch's bits. The launch plan is a pure function
// of the shape (kernels/conv_block.py::wgrad_plan, kernels "band" and
// "s2"); wgrad_band_geom checks the plan's threads and shared memory
// against the geometry here.
#pragma once

#include <cuda_runtime.h>

#include "band_common.cuh"
#include "wgrad_reduce.cuh"

namespace maml {

constexpr int kTN = 8;  // channels a thread

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
  int RS;   // x floats a staged row
  int RSO;  // floats from one output row's staged x to the next's: S RS
            // (all three kernel rows staged) or RS (one)
  int off;  // where a row's data starts (16-byte aligned copies)
  int xs_floats, ds_floats;  // a ring stage's x and dy regions
  int bias_at;               // db's running sums: past the ring and tree
  int vec_x, vec_dy;         // 16-byte copies of x rows, of dy pixels
};

// Block (split, kernel-row slice * tiles + channel tile, tenant). The first
// R * TPR threads compute: thread (replica rep, k run kg, channel group ng)
// sums dW rows of kernel row kh0 + kg / KGR, k = (kg % KGR) * TK .. + TK -
// 1 within it, channels n0 .. n0 + 7, over every R-th pixel of each band.
// The last warp sums db over the bands (in the first slice and channel
// tile only).
template <int S, int TK, bool kVecA>
__device__ __forceinline__ void wgrad_band_body(
    const float* __restrict__ x, const float* __restrict__ dy,
    float* __restrict__ part_w, float* __restrict__ part_b,
    const WgradGeom& g) {
  extern __shared__ __align__(16) float fsmem[];
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
  float* bsum = fsmem + g.bias_at;

  // both slots start zero: the halo columns, and what a run reads past a
  // row's last tap, stay finite
  for (int e = tid; e < 2 * slot_floats / 4; e += nthreads)
    reinterpret_cast<float4*>(fsmem)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int e = tid; e < g.NP; e += nthreads) bsum[e] = 0.f;
  __syncthreads();

  auto load_band = [&](int b, int stage) {
    float* xs = fsmem + stage * slot_floats;
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
    // x: all three kernel rows, the S (rows - 1) + 3 source rows from S oh0
    // - pad; one, the source row S (oh0 + r) - pad + kh0 of each output row
    // r. Each at column pad of its staged row.
    const int xrows = g.KH == 3 ? S * (rows - 1) + 3 : rows;
    const int rstep = g.KH == 3 ? 1 : S;
    const int ih0 = S * oh0 - g.pad + kh0;
    const int per = g.vec_x ? rowlen >> 2 : rowlen;
    for (int e = tid; e < xrows * per; e += nthreads) {
      const int r = e / per;
      const int c = e - r * per;
      const int ih = ih0 + rstep * r;
      float* dst = xs + g.off + g.pad * g.cin + r * g.RS;
      const float* row = xt + ((size_t)img * g.H + ih) * rowlen;
      if (ih < 0 || ih >= g.H) {
        if (g.vec_x)
          reinterpret_cast<float4*>(dst)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
        else
          dst[c] = 0.f;
      } else if (g.vec_x) {
        cp_async16(dst + 4 * c, row + 4 * c);
      } else {
        cp_async4(dst + c, row + c);
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
  // step to its next: R pixels on, Rr rows and Rc columns (one wrap at
  // most); a pixel is S cin floats of a staged row
  int r0 = 0, c0 = rep;
  while (c0 >= g.Wo) c0 -= g.Wo, ++r0;
  const int Rr = g.R / g.Wo;
  const int Rc = g.R - Rr * g.Wo;
  const int px = S * g.cin;
  const int astep = Rr * g.RSO + Rc * px;
  const int awrap = g.RSO - g.Wo * px;
  const int a0 = khl * g.RS + g.off + j0 + r0 * g.RSO + c0 * px;
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
    const float* xs = fsmem + stage * slot_floats;
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
        const float dv[kTN] = {dA.x, dA.y, dA.z, dA.w,
                                 dB.x, dB.y, dB.z, dB.w};
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
  constexpr int kQ = TK * kTN;
  for (int cur = g.R; cur > 1;) {
    const int half = (cur + 1) >> 1;
    if (ffma && rep >= half && rep < cur) {
      float* buf = fsmem + (size_t)(rep - half) * kQ * TPR + lt;
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          buf[(i * kTN + j) * TPR] = acc[i][j];
    }
    __syncthreads();
    if (ffma && rep < cur - half) {
      const float* buf = fsmem + (size_t)rep * kQ * TPR + lt;
#pragma unroll
      for (int i = 0; i < TK; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          acc[i][j] += buf[(i * kTN + j) * TPR];
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

// The conv's output size at stride S and pad, 0 where it has none.
inline int conv_out(int n, int pad, int S) {
  return n + 2 * pad < 3 ? 0 : (n + 2 * pad - 3) / S + 1;
}

// The geometry of the plan (kernels/conv_block.py::wgrad_plan, kernel
// "band" at stride 1, "s2" at stride 2) at this shape; false where the
// shape or the plan's `splits`, `band_rows`, `kernel_rows`, `groups`,
// `replicas`, `threads` and `smem` do not match it.
inline bool wgrad_band_geom(WgradGeom& g, const WgradCall& c, int S) {
  if ((c.pad != 0 && c.pad != 1) || c.T < 1 || c.T > 65535 || c.N < 1 ||
      c.H < 1 || c.W < 1 || c.cin < 1 || c.cout < 1 ||
      (c.kernel_rows != 1 && c.kernel_rows != 3) || c.band_rows < 1 ||
      c.groups < 1 || c.replicas < 1 || c.splits < 1)
    return false;
  g.N = c.N, g.H = c.H, g.W = c.W, g.cin = c.cin, g.cout = c.cout;
  g.pad = c.pad;
  g.Ho = conv_out(c.H, c.pad, S);
  g.Wo = conv_out(c.W, c.pad, S);
  if (g.Ho < 1 || g.Wo < 1 || c.band_rows > g.Ho) return false;
  const int TK = c.cin <= 3 ? 9 : 8;
  g.CR = c.band_rows;
  g.nb = cdiv(g.Ho, c.band_rows);
  g.S = c.splits;
  g.KH = c.kernel_rows;
  g.ks = 3 / c.kernel_rows;
  g.L = 3 * c.cin;
  g.KGR = cdiv(g.L, TK);
  const int NG = cdiv(c.cout, kTN);
  g.NGB = c.groups;
  g.R = c.replicas;
  g.NP = kTN * NG;
  g.off = (4 - (c.pad * c.cin) % 4) % 4;
  // a staged row holds the image row at column pad and the columns the
  // last output's taps read (S (Wo - 1) + 3 from the halo's first)
  const int cols = max(c.W + c.pad, S * (g.Wo - 1) + 3);
  g.RS = round4(g.off + cols * c.cin);
  const int xrows = g.KH == 3 ? S * (g.CR - 1) + 3 : g.CR;
  g.RSO = g.KH == 3 ? S * g.RS : g.RS;
  g.xs_floats = round4(xrows * g.RS + TK);
  g.ds_floats = g.CR * g.Wo * g.NP;
  const int TPR = g.KH * g.KGR * g.NGB;
  const int ring = 2 * (g.xs_floats + g.ds_floats);
  const int tree = (c.replicas / 2) * TK * kTN * TPR;
  g.bias_at = ring > tree ? ring : tree;
  return c.splits <= c.N * g.nb && c.groups <= NG &&
         c.threads == (c.replicas * TPR + 31) / 32 * 32 + 32 &&
         c.threads <= kMaxThreads && c.smem == (g.bias_at + g.NP) * 4 &&
         c.smem <= kMaxSmem &&
         (long long)c.N * c.H * c.W * c.cin < (1ll << 31) &&
         (long long)c.N * g.Ho * g.Wo * c.cout < (1ll << 31);
}

// One launch of KS::kernel<TK, kVecA> (KS names a source's __global__
// around wgrad_band_body) on the call's stream.
template <typename KS, int TK, bool kVecA>
cudaError_t launch_wgrad_band(const WgradCall& c, const WgradGeom& g,
                              dim3 grid) {
  static bool done[64] = {};
  const auto kernel = KS::template kernel<TK, kVecA>();
  cudaError_t err = allow_smem(kernel, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid, c.threads, c.smem, c.stream>>>(
      static_cast<const float*>(c.x), static_cast<const float*>(c.dy),
      c.part_w, c.part_b, g);
  return cudaGetLastError();
}

// An entry's whole call at stride S: the plan checked, the device made
// current, the band kernel (TK and the vector reads by cin) and the
// reduce; returns the first CUDA error, 0 on success, and launches
// nothing where the plan does not match the shape.
template <typename KS>
int run_wgrad_band(const long long* a, int S) {
  const WgradCall c = unpack_wgrad(a);
  WgradGeom g;
  if (!wgrad_band_geom(g, c, S)) return (int)cudaErrorInvalidValue;
  const WgradDevice on(c.device);
  if (on.err != cudaSuccess) return (int)on.err;
  g.vec_x = (c.W * c.cin) % 4 == 0 && aligned16(c.x);
  g.vec_dy = c.cout % 4 == 0 && aligned16(c.dy);
  const dim3 grid(c.splits, g.ks * cdiv(cdiv(c.cout, kTN), c.groups), c.T);
  cudaError_t err;
  if (c.cin <= 3)
    err = launch_wgrad_band<KS, 9, false>(c, g, grid);
  else if (c.cin % 4 == 0)
    err = launch_wgrad_band<KS, 8, true>(c, g, grid);
  else
    err = launch_wgrad_band<KS, 8, false>(c, g, grid);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wgrad_reduce<float>(
      c.part_w, c.part_b, static_cast<float*>(c.dw),
      static_cast<float*>(c.db), c.T, c.splits, 9 * c.cin * c.cout, c.cout,
      c.stream);
}

}  // namespace maml
