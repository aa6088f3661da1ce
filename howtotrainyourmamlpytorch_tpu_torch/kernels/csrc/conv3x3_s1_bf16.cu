// K1 (with statistics and stats-free) and K4 dgrad in bf16 at stride 1, pad 1
// or 0: one implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16
// products, f32 sums), templated on its epilogue and on how it reads the
// weights.
//
// Replaces (JAX package) howtotrainyourmamlpytorch_tpu/ops/functional.py
// ::conv_bn_act :249 at compute_dtype='bfloat16' — its `_conv2d_raw` :199
// (`_im2col` :85 + one GEMM over the (kh, kw, cin) patch rows) and the
// statistics pass of `batch_norm` :368 — in the rows conv3x3_fwd_stats_bf16
// and conv3x3_p0_fwd_stats_bf16; `_conv2d_raw` in XLA's second derivative
// (conv3x3(ddx, w), and conv3x3(x, ddw) + ddb) in conv3x3_fwd_bf16 and
// conv3x3_p0_fwd_bf16; and the gradient XLA derives for `_conv2d_raw` with
// respect to x in conv3x3_dgrad_bf16 and conv3x3_p0_dgrad_bf16. These ran on
// an FFMA tile. The f32 convs stay on FFMA (conv3x3_fwd_s1.cu,
// conv3x3_bwd_s1.cu: the JAX package multiplies f32 in true f32); bf16
// wgrad at stride 1 runs conv3x3_wgrad_s1_bf16.cu (the same ldmatrix and
// mma.sync helpers, mma_common.cuh), K1 and dgrad at stride 2
// conv3x3_s2.cu (the same design on stride-2 bands), wgrad at stride 2
// conv3x3_wgrad_s2.cu.
//
// Bound on an H100 (989 TFLOP/s dense bf16; 3.35 TB/s): the bytes, at every
// main-path shape. At cin <= 3 (mini-ImageNet stage 0, Omniglot layer 1)
// the 48- or 64-channel output is 16-64x the input; at 48 channels a pixel
// does 2 * 9 * 48 * 48 = 41.5 kFLOP for 192 bytes moved, 216 FLOP/B, below
// the card's ~295 FLOP/B ridge. So the design stages each byte of x (or dy)
// once from memory, writes y once, and keeps the products on the tensor
// cores; mma.sync at about half the dense rate is near the byte time
// (wgmma, TMA and warp specialisation wait for a trace that shows the FLOPs
// binding).
//
// The GEMM: output pixels (M) x output channels (N), summed over K = 9 taps
// x source channels, with
//   forward  (kDgrad = false): source x (cin channels), output y (cout), the
//            taps' origin at -pad;
//   dgrad    (kDgrad = true):  source dy (cout_fwd), output dx (cin_fwd) at
//            pad 2 - pad (pad 0: dy 39 x 39 gives dx 41 x 41), tap (kh, kw)
//            read from w[2-kh][2-kw] with (ci, co) swapped.
// * A block owns up to 64 output channels (grid.y takes the chunks where
//   there are more) of one tenant (grid.z) and walks `per` consecutive bands
//   of CR output rows of that tenant's images (grid.x): the tenant's
//   weights load once into shared memory (41 KB at 48 channels, 74 KB at
//   64, in the padded rows below), then each band's input rows with their
//   halo (zero outside the image, none at pad 0), by 16-byte cp.async (8
//   bf16 at a time where cin % 8 != 0 or x is not 16-byte aligned). The
//   grid is as many blocks as the card holds at once (two a SM), so the
//   weights are read once a block, not once a band.
// * A band pixel's channels lie on a stride of round16(cin) + 8 bf16 (56 at
//   48, 72 at 64): ldmatrix's 8 row addresses (8 consecutive pixels) fall
//   in distinct 16-byte bank groups; the channels past cin are zero, so a
//   tap is round16(cin) / 16 k16 steps. Output pixel (r, c) of the band is
//   q = r * Wp + c on the Wp = Wo + 2 wide grid, and tap (kh, kw) reads band
//   pixel q + kh * Wp + kw: an A fragment is one ldmatrix.x4 at shifted row
//   addresses, and no patch matrix is built (columns Wo, Wo + 1 of each row
//   are computed and dropped).
// * Small cin (forward at cin <= 3: mini-ImageNet stage 0, Omniglot layer
//   1, Wgrad's backward at cin 3): the 9 * cin patch values of each pixel
//   are packed into K = 16 or 32 columns, zero-padded, in shared memory (a
//   patch matrix of the band, a thread a pixel), one tap of that K. Its
//   source rows come by 4-byte cp.async into one of two slots while the
//   band before computes (the y stores bind there, not the loads).
// * B: forward, the HWIO rows of each tap (k x n, n contiguous), read by
//   ldmatrix.trans; dgrad, w[2-kh][2-kw] read in place — with cout_fwd as K
//   and cin_fwd as N its rows are already n x k, k contiguous, so plain
//   ldmatrix reads them. No flipped or transposed copy is made. Rows of
//   round8(N) + 8 (forward) or round16(K) + 8 (dgrad) bf16 where that keeps
//   ldmatrix free of bank conflicts; columns past the channels are zero and
//   their outputs masked.
// * A warp takes 32 band pixels (two m16 tiles) x all of the block's
//   channels (NT n8 tiles, NT in {1, 2, 4, 6, 8}: 6 at 48 channels, 8 at
//   64): 2 x NT x 4 f32 accumulators a thread. A block is at most 8 warps
//   (256 threads) and takes at most ~113 KB of shared memory where a band
//   of one row allows, so two blocks fit a SM within 128 registers a
//   thread.
// * The products are bf16 x bf16, exact in f32, and every sum accumulates
//   in f32 in the tensor cores' order, tap by tap and k16 step by k16 step
//   (no TF32, no split-K, no atomics): a second launch gives the first
//   launch's bits. That order is not the FFMA tile's, so an output near a
//   rounding boundary may round to the other neighbour: within one bf16
//   ulp of the plain twin's (two for a y with a bias).
// * Epilogue, in the JAX package's cast points (as the tile rounded):
//   1. the f32 sum rounded once to bf16; with a bias, the bias add in f32 on
//      the rounded value, rounded again (two channels a conversion);
//   2. with statistics: per band and channel (count, mean, M2) of the
//      ROUNDED values in f32 over the band's valid pixels — per warp the
//      count, the sum and M2 about the warp's mean (a thread's pixels, then
//      a fixed xor shuffle tree over the warp's lanes of the channel), then
//      the band's mean from the warps' sums in warp order and its M2 from
//      the warps' M2 and their means' distances from it, in warp order —
//      into (T, N * bands, 3, cout) partials; the second launch
//      (bn_stats_merge.cuh, the same code as the tile's and the f32 band
//      kernels') merges them with Chan's formula into mean and var rounded
//      once to bf16 and rstd = the f32 rsqrt of the bf16 var + eps, rounded
//      once;
//   3. y (or dx) staged through shared memory and stored as 16-byte
//      vectors, a pixel's channels contiguous: whole 32-byte sectors.
// The launch plan is a pure function of the shape (kernels/conv_block.py
// ::fwd_plan and ::dgrad_plan, kernel "mma"); the entry points check its
// threads, shared memory and grid against the geometry here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "bn_stats_merge.cuh"
#include "mma_common.cuh"

namespace maml {

constexpr int kMmaThreads = 256;  // most threads a block: 8 warps
constexpr int kWarpPixels = 32;   // band pixels a warp: two m16 tiles

struct MmaGeom {
  int N;            // images a tenant
  int Hs, Ws, Cs;   // the source: x (forward) or dy (dgrad)
  int Ho, Wo, Co;   // the output: y or dx
  int org;          // the taps' origin: pad (forward), 2 - pad (dgrad)
  int Wp;           // Wo + 2: a band row's pixels
  int CR, nb;       // output rows a band, bands an image
  int warps;        // warps a block
  int packed;       // forward at cin <= 3: the patch rows packed in K
  int taps;         // 9, or 1 packed
  int KC;           // K of a tap: round16(Cs), or round16(9 Cs) packed
  int SA;           // bf16 a band (or patch) pixel in shared memory: KC + 8
  int NB;           // output channels a block: 8 NT
  int WS;           // bf16 a weight row (forward: k, NB wide; dgrad: n, KC)
  int OS;           // bf16 a staged output pixel
  int band_px;      // band pixels in shared memory
  int raw_elems;    // packed: the band's source rows, bf16 (even)
  // the regions: the patch matrix and staging (packed; else 0), the slots
  // (one band, or packed two bands' source rows: the next in flight while
  // this one computes), the weights, the statistics
  int a_bytes, slot_bytes, nslots, w_bytes, s_bytes;
  int per;          // bands a block
  int vec_x, vec_w, vec_y;
};

// The tenant's weights for the block's channels [n0, n0 + nvalid), once.
// Forward: taps slabs of KC rows k x NB columns n (row stride WS); tap
// slab `tap` row k is w[tap][k] (k < cin; packed: row k of the flattened
// (9 cin, cout) matrix, k < 9 cin). Dgrad: 9 slabs of NB rows n x KC
// columns k; slab `tap` row n is w[8 - tap][n0 + n][0 .. cout_fwd), read in
// place.
template <bool kDgrad>
__device__ __forceinline__ void stage_weights(bf16* sw, const bf16* wt,
                                              const MmaGeom& g, int n0,
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
             wt + ((size_t)(8 - tap) * g.Co + n0 + n) * g.Cs + 8 * u, valid,
             g.vec_w != 0);
    }
  }
}

// The source rows of the band at output row oh0 (`rows` rows) into a slot,
// in flight (cp.async) until the caller waits: the rows oh0 - org .. oh0 -
// org + CR + 1, columns -org .. Wp - 1 - org, each pixel's KC channels
// (zero past Cs, and outside the image or past the band's last row), then
// zeros to band_px pixels (the rows the last warp's taps read past the
// band). Packed: the rows ih_lo .. ih_hi - 1 inside the image as they lie
// in memory (Ws x Cs bf16 a row), by 4-byte cp.async where `vec_x` (x
// 4-byte aligned, Ws * Cs even), else an element at a time.
__device__ __forceinline__ void stage_band(bf16* slot, const bf16* src,
                                           const MmaGeom& g, int oh0,
                                           int rows) {
  const int tid = threadIdx.x;
  if (g.packed) {
    const int ih_lo = max(0, oh0 - g.org);
    const int ih_hi = min(g.Hs, oh0 - g.org + g.CR + 2);
    const int n = (ih_hi - ih_lo) * g.Ws * g.Cs;
    const bf16* from = src + (size_t)ih_lo * g.Ws * g.Cs;
    if (g.vec_x) {
      for (int e = tid; e < n / 2; e += blockDim.x)
        cp_async4(slot + 2 * e, from + 2 * e);
    } else {
      for (int e = tid; e < n; e += blockDim.x) slot[e] = from[e];
    }
    return;
  }
  const int units = g.KC / 8;
  {
    for (int e = tid; e < g.band_px * units; e += blockDim.x) {
      const int p = e / units;
      const int u = e - p * units;
      const int r = p / g.Wp;
      const int ih = oh0 - g.org + r;
      const int iw = p - r * g.Wp - g.org;
      bf16* dst = slot + p * g.SA + 8 * u;
      if (r < rows + 2 && ih >= 0 && ih < g.Hs && iw >= 0 && iw < g.Ws) {
        stage8(dst, src + ((size_t)ih * g.Ws + iw) * g.Cs + 8 * u,
               min(8, g.Cs - 8 * u), g.vec_x != 0);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
}

// Packed (forward at cin <= 3): the band's patch matrix from its source
// rows in `raw` (stage_band). A thread a pixel q = r * Wp + c of the
// warps' pixels: its 9 CIN patch values, column k = (3 kh + kw) CIN + ci,
// zero past 9 CIN and outside the image, then KP / 8 16-byte stores.
template <int CIN>
__device__ __forceinline__ void build_patches(bf16* sa, const bf16* raw,
                                              const MmaGeom& g, int oh0) {
  constexpr int KP = (9 * CIN + 15) & ~15;
  const int ih_lo = max(0, oh0 - g.org);
  const int rows_in = min(g.Hs, oh0 - g.org + g.CR + 2) - ih_lo;
  for (int q = threadIdx.x; q < g.warps * kWarpPixels; q += blockDim.x) {
    const int r = q / g.Wp;
    const int rr = oh0 - g.org + r - ih_lo;  // the raw row of kh = 0
    const int iw = q - r * g.Wp - g.org;     // the column of kw = 0
    __align__(16) bf16 v[KP];
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const bool row = (unsigned)(rr + kh) < (unsigned)rows_in;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const bool ok = row && (unsigned)(iw + kw) < (unsigned)g.Ws;
        const bf16* p = raw + ((rr + kh) * g.Ws + iw + kw) * CIN;
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

// Block (chunk of bands, channel chunk, tenant). Warp w: band pixels q =
// 32 w .. 32 w + 31 x the block's NB channels; lane (g8 = lane / 4, t4 =
// lane % 4) holds accumulator acc[mt][nt][i] of pixel 32 w + 16 mt + g8 +
// 8 (i / 2) and channel 8 nt + 2 t4 + i % 2 (the m16n8 C fragment).
template <int NT, bool kStats, bool kDgrad>
__global__ void __launch_bounds__(kMmaThreads, 2)
conv3x3_s1_mma_kernel(const bf16* __restrict__ src,
                      const bf16* __restrict__ w, const bf16* bias,
                      bf16* __restrict__ out, float* __restrict__ part,
                      MmaGeom g) {
  constexpr int NB = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  auto slot = [&](int i) {
    return reinterpret_cast<bf16*>(smem + g.a_bytes + i * g.slot_bytes);
  };
  bf16* sw =
      reinterpret_cast<bf16*>(smem + g.a_bytes + g.nslots * g.slot_bytes);
  float* wsum = reinterpret_cast<float*>(
      smem + g.a_bytes + g.nslots * g.slot_bytes + g.w_bytes);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const int t = blockIdx.z;
  const int n0 = blockIdx.y * NB;
  const int nvalid = min(NB, g.Co - n0);
  const bf16* srct = src + (size_t)t * g.N * g.Hs * g.Ws * g.Cs;
  stage_weights<kDgrad>(sw, w + (size_t)t * 9 * g.Cs * g.Co, g, n0, nvalid);

  // the lanes' ldmatrix row addresses: A row 16 mt + (lane & 15) of the
  // warp's pixels, k half lane / 16; forward B row k = lane & 15, columns
  // 8 (lane / 16) of each 16-column pair; dgrad B row n = 8 (lane / 16) +
  // (lane & 7) of each pair, k half (lane / 8) & 1
  const uint32_t a_off =
      2u * ((warp * kWarpPixels + (lane & 15)) * g.SA + (lane >> 4) * 8);
  const uint32_t b_lane =
      kDgrad ? smem_addr(sw) + 2u * ((((lane >> 4) << 3) + (lane & 7)) * g.WS +
                                     ((lane >> 3) & 1) * 8)
             : smem_addr(sw) + 2u * ((lane & 15) * g.WS + (lane >> 4) * 8);
  const uint32_t a_mt = 2u * 16 * g.SA;  // bytes to the second m16 tile
  const uint32_t b_tap = 2u * (kDgrad ? NB * g.WS : g.KC * g.WS);
  const uint32_t b_pair = 2u * (kDgrad ? 16 * g.WS : 16);
  const uint32_t b_k16 = 2u * (kDgrad ? 16 : 16 * g.WS);

  // a block's bands in order; packed, each band's source rows in flight
  // (cp.async into one slot) while the band before computes from the other
  const int total = g.N * g.nb;
  const int first = blockIdx.x * g.per;
  const int last = min(total, first + g.per);
  auto stage = [&](int band, bf16* into) {
    const int img = band / g.nb;
    const int oh0 = (band - img * g.nb) * g.CR;
    stage_band(into, srct + (size_t)img * g.Hs * g.Ws * g.Cs, g, oh0,
               min(g.CR, g.Ho - oh0));
  };
  if (g.packed && first < last) stage(first, slot(0));
  cp_async_commit();  // with the weights
  int cur = 0;
  for (int band = first; band < last; ++band, cur ^= g.packed) {
    const int img = band / g.nb;
    const int oh0 = (band - img * g.nb) * g.CR;
    const int rows = min(g.CR, g.Ho - oh0);
    if (!g.packed) {
      stage(band, slot(0));
      cp_async_commit();
      cp_async_wait<0>();
    } else if (band + 1 < last) {
      stage(band + 1, slot(cur ^ 1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    bf16* sa = slot(cur);
    if (g.packed) {
      sa = reinterpret_cast<bf16*>(smem);
      if (g.Cs == 1)
        build_patches<1>(sa, slot(cur), g, oh0);
      else if (g.Cs == 2)
        build_patches<2>(sa, slot(cur), g, oh0);
      else
        build_patches<3>(sa, slot(cur), g, oh0);
      __syncthreads();
    }
    const uint32_t a_lane = smem_addr(sa) + a_off;

    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
#pragma unroll 1
    for (int tap = 0; tap < g.taps; ++tap) {
      const int kh = tap / 3;
      const int shift = g.packed ? 0 : kh * g.Wp + tap - 3 * kh;
      uint32_t a_addr = a_lane + 2u * shift * g.SA;
      uint32_t b_addr = b_lane + tap * b_tap;
#pragma unroll 1
      for (int k0 = 0; k0 < g.KC; k0 += 16) {
        uint32_t a[2][4];
        ldsm_x4(a[0], a_addr);
        ldsm_x4(a[1], a_addr + a_mt);
        uint32_t b[NT][2];
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r[4];
          if (kDgrad)
            ldsm_x4(r, b_addr + np * b_pair);
          else
            ldsm_x4_t(r, b_addr + np * b_pair);
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
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
        a_addr += 32u;  // 16 bf16
        b_addr += b_k16;
      }
    }
    __syncthreads();  // every warp is done with the band

    // 1. the sum rounded once, the bias add rounded again, two channels a
    // conversion; 3. (first half) the rounded pixels into shared memory
    // (the band's space)
    unsigned valid = 0;  // bit 2 mt + h: pixel 16 mt + g8 + 8 h
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = warp * kWarpPixels + 16 * mt + g8 + 8 * h;
        const int r = q / g.Wp;
        if (r < rows && q - r * g.Wp < g.Wo) valid |= 1u << (2 * mt + h);
      }
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
      // 3. 16-byte stores of each valid pixel's channels
      __syncwarp();
      bf16* oi = out + ((size_t)t * g.N + img) * g.Ho * g.Wo * g.Co + n0;
      for (int e = lane; e < kWarpPixels * NT; e += 32) {
        const int px = e / NT;
        const int ch = 8 * (e - px * NT);
        const int q = warp * kWarpPixels + px;
        const int r = q / g.Wp;
        const int c = q - r * g.Wp;
        if (r >= rows || c >= g.Wo || ch >= nvalid) continue;
        bf16* dst = oi + ((size_t)(oh0 + r) * g.Wo + c) * g.Co + ch;
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
      // and the sum of squared deviations from the warp's mean (M2) — a
      // thread's pixels, then the xor tree over the 8 lanes of a channel
      // pair (every lane ends with the same bits), all channels of a pass
      // at once — into the warp's rows of shared memory;
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
      float* wst = wsum + warp * 3 * NB;  // the warp's (n, sum, M2) rows
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
      // then per channel the band's count, mean (the warps' sums in warp
      // order over the count) and M2 (the warps' M2 plus their count x the
      // squared distance of their mean from the band's, in warp order)
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
// kernel "mma") at this shape; false where the shape or the plan's
// `channels` (NB), `blocks` (grid.x), `threads` and `smem` do not match it.
// Forward: source x (H, W, cin), output (H + 2 pad - 2, ...) x cout. Dgrad:
// source dy (H + 2 pad - 2, ..., cout_fwd), output dx (H, W, cin_fwd).
bool mma_geom(MmaGeom& g, bool dgrad, int T, int N, int H, int W, int pad,
              int cin, int cout, int band_rows, int channels, int blocks,
              int threads, int smem) {
  if ((pad != 0 && pad != 1) || T < 1 || T > 65535 || N < 1 || cin < 1 ||
      cout < 1 || band_rows < 1)
    return false;
  g.N = N;
  if (!dgrad) {
    g.Hs = H, g.Ws = W, g.Cs = cin, g.Co = cout, g.org = pad;
    g.Ho = H + 2 * pad - 2, g.Wo = W + 2 * pad - 2;
  } else {
    g.Ho = H, g.Wo = W, g.Co = cin, g.Cs = cout, g.org = 2 - pad;
    g.Hs = H + 2 * pad - 2, g.Ws = W + 2 * pad - 2;
  }
  if (g.Hs < 1 || g.Ws < 1 || g.Ho < 1 || g.Wo < 1 || band_rows > g.Ho)
    return false;
  const int NT = channels / 8;
  if (channels % 8 || (NT != 1 && NT != 2 && NT != 4 && NT != 6 && NT != 8))
    return false;
  g.Wp = g.Wo + 2;
  g.CR = band_rows;
  g.nb = cdiv(g.Ho, band_rows);
  g.warps = cdiv((band_rows - 1) * g.Wp + g.Wo, kWarpPixels);
  g.packed = !dgrad && g.Cs <= 3;
  g.taps = g.packed ? 1 : 9;
  g.KC = g.packed ? round16(9 * g.Cs) : round16(g.Cs);
  g.SA = g.KC + 8;
  g.NB = channels;
  g.OS = NT % 2 ? channels : channels + 8;
  g.WS = dgrad ? g.KC + 8 : g.OS;
  const int rows_px = kWarpPixels * g.warps;
  g.band_px = g.packed ? rows_px
                       : std::max((band_rows + 2) * g.Wp,
                                  rows_px + 2 * g.Wp + 2);
  const int band_b = round16(std::max(2 * g.band_px * g.SA,
                                      2 * rows_px * g.OS));
  g.raw_elems = ((band_rows + 2) * g.Ws * g.Cs + 1) & ~1;
  g.a_bytes = g.packed ? band_b : 0;
  g.slot_bytes = g.packed ? round16(2 * g.raw_elems) : band_b;
  g.nslots = g.packed ? 2 : 1;
  g.w_bytes = dgrad ? 2 * 9 * channels * g.WS : 2 * g.taps * g.KC * g.WS;
  g.s_bytes = dgrad ? 0 : 4 * 3 * g.warps * channels;
  const long long X = (long long)N * g.nb;
  if (blocks < 1 || blocks > X) return false;
  g.per = (int)((X + blocks - 1) / blocks);
  const int want =
      g.a_bytes + g.nslots * g.slot_bytes + g.w_bytes + g.s_bytes;
  return threads == kWarpPixels * g.warps && threads <= kMmaThreads &&
         smem == want && smem <= kMaxSmem && cdiv(g.Co, channels) <= 65535 &&
         (long long)g.N * g.Hs * g.Ws * g.Cs < (1ll << 31) &&
         (long long)g.N * g.Ho * g.Wo * g.Co < (1ll << 31);
}

template <int NT, bool kStats, bool kDgrad>
cudaError_t launch_mma(const bf16* src, const bf16* w, const bf16* b,
                       bf16* out, float* part, const MmaGeom& g, int T,
                       int blocks, int threads, int smem, cudaStream_t st) {
  static bool done[64] = {};
  cudaError_t err =
      allow_smem(conv3x3_s1_mma_kernel<NT, kStats, kDgrad>, done);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, cdiv(g.Co, g.NB), T);
  conv3x3_s1_mma_kernel<NT, kStats, kDgrad>
      <<<grid, threads, smem, st>>>(src, w, b, out, part, g);
  return cudaGetLastError();
}

template <bool kStats, bool kDgrad>
cudaError_t dispatch_mma(const bf16* src, const bf16* w, const bf16* b,
                         bf16* out, float* part, const MmaGeom& g, int T,
                         int blocks, int threads, int smem,
                         cudaStream_t st) {
  switch (g.NB / 8) {
    case 1:
      return launch_mma<1, kStats, kDgrad>(src, w, b, out, part, g, T,
                                           blocks, threads, smem, st);
    case 2:
      return launch_mma<2, kStats, kDgrad>(src, w, b, out, part, g, T,
                                           blocks, threads, smem, st);
    case 4:
      return launch_mma<4, kStats, kDgrad>(src, w, b, out, part, g, T,
                                           blocks, threads, smem, st);
    case 6:
      return launch_mma<6, kStats, kDgrad>(src, w, b, out, part, g, T,
                                           blocks, threads, smem, st);
    case 8:
      return launch_mma<8, kStats, kDgrad>(src, w, b, out, part, g, T,
                                           blocks, threads, smem, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// 16-byte copies where every row of 8 bf16 starts on 16 bytes: x (dy)
// rows of Cs, the weights' rows (forward: cout; dgrad: cout_fwd = Cs), y
// (dx) rows of Co
void set_vectors(MmaGeom& g, bool dgrad, const void* src, const void* w,
                 const void* out) {
  g.vec_x = g.packed ? (g.Ws * g.Cs) % 2 == 0 &&
                           (reinterpret_cast<unsigned long long>(src) & 3) == 0
                     : g.Cs % 8 == 0 && aligned16(src);
  g.vec_w = (dgrad ? g.Cs : g.Co) % 8 == 0 && aligned16(w);
  g.vec_y = g.Co % 8 == 0 && aligned16(out);
}

}  // namespace maml

extern "C" {

// y (T, N, Ho, Wo, cout) = the stride-1 conv at `pad` (1 or 0) of x (T, N,
// H, W, cin) with w (T, 3, 3, cin, cout), + b (T, cout) where b is not
// null; bf16 in and out, Ho = H + 2*pad - 2 (Wo likewise). The plan
// (kernels/conv_block.py::fwd_plan, kernel "mma"): `band_rows`, `channels`
// a block, `blocks` (grid.x), `threads`, `smem`, checked here against the
// geometry they follow from. One launch on `stream`; returns its CUDA
// error, 0 on success.
int conv3x3_fwd_mma(const __nv_bfloat16* x, const __nv_bfloat16* w,
                    const __nv_bfloat16* b, __nv_bfloat16* y, int T, int N,
                    int H, int W, int pad, int cin, int cout, int band_rows,
                    int channels, int blocks, int threads, int smem,
                    void* stream) {
  using namespace maml;
  MmaGeom g;
  if (!mma_geom(g, false, T, N, H, W, pad, cin, cout, band_rows, channels,
                blocks, threads, smem))
    return (int)cudaErrorInvalidValue;
  set_vectors(g, false, x, w, y);
  return (int)dispatch_mma<false, false>(x, w, b, y, nullptr, g, T, blocks,
                                         threads, smem,
                                         static_cast<cudaStream_t>(stream));
}

// The same with b (T, cout) required, and y's per-(tenant, channel) mean,
// biased var and rstd (T, cout) each in bf16 (mean and var the f32 merge
// rounded once, rstd the f32 rsqrt of the bf16 var + eps rounded once; eps
// the bf16 value of the batch norm's eps); part (T, N * bands, 3, cout) f32
// scratch, bands = ceil(Ho / band_rows). Two launches on `stream` (the
// conv, the merge); returns the first CUDA error.
int conv3x3_fwd_stats_mma(const __nv_bfloat16* x, const __nv_bfloat16* w,
                          const __nv_bfloat16* b, __nv_bfloat16* y,
                          float* part, __nv_bfloat16* mean,
                          __nv_bfloat16* var, __nv_bfloat16* rstd, int T,
                          int N, int H, int W, int pad, int cin, int cout,
                          int band_rows, int channels, int blocks,
                          int threads, int smem, float eps, void* stream) {
  using namespace maml;
  MmaGeom g;
  if (b == nullptr || !mma_geom(g, false, T, N, H, W, pad, cin, cout,
                                band_rows, channels, blocks, threads, smem))
    return (int)cudaErrorInvalidValue;
  set_vectors(g, false, x, w, y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch_mma<true, false>(x, w, b, y, part, g, T, blocks,
                                              threads, smem, st);
  if (err != cudaSuccess) return (int)err;
  bn_stats_merge_kernel<__nv_bfloat16>
      <<<dim3(cout, T), kMergeThreads, 0, st>>>(part, mean, var, rstd,
                                                N * g.nb, cout, eps);
  return (int)cudaGetLastError();
}

// dx (T, N, H, W, cin) = the input gradient of the stride-1 conv at `pad`
// with the forward weights w (T, 3, 3, cin, cout), from dy (T, N, Ho, Wo,
// cout), Ho = H + 2*pad - 2: the conv of dy at pad 2 - pad with tap (kh, kw)
// read from w[2-kh][2-kw] transposed in channels. bf16 in and out. The plan
// (kernels/conv_block.py::dgrad_plan, kernel "mma") as for the forward,
// `channels` of cin a block. One launch on `stream`; returns its CUDA
// error, 0 on success.
int conv3x3_dgrad_mma(const __nv_bfloat16* dy, const __nv_bfloat16* w,
                      __nv_bfloat16* dx, int T, int N, int H, int W, int pad,
                      int cin, int cout, int band_rows, int channels,
                      int blocks, int threads, int smem, void* stream) {
  using namespace maml;
  MmaGeom g;
  if (!mma_geom(g, true, T, N, H, W, pad, cin, cout, band_rows, channels,
                blocks, threads, smem))
    return (int)cudaErrorInvalidValue;
  set_vectors(g, true, dy, w, dx);
  return (int)dispatch_mma<false, true>(dy, w, nullptr, dx, nullptr, g, T,
                                        blocks, threads, smem,
                                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
