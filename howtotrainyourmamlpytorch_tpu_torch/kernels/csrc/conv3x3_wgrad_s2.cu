// K4 wgrad at stride 2, pad 1 or 0, in f32 and bf16: dW[t] = patches(x[t])^T
// dy[t] and db[t] = sum dy[t], a GEMM with a small output (9 cin x cout)
// and a long reduction over the N * Ho * Wo output pixels, on bands staged
// once in shared memory: f32 on FFMA (the band design of conv3x3_bwd_s1.cu),
// bf16 on the tensor cores (mma.sync m16n8k16, f32 sums: the design of
// conv3x3_wgrad_s1_bf16.cu).
//
// Replaces (JAX package) the gradient XLA derives for
// howtotrainyourmamlpytorch_tpu/ops/functional.py::_conv2d_raw :199 with
// respect to w and b at stride 2 (`conv_bn_act` :249 of the strided models,
// max_pooling=False), in the inner-loop support gradient
// (core/maml.py::_task_learner) and the outer backward: the rows
// conv3x3_s2_wgrad, conv3x3_s2_p0_wgrad and their _bf16 kin.
//
// Bound on an H100 (67 TFLOP/s FFMA, 989 dense bf16; 3.35 TB/s): in f32 the
// FLOPs at 48 and 64 channels (2 * 9 * cin * cout an output pixel) and the
// bytes at cin 1 and 3 (the Omniglot image: dy alone is 8 MB at T = 8, N =
// 20, 0.0026 ms); in bf16 the bytes everywhere. So each byte of x and dy is
// staged from memory once a band, no K row of a block is dead, and the
// splits are kept few where the bytes bind.
//
// At stride 2 a band of CR output rows reads 2 CR + 1 source rows (zero
// outside the image at pad 1; at pad 0 the last source row and column of an
// even map are read by no output), and the three taps of a kernel row at
// output column ow still read 3 cin contiguous values, from source column 2
// ow - pad: only the pixel stride doubles.
//
// * f32 (conv3x3_s2_wgrad_band_kernel): the stride-1 band kernel's body
//   (wgrad_band.cuh) at stride 2. A block owns one (tenant, split of
//   bands), a slice of kernel rows (all three at cin <= 4, one above) and
//   whole channel rows; each band's source rows (the 2 CR + 1 rows, or
//   with one kernel row a block the CR rows 2 (oh0 + r) - pad + kh its
//   outputs read) and its dy rows go to shared memory once by cp.async,
//   into a two-slot ring. A thread holds TK x 8 accumulators: a run of TK
//   = 8 consecutive k of one kernel row (TK = 9, a whole kernel row, at cin
//   <= 3), times 8 channels; replicas of the output tile sum every R-th
//   pixel and meet in a fixed pairwise tree; a warp of its own sums db.
// * bf16, cin >= 4 (conv3x3_s2_wgrad_mma_kernel): a warp a tap (9 warps),
//   MT m16 tiles of source channels x NT n8 tiles of output channels, K
//   over the band's output pixels in k16 steps; A and B by ldmatrix.trans
//   (channels contiguous within a pixel, K over pixels). The band's source
//   rows are staged as even and odd column planes (as conv3x3_s2.cu's K1
//   stages them): band column cc (source column cc - pad) goes to plane cc &
//   1, index cc / 2, so tap (kh, kw) of output pixel (r, c) is plane pixel
//   (2 r + kh, kw & 1, c + kw / 2), and the 8 pixels of an ldmatrix row
//   group lie next to each other in one plane: on a stride of KC + 8 bf16
//   they fall in 8 distinct 16-byte bank groups, where a doubled pixel
//   stride would put two in each. dy is staged densely (r * Wo + c), so a
//   lane's A row is no constant offset of the step's first pixel: each lane
//   carries its own pixel's (r, c) from step to step (a pixel past the
//   band reads the band's first: dy is zero there).
// * bf16, cin <= 3 (conv3x3_s2_wgrad_mma_packed_kernel): each output
//   pixel's 9 cin patch values and a 1 (db) packed into K = 16 or 32 rows
//   of A by a thread a pixel from the band's source rows (staged as they
//   lie in memory); 8 warps split the band's k16 steps and their tiles are
//   summed in warp order through shared memory.
// * db in bf16 with cin >= 4: warp w < NT multiplies the band's dy
//   fragments of n-tile w by an A of ones after the band's products, its
//   running sum kept in shared memory between bands.
// * Determinism: no atomics, no TF32. Each output's sum runs over a
//   split's bands in order (f32: pixel by pixel in a thread, then the
//   replicas' tree; bf16: k16 step by k16 step in a warp, the packed
//   kernel's warps in order); a block writes its split's f32 partials (T,
//   S, 9 cin cout) and (T, S, cout) and the second launch
//   (wgrad_reduce.cuh) sums them in split order. A second launch gives the
//   first launch's bits.
// * Rounding: f32 as the twin, in another order (within 1e-5 + 1e-4 of
//   the output's scale); bf16 x and dy, every product exact in f32, every
//   sum in f32, dw and db rounded to bf16 once at the reduce's store
//   (within one bf16 ulp of the twin, whose GEMM sums in another order).
// The launch plans are pure functions of the shape
// (kernels/conv_block.py::wgrad_plan, kernels "s2" and "s2_mma"); the
// entries check the plan's band rows, tiles, splits, threads and shared
// memory against the geometry here and launch nothing otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"
#include "wgrad_band.cuh"
#include "wgrad_reduce.cuh"

namespace maml {

// --- f32: the band kernel (wgrad_band.cuh) at stride 2 ----------------------

template <int TK, bool kVecA>
__global__ void __launch_bounds__(kMaxThreads, 2)
conv3x3_s2_wgrad_band_kernel(const float* __restrict__ x,
                             const float* __restrict__ dy,
                             float* __restrict__ part_w,
                             float* __restrict__ part_b, WgradGeom g) {
  wgrad_band_body<2, TK, kVecA>(x, dy, part_w, part_b, g);
}

struct S2Band {
  template <int TK, bool kVecA>
  static auto kernel() {
    return conv3x3_s2_wgrad_band_kernel<TK, kVecA>;
  }
};

// --- bf16: the tensor-core kernels -------------------------------------------

constexpr int kS2TapWarps = 9;     // the taps kernel: a warp a tap
constexpr int kS2PackedWarps = 8;  // the packed kernel: warps over k16 steps
constexpr int kS2MmaThreads = 32 * kS2TapWarps;
constexpr uint32_t kS2Ones = 0x3F803F80u;  // two bf16 1.0

struct S2MmaGeom {
  int N, H, W;      // x: images a tenant, rows, columns
  int Ho, Wo;       // dy
  int cin, cout, pad;
  int CR, nb;       // output rows a band, bands an image
  int PW;           // taps: a column plane's pixels, Wo + 1
  int SA;           // bf16 an x plane (or patch) pixel: KC + 8, KC the x
                    // channels a pixel (16 MT) or the packed K
  int SD;           // bf16 a dy band pixel: NB, + 8 where NT is even
  int kpx;          // the band's output pixels the k16 steps cover:
                    // round16(CR Wo)
  int xpx;          // taps: the band's plane pixels, (2 CR + 1) rows of 2 PW
  int a_bytes;      // packed: the patch matrix
  int x_bytes, d_bytes;  // a slot's x (planes or source rows) and dy band
  int db_at;        // taps: the db warps' running sums, past the slots
  int S, co_chunks;
  int vec_x, vec_dy;
};

__device__ __forceinline__ bf16* s2_slot(unsigned char* smem,
                                         const S2MmaGeom& g, int i) {
  return reinterpret_cast<bf16*>(smem + g.a_bytes +
                                 i * (g.x_bytes + g.d_bytes));
}

// f(p, r, c, u) for unit u < U (16 bytes, 8 bf16) of each pixel p < npx,
// p = r * Wr + c: thread tid takes unit tid % U of pixels tid / U, tid / U
// + blockDim / U, ..., its (r, c) advanced without a division a pixel.
template <int U, typename F>
__device__ __forceinline__ void s2_units(int npx, int Wr, F f) {
  const int step = blockDim.x / U;
  if ((int)threadIdx.x >= step * U) return;
  const int u = threadIdx.x % U;
  int p = threadIdx.x / U;
  int r = p / Wr;
  int c = p - r * Wr;
  const int dr = step / Wr;
  const int dc = step - dr * Wr;
  for (; p < npx; p += step) {
    f(p, r, c, u);
    c += dc;
    r += dr;
    if (c >= Wr) {
      c -= Wr;
      ++r;
    }
  }
}

// The band at output row oh0 (`rows` rows) of the image at `xi` / `dyi`
// into slot `sx` (x) and `sd` (dy), in flight (cp.async) until the caller
// waits. Its source rows are 2 oh0 - pad .. 2 oh0 - pad + 2 rows. x: the
// taps kernel's source channels [ci0, ci0 + civ) (UX = KC / 8 units a
// pixel) as the two column planes, row R's plane pixels at R * 2 PW: band
// column cc (source column cc - pad) at (cc & 1) * PW + cc / 2, zero
// outside the image and past the band's rows; packed (UX = 0), the source
// rows inside the image as they lie in memory (W x cin bf16 a row), by
// 4-byte cp.async where `vec_x`, else an element at a time. dy: output
// channels [co0, co0 + cov) (UD = NB / 8 units) of pixels p < kpx, p = r *
// Wo + c, zero where r >= rows.
template <int UX, int UD>
__device__ __forceinline__ void s2_stage_band(bf16* sx, bf16* sd,
                                              const bf16* xi, const bf16* dyi,
                                              const S2MmaGeom& g, int oh0,
                                              int rows, int ci0, int civ,
                                              int co0, int cov) {
  const int ih0 = 2 * oh0 - g.pad;
  if constexpr (UX == 0) {
    const int tid = threadIdx.x;
    const int ih_lo = max(0, ih0);
    const int ih_hi = min(g.H, ih0 + 2 * g.CR + 1);
    const int n = (ih_hi - ih_lo) * g.W * g.cin;
    const bf16* from = xi + (size_t)ih_lo * g.W * g.cin;
    if (g.vec_x) {
      for (int e = tid; e < n / 2; e += blockDim.x)
        cp_async4(sx + 2 * e, from + 2 * e);
    } else {
      for (int e = tid; e < n; e += blockDim.x) sx[e] = from[e];
    }
  } else {
    s2_units<UX>(g.xpx, 2 * g.PW, [&](int p, int R, int q, int u) {
      const int odd = q >= g.PW ? 1 : 0;
      const int iw = 2 * (q - odd * g.PW) + odd - g.pad;
      const int ih = ih0 + R;
      bf16* dst = sx + p * g.SA + 8 * u;
      if (R <= 2 * rows && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
        stage8(dst, xi + ((size_t)ih * g.W + iw) * g.cin + ci0 + 8 * u,
               min(8, civ - 8 * u), g.vec_x != 0);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    });
  }
  s2_units<UD>(g.kpx, g.Wo, [&](int p, int r, int c, int u) {
    bf16* dst = sd + p * g.SD + 8 * u;
    if (r < rows)
      stage8(dst, dyi + ((size_t)(oh0 + r) * g.Wo + c) * g.cout + co0 + 8 * u,
             min(8, cov - 8 * u), g.vec_dy != 0);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  });
}

// The block's tenant t (grid.z), split (grid.x) and chunks (grid.y =
// source chunk cic * co_chunks + output chunk): source channels [ci0, ci0
// + civ) of chunks of CIB, output channels [co0, co0 + cov) of chunks of
// NB. (The packed kernel: one source chunk, CIB = cin.)
struct S2Place {
  int t, split, cic, ci0, civ, co0, cov;
};
template <int CIB, int NB>
__device__ __forceinline__ S2Place s2_place(const S2MmaGeom& g) {
  S2Place p;
  const int y = blockIdx.y;
  p.t = blockIdx.z;
  p.split = blockIdx.x;
  p.cic = y / g.co_chunks;
  p.ci0 = p.cic * CIB;
  p.civ = min(CIB, g.cin - p.ci0);
  p.co0 = (y - p.cic * g.co_chunks) * NB;
  p.cov = min(NB, g.cout - p.co0);
  return p;
}

// The split's bands of its tenant, image * nb + band in [first, last): the
// split's share of the N * nb in order (conv_block.WgradPlan.split_bands).
__device__ __forceinline__ int s2_split_edge(const S2MmaGeom& g, int split) {
  return (int)((long long)g.N * g.nb * split / g.S);
}

// Band `band` of the block's tenant (image band / nb) into slot i.
template <int UX, int UD>
__device__ __forceinline__ void s2_stage_at(unsigned char* smem,
                                            const S2MmaGeom& g,
                                            const S2Place& p, const bf16* x,
                                            const bf16* dy, int band, int i) {
  const int img = band / g.nb;
  const int oh0 = (band - img * g.nb) * g.CR;
  bf16* sx = s2_slot(smem, g, i);
  s2_stage_band<UX, UD>(
      sx, sx + g.x_bytes / 2,
      x + ((size_t)p.t * g.N + img) * g.H * g.W * g.cin,
      dy + ((size_t)p.t * g.N + img) * g.Ho * g.Wo * g.cout, g, oh0,
      min(g.CR, g.Ho - oh0), p.ci0, p.civ, p.co0, p.cov);
}

// The two-slot ring, before band `band` multiplies from slot `cur`: the
// next band's copies issued into the other slot, this band's awaited, then
// a barrier.
template <int UX, int UD>
__device__ __forceinline__ void s2_ring_next(unsigned char* smem,
                                             const S2MmaGeom& g,
                                             const S2Place& p, const bf16* x,
                                             const bf16* dy, int band,
                                             int last, int cur) {
  if (band + 1 < last) {
    s2_stage_at<UX, UD>(smem, g, p, x, dy, band + 1, cur ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
}

// The taps kernel. Block (split, source chunk * co_chunks + output chunk,
// tenant); warp w is tap (kh, kw) = (w / 3, w % 3): its lane (g8 = lane /
// 4, t4 = lane % 4) holds acc[mt][nt][i] of source channel ci0 + 16 mt + g8
// + 8 (i / 2) and output channel co0 + 8 nt + 2 t4 + i % 2 (the m16n8 C
// fragment), and warp w < NT of the first source chunk db's n-tile w.
template <int MT, int NT>
__global__ void __launch_bounds__(kS2MmaThreads, MT * NT >= 16 ? 1 : 2)
conv3x3_s2_wgrad_mma_kernel(const bf16* __restrict__ x,
                            const bf16* __restrict__ dy,
                            float* __restrict__ part_w,
                            float* __restrict__ part_b, S2MmaGeom g) {
  constexpr int CIB = 16 * MT;
  constexpr int NB = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t ones[4] = {kS2Ones, kS2Ones, kS2Ones, kS2Ones};
  const S2Place p = s2_place<CIB, NB>(g);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool db_warp = p.cic == 0 && warp < NT;

  // tap (kh, kw) of output pixel (r, c) is plane pixel r * 4 PW + c +
  // shift; the lane's A row is pixel pl of each k16 step, channels 8
  // ((lane / 8) & 1) (ldmatrix.trans: A[channel][pixel]); its B row pixel
  // (lane & 15), channels 8 (lane / 16)
  const int kh = warp / 3;
  const int kw = warp - 3 * kh;
  const int shift = kh * 2 * g.PW + (kw & 1) * g.PW + (kw >> 1);
  const int rstride = 4 * g.PW;
  const int pl = (lane & 7) + ((lane >> 4) << 3);
  const uint32_t a_chan = 16u * ((lane >> 3) & 1);
  const uint32_t a_px = 2u * g.SA;
  const int dr = 16 / g.Wo;
  const int dc = 16 - dr * g.Wo;
  const int r_first = pl / g.Wo;
  const int c_first = pl - r_first * g.Wo;
  const uint32_t b_lane =
      (uint32_t)g.x_bytes + 2u * ((lane & 15) * g.SD + (lane >> 4) * 8);
  const uint32_t b_k16 = 2u * 16 * g.SD;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  float* dbs = reinterpret_cast<float*>(smem + g.db_at) + 4 * threadIdx.x;
  if (db_warp)
#pragma unroll
    for (int i = 0; i < 4; ++i) dbs[i] = 0.f;

  const int first = s2_split_edge(g, p.split);
  const int last = s2_split_edge(g, p.split + 1);
  s2_stage_at<2 * MT, NT>(smem, g, p, x, dy, first, 0);
  cp_async_commit();
  int cur = 0;
  for (int band = first; band < last; ++band, cur ^= 1) {
    s2_ring_next<2 * MT, NT>(smem, g, p, x, dy, band, last, cur);
    const int img = band / g.nb;
    const int npix = min(g.CR, g.Ho - (band - img * g.nb) * g.CR) * g.Wo;
    const uint32_t base = smem_addr(s2_slot(smem, g, cur));
    const uint32_t a_base = base + a_chan;
    uint32_t b_addr = base + b_lane;
    const int steps = (npix + 15) >> 4;
    int q = pl, r = r_first, c = c_first;
#pragma unroll 1
    for (int ks = 0; ks < steps; ++ks) {
      // a pixel past the band reads the band's first (its dy is zero)
      const int xp = (q < npix ? r * rstride + c : 0) + shift;
      const uint32_t a_addr = a_base + a_px * (uint32_t)xp;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldsm_x4_t(a[mt], a_addr + 32u * mt);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t rr[4];
        ldsm_x4_t(rr, b_addr + 32u * np);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], rr[0], rr[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], rr[2], rr[3]);
        }
      }
      if (NT % 2) {
        uint32_t b0, b1;
        ldsm_x2_t(b0, b1, b_addr + 32u * (NT / 2));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_bf16(acc[mt][NT - 1], a[mt], b0, b1);
      }
      b_addr += b_k16;
      q += 16;
      c += dc;
      r += dr;
      if (c >= g.Wo) {
        c -= g.Wo;
        ++r;
      }
    }
    if (db_warp) {  // the band's dy of n-tile `warp`, k16 step by step
      float d[4] = {dbs[0], dbs[1], dbs[2], dbs[3]};
      const uint32_t at = base + b_lane + 16u * warp;
#pragma unroll 1
      for (int ks = 0; ks < steps; ++ks) {
        uint32_t b0, b1;
        ldsm_x2_t(b0, b1, at + ks * b_k16);
        mma_bf16(d, ones, b0, b1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) dbs[i] = d[i];
    }
    __syncthreads();  // every warp is done with the slot
  }

  // the split's partials: row tap * cin + ci of dW, column co
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  float* pw = part_w + ((size_t)p.t * g.S + p.split) * 9 * g.cin * g.cout;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = p.ci0 + 16 * mt + g8 + 8 * h;
      if (ci >= g.cin) continue;
      float* row = pw + ((size_t)warp * g.cin + ci) * g.cout + p.co0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = 8 * nt + 2 * t4 + j;
          if (n < p.cov) row[n] = acc[mt][nt][2 * h + j];
        }
    }
  if (db_warp && g8 == 0) {
    float* pb = part_b + ((size_t)p.t * g.S + p.split) * g.cout + p.co0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = 8 * warp + 2 * t4 + j;
      if (n < p.cov) pb[n] = dbs[j];
    }
  }
}

// The packed kernel (cin = CIN <= 3). Block (split, output chunk, tenant).
// Each band: a thread a pixel q = r * Wo + c < kpx builds its patch row from
// the staged source rows — column k = (3 kh + kw) CIN + ci, the x value of
// tap (kh, kw) at source (2 (oh0 + r) - pad + kh, 2 c - pad + kw), zero
// outside the image; 1 at k = 9 CIN (db), 0 past it — then warp w
// multiplies the band's k16 steps w, w + 8, ...; lane (g8, t4) holds
// acc[mt][nt][i] of row 16 mt + g8 + 8 (i / 2) and column 8 nt + 2 t4 + i %
// 2. At the end the warps' tiles are summed in warp order.
template <int CIN, int NT>
__global__ void __launch_bounds__(kS2MmaThreads, 2)
conv3x3_s2_wgrad_mma_packed_kernel(const bf16* __restrict__ x,
                                   const bf16* __restrict__ dy,
                                   float* __restrict__ part_w,
                                   float* __restrict__ part_b, S2MmaGeom g) {
  constexpr int KP = (9 * CIN + 1 + 15) & ~15;
  constexpr int MT = KP / 16;
  constexpr int NB = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  bf16* sa = reinterpret_cast<bf16*>(smem);  // the patch matrix

  const uint32_t a_lane =
      smem_addr(sa) + 2u * (((lane & 7) + ((lane >> 4) << 3)) * g.SA +
                            ((lane >> 3) & 1) * 8);
  const uint32_t b_lane =
      (uint32_t)g.x_bytes + 2u * ((lane & 15) * g.SD + (lane >> 4) * 8);

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const S2Place p = s2_place<CIN, NB>(g);
  const int first = s2_split_edge(g, p.split);
  const int last = s2_split_edge(g, p.split + 1);
  s2_stage_at<0, NT>(smem, g, p, x, dy, first, 0);
  cp_async_commit();
  int cur = 0;
  for (int band = first; band < last; ++band, cur ^= 1) {
    s2_ring_next<0, NT>(smem, g, p, x, dy, band, last, cur);
    const int img = band / g.nb;
    const int oh0 = (band - img * g.nb) * g.CR;
    const int rows = min(g.CR, g.Ho - oh0);
    const bf16* raw = s2_slot(smem, g, cur);
    const int ih0 = 2 * oh0 - g.pad;
    const int ih_lo = max(0, ih0);
    const int rows_in = min(g.H, ih0 + 2 * g.CR + 1) - ih_lo;
    for (int q = tid; q < g.kpx; q += blockDim.x) {
      const int r = q / g.Wo;
      const int rr = ih0 + 2 * r - ih_lo;     // the raw row of kh = 0
      const int iw = 2 * (q - r * g.Wo) - g.pad;  // the column of kw = 0
      __align__(16) bf16 v[KP];
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const bool row = (unsigned)(rr + kh) < (unsigned)rows_in;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const bool ok = row && (unsigned)(iw + kw) < (unsigned)g.W;
          const bf16* px = raw + ((rr + kh) * g.W + iw + kw) * CIN;
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci)
            v[(3 * kh + kw) * CIN + ci] =
                ok ? px[ci] : __float2bfloat16_rn(0.f);
        }
      }
      v[9 * CIN] = __float2bfloat16_rn(1.f);
#pragma unroll
      for (int k = 9 * CIN + 1; k < KP; ++k) v[k] = __float2bfloat16_rn(0.f);
#pragma unroll
      for (int u = 0; u < KP / 8; ++u)
        *reinterpret_cast<uint4*>(sa + q * g.SA + 8 * u) =
            reinterpret_cast<const uint4*>(v)[u];
    }
    __syncthreads();
    const uint32_t b_base = smem_addr(s2_slot(smem, g, cur)) + b_lane;
    const int steps = (rows * g.Wo + 15) >> 4;
#pragma unroll 1
    for (int ks = warp; ks < steps; ks += kS2PackedWarps) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4_t(a[mt], a_lane + 2u * 16 * ks * g.SA + 32u * mt);
      const uint32_t b_addr = b_base + 2u * 16 * ks * g.SD;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldsm_x4_t(r, b_addr + 32u * np);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], r[0], r[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], r[2], r[3]);
        }
      }
      if (NT % 2) {
        uint32_t b0, b1;
        ldsm_x2_t(b0, b1, b_addr + 32u * (NT / 2));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma_bf16(acc[mt][NT - 1], a[mt], b0, b1);
      }
    }
    __syncthreads();  // every warp is done with the slot and the patches
  }

  // the warps' tiles (KP x NB f32 each) over the ring, summed in warp order
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tile[(warp * KP + 16 * mt + g8 + 8 * (i >> 1)) * NB + 8 * nt +
             2 * t4 + (i & 1)] = acc[mt][nt][i];
  __syncthreads();
  float* pw = part_w + ((size_t)p.t * g.S + p.split) * 9 * CIN * g.cout +
              p.co0;
  float* pb = part_b + ((size_t)p.t * g.S + p.split) * g.cout + p.co0;
  for (int e = tid; e < (9 * CIN + 1) * NB; e += blockDim.x) {
    const int m = e / NB;
    const int n = e - m * NB;
    if (n >= p.cov) continue;
    float sum = 0.f;
    for (int w = 0; w < kS2PackedWarps; ++w)
      sum += tile[(w * KP + m) * NB + n];
    if (m < 9 * CIN)
      pw[(size_t)m * g.cout + n] = sum;
    else
      pb[n] = sum;
  }
}

inline int s2_round16(int a) { return (a + 15) & ~15; }

// The geometry of the plan (kernels/conv_block.py::wgrad_plan, kernel
// "s2_mma") at this shape; false where the shape or the plan's
// `band_rows`, `m_tiles` (MT), `channels` (NB), `splits`, `threads` and
// `smem` do not match it.
bool s2_mma_geom(S2MmaGeom& g, const WgradCall& c) {
  if ((c.pad != 0 && c.pad != 1) || c.T < 1 || c.T > 65535 || c.N < 1 ||
      c.H < 1 || c.W < 1 || c.cin < 1 || c.cout < 1 || c.band_rows < 1 ||
      c.channels % 8 || c.channels < 8 || c.channels > 64 || c.splits < 1)
    return false;
  g.N = c.N, g.H = c.H, g.W = c.W, g.cin = c.cin, g.cout = c.cout;
  g.pad = c.pad;
  g.Ho = conv_out(c.H, c.pad, 2);
  g.Wo = conv_out(c.W, c.pad, 2);
  if (g.Ho < 1 || g.Wo < 1 || c.band_rows > g.Ho) return false;
  const int NT = c.channels / 8;
  g.CR = c.band_rows;
  g.nb = cdiv(g.Ho, c.band_rows);
  g.PW = g.Wo + 1;
  const bool packed = c.cin <= 3;
  const int KC = packed ? s2_round16(9 * c.cin + 1) : 16 * c.m_tiles;
  if (c.m_tiles != KC / 16 || c.m_tiles < 1 || c.m_tiles > 4) return false;
  g.SA = KC + 8;
  g.SD = NT % 2 ? c.channels : c.channels + 8;
  g.kpx = s2_round16(g.CR * g.Wo);
  g.xpx = (2 * g.CR + 1) * 2 * g.PW;
  // packed: the band's source rows, an even number of bf16
  const int raw_elems = ((2 * g.CR + 1) * c.W * c.cin + 1) & ~1;
  g.a_bytes = packed ? s2_round16(2 * g.kpx * g.SA) : 0;
  g.x_bytes = packed ? s2_round16(2 * raw_elems) : s2_round16(2 * g.xpx * g.SA);
  g.d_bytes = s2_round16(2 * g.kpx * g.SD);
  g.S = c.splits;
  g.co_chunks = cdiv(c.cout, c.channels);
  g.db_at = g.a_bytes + 2 * (g.x_bytes + g.d_bytes);
  const int ring = g.db_at + (packed ? 0 : 4 * 4 * 32 * NT);
  const int tree = packed ? 4 * kS2PackedWarps * KC * c.channels : 0;
  const int want = ring > tree ? ring : tree;
  const int ci_chunks = packed ? 1 : cdiv(c.cin, 16 * c.m_tiles);
  return c.splits <= c.N * g.nb && c.splits <= 65535 &&
         (long long)ci_chunks * g.co_chunks <= 65535 &&
         c.threads == 32 * (packed ? kS2PackedWarps : kS2TapWarps) &&
         c.smem == want && c.smem <= kMaxSmem &&
         (long long)c.N * c.H * c.W * c.cin < (1ll << 31) &&
         (long long)c.N * g.Ho * g.Wo * c.cout < (1ll << 31);
}

template <typename K>
cudaError_t launch_s2_mma(K kernel, bool* done, const WgradCall& c,
                          const S2MmaGeom& g, dim3 grid) {
  cudaError_t err = allow_smem(kernel, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid, c.threads, c.smem, c.stream>>>(
      static_cast<const bf16*>(c.x), static_cast<const bf16*>(c.dy),
      c.part_w, c.part_b, g);
  return cudaGetLastError();
}

template <int MT, int NT>
cudaError_t launch_s2_taps(const WgradCall& c, const S2MmaGeom& g,
                           dim3 grid) {
  static bool done[64] = {};
  return launch_s2_mma(conv3x3_s2_wgrad_mma_kernel<MT, NT>, done, c, g, grid);
}

template <int CIN, int NT>
cudaError_t launch_s2_packed(const WgradCall& c, const S2MmaGeom& g,
                             dim3 grid) {
  static bool done[64] = {};
  return launch_s2_mma(conv3x3_s2_wgrad_mma_packed_kernel<CIN, NT>, done, c,
                       g, grid);
}

using S2LaunchFn = cudaError_t (*)(const WgradCall&, const S2MmaGeom&, dim3);

// The instantiations: NT in {1, 2, 4, 6, 8}; the taps kernel at MT <= 4 and
// MT x NT <= 18 tiles a warp (the plan's rule), the packed kernel at cin 1,
// 2 and 3.
S2LaunchFn s2_mma_launcher(int cin, int MT, int NT) {
#define MAML_TAPS(m, n) \
  if (cin > 3 && MT == m && NT == n) return launch_s2_taps<m, n>;
#define MAML_PACKED(ci, n) \
  if (cin == ci && NT == n) return launch_s2_packed<ci, n>;
  MAML_TAPS(1, 1) MAML_TAPS(1, 2) MAML_TAPS(1, 4) MAML_TAPS(1, 6)
  MAML_TAPS(1, 8) MAML_TAPS(2, 1) MAML_TAPS(2, 2) MAML_TAPS(2, 4)
  MAML_TAPS(2, 6) MAML_TAPS(2, 8) MAML_TAPS(3, 1) MAML_TAPS(3, 2)
  MAML_TAPS(3, 4) MAML_TAPS(3, 6) MAML_TAPS(4, 1) MAML_TAPS(4, 2)
  MAML_TAPS(4, 4)
  MAML_PACKED(1, 1) MAML_PACKED(1, 2) MAML_PACKED(1, 4) MAML_PACKED(1, 6)
  MAML_PACKED(1, 8) MAML_PACKED(2, 1) MAML_PACKED(2, 2) MAML_PACKED(2, 4)
  MAML_PACKED(2, 6) MAML_PACKED(2, 8) MAML_PACKED(3, 1) MAML_PACKED(3, 2)
  MAML_PACKED(3, 4) MAML_PACKED(3, 6) MAML_PACKED(3, 8)
#undef MAML_TAPS
#undef MAML_PACKED
  return nullptr;
}

}  // namespace maml

extern "C" {

// dw (T, 3, 3, cin, cout) and db (T, cout) of the stride-2 conv at `pad` (1
// or 0) from x (T, N, H, W, cin) and dy (T, N, Ho, Wo, cout), Ho = (H + 2
// pad - 3) / 2 + 1 (Wo likewise), all f32; part_w (T, splits, 9 cin cout)
// and part_b (T, splits, cout) f32 scratch. The arguments come packed
// (wgrad_reduce.cuh: WgradCall); the plan (kernels/conv_block.py
// ::wgrad_plan, kernel "s2"): `splits`, `band_rows`, `kernel_rows`,
// `groups`, `replicas`, `threads`, `smem`. Two launches on the stream (the
// products, the reduce); returns the first CUDA error, 0 on success, and
// launches nothing where the plan does not match the shape.
int conv3x3_s2_wgrad_band(const long long* a) {
  return maml::run_wgrad_band<maml::S2Band>(a, 2);
}

// The same in bf16 on the tensor cores: x, dy, dw and db bf16 (part_w and
// part_b f32 scratch); the plan (kernel "s2_mma"): `band_rows`, `m_tiles`
// (source channels a block: 16 m_tiles; packed at cin <= 3, the packed K /
// 16), `channels` of cout a block, `splits`, `threads`, `smem`.
int conv3x3_s2_wgrad_mma(const long long* a) {
  using namespace maml;
  const WgradCall c = unpack_wgrad(a);
  S2MmaGeom g;
  if (!s2_mma_geom(g, c)) return (int)cudaErrorInvalidValue;
  const S2LaunchFn launch = s2_mma_launcher(c.cin, c.m_tiles, c.channels / 8);
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  const WgradDevice on(c.device);
  if (on.err != cudaSuccess) return (int)on.err;
  const bool packed = c.cin <= 3;
  g.vec_x = packed ? (c.W * c.cin) % 2 == 0 &&
                         (reinterpret_cast<unsigned long long>(c.x) & 3) == 0
                   : c.cin % 8 == 0 && aligned16(c.x);
  g.vec_dy = c.cout % 8 == 0 && aligned16(c.dy);
  const int ci_chunks = packed ? 1 : cdiv(c.cin, 16 * c.m_tiles);
  cudaError_t err =
      launch(c, g, dim3(c.splits, ci_chunks * g.co_chunks, c.T));
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wgrad_reduce<bf16>(
      c.part_w, c.part_b, static_cast<bf16*>(c.dw), static_cast<bf16*>(c.db),
      c.T, c.splits, 9 * c.cin * c.cout, c.cout, c.stream);
}

}  // extern "C"
