// K4 wgrad in bf16 at stride 1, pad 1 or 0: dW[t] = patches(x[t])^T dy[t]
// and db[t] = sum dy[t], a GEMM with a small output and a long reduction,
// on the tensor cores (mma.sync m16n8k16, bf16 products, f32 sums).
//
// Replaces (JAX package) the gradient XLA derives for
// howtotrainyourmamlpytorch_tpu/ops/functional.py::_conv2d_raw :199
// (`_im2col` :85 + one GEMM over the (kh, kw, cin) patch rows, + the bias)
// with respect to w and b at compute_dtype='bfloat16', in the inner-loop
// support gradient (core/maml.py::_task_learner) and the outer backward:
// the rows conv3x3_wgrad_bf16 (pad 1) and conv3x3_p0_wgrad_bf16 (pad 0).
// They ran on an FFMA tile kernel before; wgrad at stride 2 runs
// conv3x3_wgrad_s2.cu (this design on the source's even and odd column
// planes), f32 at stride 1 the band kernel of conv3x3_bwd_s1.cu.
//
// Bound on an H100 (989 TFLOP/s dense bf16; 3.35 TB/s): the bytes, at every
// main-path shape. Per tenant M = 9 cin (tap x source channel), N = cout,
// K = the N * Ho * Wo output pixels: at mini-ImageNet stage 1 (T = 8, N =
// 25, 42 x 42 x 48 -> 48) 14.6 GFLOP against 67.7 MB of x and dy read once,
// 0.0148 ms of products against 0.0203 ms of bytes; at stage 0 (cin 3) the
// 135 MB of dy alone (0.0430 ms) and almost no products; the 64-channel
// Omniglot maps (14/7/3) are a few MB. So the design reads each byte of x
// and dy once from memory and keeps the products off FFMA:
// * A block owns one split of one tenant (grid.x, grid.z) — a run of
//   consecutive bands of CR output rows of the tenant's images — and a
//   chunk of source channels x a chunk of output channels (grid.y: one each
//   at 48 channels; at 64 two chunks of 32 source channels). It stages each
//   band's x rows with their halo (zero outside the image at pad 1; none at
//   pad 0) and its dy rows once in shared memory, by 16-byte cp.async (8
//   bf16 at a time where a row is not 16-byte aligned), into a ring of two
//   slots: the next band's copies are in flight while this band multiplies.
//   A thread stages unit tid % U (16 bytes) of every (blockDim / U)-th
//   pixel, its row and column advanced without a division.
//   Both run on the band's Wp = Wo + 2 wide grid: output pixel (r, c) is
//   q = r * Wp + c, its tap (kh, kw) is x band pixel q + kh * Wp + kw, and
//   dy's columns Wo and Wo + 1 (and the pixels past the band) are staged as
//   zeros, so the grid's extra columns add nothing to any sum.
// * The taps kernel (cin >= 4): a warp a tap (9 warps), MT m16 tiles (16
//   MT source channels) x NT n8 tiles (8 NT output channels) of
//   accumulators, K over the band's pixels in k16 steps. Both operands have
//   their channels contiguous within a pixel and K running over pixels, so
//   both come by ldmatrix.trans: A from the x band at the tap's row offset,
//   B from the dy band; no patch matrix. A pixel's channels lie on a stride
//   of KC + 8 bf16 (x) and NB (+ 8 where NT is even) bf16 (dy): an 8-pixel
//   ldmatrix row group falls in 8 distinct 16-byte bank groups.
//   At 48 channels a warp holds 3 x 6 tiles (72 f32 a thread), at 64 two
//   source chunks of 2 x 8: with the fragments and the staging that is
//   more than the 96 registers a thread that two blocks of 288 threads
//   leave (18 warps over the SM's 4 sub-partitions, which spilled), so at
//   16 tiles and more a SM takes one block, with bands of twice the rows
//   (9 at stage 1) in up to 227 KB; the smaller tiles run two blocks a SM.
// * The packed kernel (cin <= 3: mini-ImageNet stage 0 and the norm-first
//   models' stage 0 at cin 3, Omniglot layer 1 at cin 1): each pixel's 9 cin
//   patch values are packed into K = 16 or 32 rows of A, zero-padded, built
//   by a thread a pixel from the band's source rows (staged as they lie in
//   memory, by 4-byte cp.async); 8 warps split the band's k16 steps (warp
//   w takes steps w, w + 8, ...) and their tiles are summed in warp order
//   through shared memory at the end. The dy stream binds there.
// * db: a row of ones in A. In the taps kernel, after a band's products,
//   warp w < NT multiplies the band's dy fragments of n-tile w by a
//   constant A of ones (one mma a k16 step), its running sum kept in shared
//   memory between bands so that no register of the products' loop holds
//   it; the packed kernel puts the ones in the patch matrix's row 9 cin.
// * Determinism: no atomics, no TF32. Each warp sums its bands in order and
//   each band k16 step by k16 step; the packed kernel's warps are summed in
//   warp order; a block writes its split's f32 partials (T, S, 9 cin cout)
//   and (T, S, cout), and the second launch sums them in split order and
//   rounds once. A second launch gives the first launch's bits.
// * Rounding, as the FFMA tile rounded (the JAX package's cast points):
//   bf16 x and dy; every product exact in f32, every sum in f32 (the pixel
//   reduction, the warps' tiles, the split partials); dw and db rounded to
//   bf16 once, at the reduce's store. The tensor cores' f32 sums run in
//   another order than the plain twin's GEMM, so an output near a rounding
//   boundary may round to the other neighbour: within one bf16 ulp.
// * Partials are bytes too: a split writes 4 (9 cin + 1) cout bytes (83 KB
//   at 48 channels) and the reduce reads them back, so
//   the plan takes one wave of blocks (16 splits a tenant at stage 1, T =
//   8: 10.6 MB of partials against 67.7 MB of x and dy) and keeps a
//   split's partial within its share of x and dy unless a block would
//   walk more than 4 bands (kernels/conv_block.py::wgrad_plan).
// The launch plan is a pure function of the shape (wgrad_plan, kernel
// "mma"); the entry point checks its band rows, tiles, splits, threads and
// shared memory against the geometry here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_common.cuh"
#include "wgrad_reduce.cuh"

namespace maml {

constexpr int kTapWarps = 9;     // the taps kernel: a warp a tap
constexpr int kPackedWarps = 8;  // the packed kernel: warps over k16 steps
constexpr int kWgradThreads = 32 * kTapWarps;
constexpr uint32_t kOnes = 0x3F803F80u;  // two bf16 1.0

struct WgradMmaGeom {
  int N, H, W;      // x: images a tenant, rows, columns
  int Ho, Wo;       // dy
  int cin, cout;
  int org;          // the taps' origin: pad
  int Wp;           // Wo + 2: a band row's pixels
  int CR, nb;       // output rows a band, bands an image
  int SA;           // bf16 an x band (or patch) pixel: KC + 8, KC the x
                    // channels a pixel (16 MT) or the packed K
  int SD;           // bf16 a dy band pixel: NB, + 8 where NT is even
  int kpx;          // band pixels the k16 steps cover: round16(CR Wp)
  int xpx;          // x band pixels (taps): kpx + 2 Wp + 2
  int a_bytes;      // packed: the patch matrix
  int x_bytes, d_bytes;  // a slot's x band (or source rows) and dy band
  int db_at;        // taps: the db warps' running sums, past the slots
  int S, co_chunks;
  int vec_x, vec_dy;
};

__device__ __forceinline__ bf16* slot_x(unsigned char* smem,
                                        const WgradMmaGeom& g, int i) {
  return reinterpret_cast<bf16*>(smem + g.a_bytes +
                                 i * (g.x_bytes + g.d_bytes));
}

// f(p, r, c, u) for unit u < U (16 bytes, 8 bf16) of each band pixel p <
// npx, p = r * Wp + c: thread tid takes unit tid % U of pixels tid / U,
// tid / U + blockDim / U, ..., its (r, c) advanced without a division a
// pixel (U is a compile-time constant).
template <int U, typename F>
__device__ __forceinline__ void for_units(int npx, int Wp, F f) {
  const int step = blockDim.x / U;
  if ((int)threadIdx.x >= step * U) return;
  const int u = threadIdx.x % U;
  int p = threadIdx.x / U;
  int r = p / Wp;
  int c = p - r * Wp;
  const int dr = step / Wp;
  const int dc = step - dr * Wp;
  for (; p < npx; p += step) {
    f(p, r, c, u);
    c += dc;
    r += dr;
    if (c >= Wp) {
      c -= Wp;
      ++r;
    }
  }
}

// The band at output row oh0 (`rows` rows) of the image at `xi` / `dyi`
// into slot `sx` (x) and `sd` (dy), in flight (cp.async) until the caller
// waits. x: the taps kernel's band of source channels [ci0, ci0 + civ)
// (UX = KC / 8 units a pixel), pixels p < xpx of rows oh0 - org .. oh0 -
// org + rows + 1 and columns -org .. Wp - 1 - org, zero outside the image
// and past those rows; packed (UX = 0), the rows inside the image as they
// lie in memory (W x cin bf16 a row), by 4-byte cp.async where `vec_x`,
// else an element at a time. dy: output channels [co0, co0 + cov) (UD =
// NB / 8 units) of pixels p < kpx, p = r * Wp + c, zero where c >= Wo or r
// >= rows.
template <int UX, int UD>
__device__ __forceinline__ void stage_band(bf16* sx, bf16* sd, const bf16* xi,
                                           const bf16* dyi,
                                           const WgradMmaGeom& g, int oh0,
                                           int rows, int ci0, int civ,
                                           int co0, int cov) {
  if constexpr (UX == 0) {
    const int tid = threadIdx.x;
    const int ih_lo = max(0, oh0 - g.org);
    const int ih_hi = min(g.H, oh0 - g.org + g.CR + 2);
    const int n = (ih_hi - ih_lo) * g.W * g.cin;
    const bf16* from = xi + (size_t)ih_lo * g.W * g.cin;
    if (g.vec_x) {
      for (int e = tid; e < n / 2; e += blockDim.x)
        cp_async4(sx + 2 * e, from + 2 * e);
    } else {
      for (int e = tid; e < n; e += blockDim.x) sx[e] = from[e];
    }
  } else {
    for_units<UX>(g.xpx, g.Wp, [&](int p, int r, int c, int u) {
      const int ih = oh0 - g.org + r;
      const int iw = c - g.org;
      bf16* dst = sx + p * g.SA + 8 * u;
      if (r < rows + 2 && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
        stage8(dst, xi + ((size_t)ih * g.W + iw) * g.cin + ci0 + 8 * u,
               min(8, civ - 8 * u), g.vec_x != 0);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    });
  }
  for_units<UD>(g.kpx, g.Wp, [&](int p, int r, int c, int u) {
    bf16* dst = sd + p * g.SD + 8 * u;
    if (r < rows && c < g.Wo)
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
struct Place {
  int t, split, cic, ci0, civ, co0, cov;
};
template <int CIB, int NB>
__device__ __forceinline__ Place place(const WgradMmaGeom& g) {
  Place p;
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
__device__ __forceinline__ int split_edge(const WgradMmaGeom& g, int split) {
  return (int)((long long)g.N * g.nb * split / g.S);
}

// Band `band` of the block's tenant (image band / nb) into slot i.
template <int UX, int UD>
__device__ __forceinline__ void stage_at(unsigned char* smem,
                                         const WgradMmaGeom& g,
                                         const Place& p, const bf16* x,
                                         const bf16* dy, int band, int i) {
  const int img = band / g.nb;
  const int oh0 = (band - img * g.nb) * g.CR;
  bf16* sx = slot_x(smem, g, i);
  stage_band<UX, UD>(
      sx, sx + g.x_bytes / 2,
      x + ((size_t)p.t * g.N + img) * g.H * g.W * g.cin,
      dy + ((size_t)p.t * g.N + img) * g.Ho * g.Wo * g.cout, g, oh0,
      min(g.CR, g.Ho - oh0), p.ci0, p.civ, p.co0, p.cov);
}

// The two-slot ring, before band `band` multiplies from slot `cur`: the
// next band's copies issued into the other slot, this band's awaited, then
// a barrier. (The block stages its first band before its loop; each
// band's products end at a barrier, so the slot the next copies overwrite
// is free.)
template <int UX, int UD>
__device__ __forceinline__ void ring_next(unsigned char* smem,
                                          const WgradMmaGeom& g,
                                          const Place& p, const bf16* x,
                                          const bf16* dy, int band, int last,
                                          int cur) {
  if (band + 1 < last) {
    stage_at<UX, UD>(smem, g, p, x, dy, band + 1, cur ^ 1);
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
// At MT x NT >= 16 tiles (48 and 64 channels) one block a SM, whose 288
// threads may then hold more than the 96 registers of two; else two.
template <int MT, int NT>
__global__ void __launch_bounds__(kWgradThreads, MT * NT >= 16 ? 1 : 2)
conv3x3_wgrad_mma_kernel(const bf16* __restrict__ x,
                         const bf16* __restrict__ dy,
                         float* __restrict__ part_w,
                         float* __restrict__ part_b, WgradMmaGeom g) {
  constexpr int CIB = 16 * MT;
  constexpr int NB = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t ones[4] = {kOnes, kOnes, kOnes, kOnes};
  const Place p = place<CIB, NB>(g);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool db_warp = p.cic == 0 && warp < NT;

  // the lanes' ldmatrix.trans row addresses (bytes into a slot): A, 8
  // pixels (lane & 7) + 8 (lane / 16) of the k16 step at the tap's offset,
  // channels 8 ((lane / 8) & 1); B, pixels (lane & 15), channels 8 (lane /
  // 16)
  const int kh = warp / 3;
  const int shift = kh * g.Wp + warp - 3 * kh;
  const uint32_t a_lane =
      2u * ((((lane & 7) + ((lane >> 4) << 3)) + shift) * g.SA +
            ((lane >> 3) & 1) * 8);
  const uint32_t b_lane =
      (uint32_t)g.x_bytes + 2u * ((lane & 15) * g.SD + (lane >> 4) * 8);
  const uint32_t a_k16 = 2u * 16 * g.SA;
  const uint32_t b_k16 = 2u * 16 * g.SD;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  // warp w < NT's db: the C fragment of a ones A times n-tile w of dy
  // (every row the same sum), a lane's 4 f32 kept between bands
  float* dbs = reinterpret_cast<float*>(smem + g.db_at) + 4 * threadIdx.x;
  if (db_warp)
#pragma unroll
    for (int i = 0; i < 4; ++i) dbs[i] = 0.f;

  const int first = split_edge(g, p.split);
  const int last = split_edge(g, p.split + 1);
  stage_at<2 * MT, NT>(smem, g, p, x, dy, first, 0);
  cp_async_commit();
  int cur = 0;
  for (int band = first; band < last; ++band, cur ^= 1) {
    ring_next<2 * MT, NT>(smem, g, p, x, dy, band, last, cur);
    const int img = band / g.nb;
    const int rows = min(g.CR, g.Ho - (band - img * g.nb) * g.CR);
    const uint32_t base = smem_addr(slot_x(smem, g, cur));
    uint32_t a_addr = base + a_lane;
    uint32_t b_addr = base + b_lane;
    const int steps = (rows * g.Wp + 15) >> 4;
#pragma unroll 1
    for (int ks = 0; ks < steps; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldsm_x4_t(a[mt], a_addr + 32u * mt);
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
      a_addr += a_k16;
      b_addr += b_k16;
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
// Each band: a thread a pixel q < kpx of the band's grid builds its patch
// row from the staged source rows — column k = (3 kh + kw) CIN + ci, the
// x value of tap (kh, kw) (zero outside the image), 1 at k = 9 CIN (db), 0
// past it — then warp w multiplies the band's k16 steps w, w + 8, ...; lane
// (g8, t4) holds acc[mt][nt][i] of row 16 mt + g8 + 8 (i / 2) and column 8
// nt + 2 t4 + i % 2. At the end the warps' tiles are summed in warp order.
template <int CIN, int NT>
__global__ void __launch_bounds__(kWgradThreads, 2)
conv3x3_wgrad_mma_packed_kernel(const bf16* __restrict__ x,
                                const bf16* __restrict__ dy,
                                float* __restrict__ part_w,
                                float* __restrict__ part_b, WgradMmaGeom g) {
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

  const Place p = place<CIN, NB>(g);
  const int first = split_edge(g, p.split);
  const int last = split_edge(g, p.split + 1);
  stage_at<0, NT>(smem, g, p, x, dy, first, 0);
  cp_async_commit();
  int cur = 0;
  for (int band = first; band < last; ++band, cur ^= 1) {
    ring_next<0, NT>(smem, g, p, x, dy, band, last, cur);
    const int img = band / g.nb;
    const int oh0 = (band - img * g.nb) * g.CR;
    const int rows = min(g.CR, g.Ho - oh0);
    const bf16* raw = slot_x(smem, g, cur);
    const int ih_lo = max(0, oh0 - g.org);
    const int rows_in = min(g.H, oh0 - g.org + g.CR + 2) - ih_lo;
    for (int q = tid; q < g.kpx; q += blockDim.x) {
      const int r = q / g.Wp;
      const int rr = oh0 - g.org + r - ih_lo;  // the raw row of kh = 0
      const int iw = q - r * g.Wp - g.org;     // the column of kw = 0
      __align__(16) bf16 v[KP];
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const bool row = (unsigned)(rr + kh) < (unsigned)rows_in;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const bool ok = row && (unsigned)(iw + kw) < (unsigned)g.W;
          const bf16* p = raw + ((rr + kh) * g.W + iw + kw) * CIN;
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci)
            v[(3 * kh + kw) * CIN + ci] = ok ? p[ci] : __float2bfloat16_rn(0.f);
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
    const uint32_t b_base = smem_addr(slot_x(smem, g, cur)) + b_lane;
    const int steps = (rows * g.Wp + 15) >> 4;
#pragma unroll 1
    for (int ks = warp; ks < steps; ks += kPackedWarps) {
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
    for (int w = 0; w < kPackedWarps; ++w) sum += tile[(w * KP + m) * NB + n];
    if (m < 9 * CIN)
      pw[(size_t)m * g.cout + n] = sum;
    else
      pb[n] = sum;
  }
}

inline int round16(int a) { return (a + 15) & ~15; }

// The geometry of the plan (kernels/conv_block.py::wgrad_plan, kernel
// "mma") at this shape; false where the shape or the plan's `band_rows`,
// `m_tiles` (MT), `channels` (NB), `splits`, `threads` and `smem` do not
// match it.
bool wgrad_mma_geom(WgradMmaGeom& g, int T, int N, int H, int W, int pad,
                    int cin, int cout, int band_rows, int m_tiles,
                    int channels, int splits, int threads, int smem) {
  if ((pad != 0 && pad != 1) || T < 1 || T > 65535 || N < 1 || cin < 1 ||
      cout < 1 || band_rows < 1 || channels % 8 || channels < 8 ||
      channels > 64)
    return false;
  g.N = N, g.H = H, g.W = W, g.cin = cin, g.cout = cout, g.org = pad;
  g.Ho = H + 2 * pad - 2, g.Wo = W + 2 * pad - 2;
  if (g.Ho < 1 || g.Wo < 1 || band_rows > g.Ho) return false;
  const int NT = channels / 8;
  g.Wp = g.Wo + 2;
  g.CR = band_rows;
  g.nb = cdiv(g.Ho, band_rows);
  const bool packed = cin <= 3;
  const int KC = packed ? round16(9 * cin + 1) : 16 * m_tiles;
  if (m_tiles != KC / 16 || m_tiles < 1 || m_tiles > 4) return false;
  g.SA = KC + 8;
  g.SD = NT % 2 ? channels : channels + 8;
  g.kpx = round16(band_rows * g.Wp);
  g.xpx = g.kpx + 2 * g.Wp + 2;
  // packed: the band's source rows, an even number of bf16
  const int raw_elems = ((band_rows + 2) * W * cin + 1) & ~1;
  g.a_bytes = packed ? round16(2 * g.kpx * g.SA) : 0;
  g.x_bytes = packed ? round16(2 * raw_elems) : round16(2 * g.xpx * g.SA);
  g.d_bytes = round16(2 * g.kpx * g.SD);
  g.S = splits;
  g.co_chunks = cdiv(cout, channels);
  g.db_at = g.a_bytes + 2 * (g.x_bytes + g.d_bytes);
  const int ring = g.db_at + (packed ? 0 : 4 * 4 * 32 * NT);
  const int tree = packed ? 4 * kPackedWarps * KC * channels : 0;
  const int want = ring > tree ? ring : tree;
  const int ci_chunks = packed ? 1 : cdiv(cin, 16 * m_tiles);
  return splits >= 1 && splits <= N * g.nb && splits <= 65535 &&
         (long long)ci_chunks * g.co_chunks <= 65535 &&
         threads == 32 * (packed ? kPackedWarps : kTapWarps) &&
         smem == want && smem <= kMaxSmem &&
         (long long)N * H * W * cin < (1ll << 31) &&
         (long long)N * g.Ho * g.Wo * cout < (1ll << 31);
}

template <typename K>
cudaError_t launch_wgrad_mma(K kernel, bool* done, const bf16* x,
                             const bf16* dy, float* part_w, float* part_b,
                             const WgradMmaGeom& g, dim3 grid, int threads,
                             int smem, cudaStream_t st) {
  cudaError_t err = allow_smem(kernel, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(x, dy, part_w, part_b, g);
  return cudaGetLastError();
}

template <int MT, int NT>
cudaError_t launch_taps(const bf16* x, const bf16* dy, float* part_w,
                        float* part_b, const WgradMmaGeom& g, dim3 grid,
                        int threads, int smem, cudaStream_t st) {
  static bool done[64] = {};
  return launch_wgrad_mma(conv3x3_wgrad_mma_kernel<MT, NT>, done, x, dy,
                          part_w, part_b, g, grid, threads, smem, st);
}

template <int CIN, int NT>
cudaError_t launch_packed(const bf16* x, const bf16* dy, float* part_w,
                          float* part_b, const WgradMmaGeom& g, dim3 grid,
                          int threads, int smem, cudaStream_t st) {
  static bool done[64] = {};
  return launch_wgrad_mma(conv3x3_wgrad_mma_packed_kernel<CIN, NT>, done, x,
                          dy, part_w, part_b, g, grid, threads, smem, st);
}

using LaunchFn = cudaError_t (*)(const bf16*, const bf16*, float*, float*,
                                 const WgradMmaGeom&, dim3, int, int,
                                 cudaStream_t);

// The instantiations: NT in {1, 2, 4, 6, 8}; the taps kernel at MT <= 4 and
// MT x NT <= 18 tiles a warp (the plan's rule), the packed kernel at cin 1,
// 2 and 3.
LaunchFn wgrad_mma_launcher(int cin, int MT, int NT) {
#define MAML_TAPS(m, n) \
  if (cin > 3 && MT == m && NT == n) return launch_taps<m, n>;
#define MAML_PACKED(c, n) \
  if (cin == c && NT == n) return launch_packed<c, n>;
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

// dw (T, 3, 3, cin, cout) and db (T, cout) of the stride-1 conv at `pad` (1
// or 0) from x (T, N, H, W, cin) and dy (T, N, Ho, Wo, cout), Ho = H + 2*pad
// - 2 (Wo likewise), all bf16; part_w (T, splits, 9*cin*cout) and part_b
// (T, splits, cout) f32 scratch. The arguments come packed (wgrad_reduce.cuh:
// WgradCall); the plan (kernels/conv_block.py::wgrad_plan, kernel "mma"):
// `band_rows`, `m_tiles` (source channels a block: 16 m_tiles; packed at
// cin <= 3, the packed K / 16), `channels` of cout a block, `splits` a
// tenant, `threads`, `smem`, checked here against the geometry they follow
// from. Two launches on the stream (the products, the reduce); returns the
// first CUDA error, 0 on success.
int conv3x3_wgrad_mma(const long long* a) {
  using namespace maml;
  const WgradCall c = unpack_wgrad(a);
  const int T = c.T, N = c.N, H = c.H, W = c.W, cin = c.cin, cout = c.cout,
            m_tiles = c.m_tiles, channels = c.channels, splits = c.splits,
            threads = c.threads, smem = c.smem;
  const bf16* x = static_cast<const bf16*>(c.x);
  const bf16* dy = static_cast<const bf16*>(c.dy);
  WgradMmaGeom g;
  if (!wgrad_mma_geom(g, T, N, H, W, c.pad, cin, cout, c.band_rows, m_tiles,
                      channels, splits, threads, smem))
    return (int)cudaErrorInvalidValue;
  const LaunchFn launch = wgrad_mma_launcher(cin, m_tiles, channels / 8);
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  const WgradDevice on(c.device);
  if (on.err != cudaSuccess) return (int)on.err;
  const bool packed = cin <= 3;
  g.vec_x = packed ? (W * cin) % 2 == 0 &&
                           (reinterpret_cast<unsigned long long>(x) & 3) == 0
                     : cin % 8 == 0 && aligned16(x);
  g.vec_dy = cout % 8 == 0 && aligned16(dy);
  const int ci_chunks = packed ? 1 : cdiv(cin, 16 * m_tiles);
  cudaError_t err = launch(x, dy, c.part_w, c.part_b, g,
                           dim3(splits, ci_chunks * g.co_chunks, T), threads,
                           smem, c.stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wgrad_reduce<bf16>(
      c.part_w, c.part_b, static_cast<bf16*>(c.dw), static_cast<bf16*>(c.db),
      T, splits, 9 * cin * cout, cout, c.stream);
}

}  // extern "C"
