// K3 and K5 pooled: the backward of batch norm + leaky-ReLU + 2x2 max pool
// through the batch statistics (bn_act_pool_bwd_f32, and in bf16
// bn_act_pool_bwd_bf16) and the derivative of that backward
// (bn_act_pool_bwd_bwd_f32, bn_act_pool_bwd_bwd_bf16), each one
// cooperative launch.
//
// Replaces (JAX package) howtotrainyourmamlpytorch_tpu/ops/functional.py:
// the gradient XLA derives for the normalize/affine tail of `batch_norm`
// :368, `leaky_relu` :363 and `max_pool2d` :325 (VALID: an odd map's last
// row and column are dropped) inside `conv_bn_act` :249 (K3, in f32 and at
// compute_dtype='bfloat16'), and the derivative of that gradient, which
// second-order MAML takes through the inner loop (core/maml.py
// ::_task_learner; K5, in both dtypes). The pool-free K3 and K5 run
// bn_act_bwd.cu.
//
// The arithmetic is the twins' (ops/functional.py::bn_act_pool_bwd,
// ::bn_act_pool_bwd_bwd; ::bn_act_bwd_bwd derives K5's formulas).
// With xhat = (y - mean) * rstd, z = xhat * gamma + beta (one FMA) and dz
// the pooled gradient at each window's argmax through the leaky slope (0
// at every other position, the dropped row and column included), per
// (tenant, channel) over the m = N * H * W positions:
//   K3: dbeta = sum dz, dgamma = sum dz xhat,
//       dy = gamma rstd (dz - dbeta / m - xhat dgamma / m);
//   K5: from the cotangents a (of dy), ggamma and gbeta, the five sums
//       sum a, a xhat, dz, dz xhat, a dz, then g_dpooled (at the argmax),
//       g_y (every position) and g_gamma.
// bf16 K3 and K5 round at the twins' cast points: the masks are K2's
// decisions (z by the bf16 chain of bn_act_chain.cuh at the argmax, so no
// sign K2 took flips), xhat and the sums in f32 from the bf16 inputs, and
// each output (dy, dgamma, dbeta; g_dpooled, g_y, g_gamma) rounded once to
// bf16 (within one bf16 ulp of the twin, whose sums run in another order).
// The bf16 K5 is the f32 K5's body on bf16 loads, 4 channels a thread (one
// 8-byte load): its 20 sums a thread fit the f32 K5's register budget,
// where 8 channels (the bf16 K3's) would hold 40.
//
// Bound on an H100: bytes (3.35 TB/s; a few FLOPs an element, no tensor
// cores). K3 must read y, the pooled gradient and its 1-byte argmax and
// write dy; K5 reads a and y, the pooled gradient and argmax, and writes
// g_y and g_dpooled. The sums need every position before any output, so
// the design reads y (and a) twice: once to reduce, once to apply.
//
// * One launch (cudaLaunchCooperativeKernel): every block reduces its
//   chunk into partial sums, a grid barrier, one warp per (tenant, sum,
//   channel) column merges the blocks' partials, a second barrier, and
//   every block applies the merged sums to its chunk; the block that owns
//   a tenant's first chunk writes dgamma and dbeta (K3) or g_gamma (K5).
//   Two plain launches (reduce; then merge and apply) measured slower at
//   every large map on an H100 (PERF.md §6), so the one launch stays.
// * The plan (kernels/conv_block.py::bn_bwd_plan, a pure function of the
//   shape, the dtype and the blocks a SM the occupancy query reports):
//   each tenant's map cut into windows of 2 x 2 positions (an odd map's
//   last row or column into windows of one row or column, which no pooled
//   element reads), the windows into chunks of whole windows over as many
//   blocks as the card holds at once; no chunk spans two tenants. A block
//   is 256 threads: `slots` windows at a time x G channel groups, a group
//   one load of a position (4 f32 channels, 16 bytes; the bf16 K3 8 bf16,
//   16 bytes; the bf16 K5 4 bf16, 8 bytes: G = ceil(C / 4) or ceil(C /
//   8)); a thread keeps its group, so its sums are scalars in registers
//   (C = 48 and 64 take 252 and 256 of the threads).
// * A thread loads a window's pooled gradient, argmax (a byte a channel)
//   and its positions of y (and a) as one vector each, and writes dy (g_y)
//   the same way and g_dpooled as one vector; one value (byte) at a time
//   where the channels are not a whole number of vectors or a tensor is
//   not aligned (kVec false).
// * Deterministic, no atomics: a thread sums its windows in order, a block
//   its slots in order (shared memory), a warp a column's partials over
//   lane-strided blocks and then a shuffle tree; the order is the plan's,
//   so a second launch gives the first launch's bits.
// * The apply pass walks each chunk backwards, so that the windows the
//   reduce pass read last are still in L2; it loads with evict-first hints
//   and stores with streaming stores.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn_act_chain.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // a block
constexpr int kMaxC = 64;      // the channels the kernels take
constexpr unsigned kNoArg = 0xffffffffu;  // 4 argmax bytes: no window

using bf16_t = __nv_bfloat16;

// The tensors of K3 and K5 (f32, or bf16 in the K5 of bwd_body): y, a, dp,
// the (T, C) tables, out and gdp of the body's element type.
struct BwdArgs {
  const void* y;
  const void* a;        // K5: the cotangent of K3's dy
  const void* dp;       // the pooled gradient
  const uint8_t* arg;   // its window argmax, 2 * dh + dw
  const void* mean;
  const void* rstd;
  const void* gamma;
  const void* beta;
  const void* ggamma;   // K5: the cotangents of K3's dgamma and dbeta
  const void* gbeta;
  void* out;            // K3: dy; K5: g_y
  void* gdp;            // K5: g_dpooled
  void* vec0;           // K3: dgamma; K5: g_gamma
  void* vec1;           // K3: dbeta
  float* part;          // (T, sums, C, blocks): the blocks' partial sums
  float* tot;           // (T, sums, C): the merged sums
  int N, H, W, C, G, Ho, Wo, Hc, Wc, windows, slots, chunk, blocks;
  float slope, inv_m;
};

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_comp(float4& v, int j, float x) {
  if (j == 0) v.x = x;
  else if (j == 1) v.y = x;
  else if (j == 2) v.z = x;
  else v.w = x;
}

// channel j of the window position k (0-3; by selects, not an indexed
// load, so the window stays in registers)
__device__ __forceinline__ float pick(const float4 (&v)[4], int k, int j) {
  const float p0 = comp(v[0], j), p1 = comp(v[1], j), p2 = comp(v[2], j),
              p3 = comp(v[3], j);
  return k == 0 ? p0 : k == 1 ? p1 : k == 2 ? p2 : p3;
}

// 4 channels from p as f32 (n of them where !kVec, zeros past them): one
// 16-byte load of f32 or one 8-byte load of bf16; kLast: the pass's last
// read of the data, with an evict-first hint
template <bool kVec, bool kLast>
__device__ __forceinline__ float4 load4(const float* p, int n) {
  if (kVec) {
    const float4* q = reinterpret_cast<const float4*>(p);
    return kLast ? __ldcs(q) : __ldg(q);
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n) set_comp(v, j, kLast ? __ldcs(p + j) : __ldg(p + j));
  return v;
}

template <bool kVec, bool kLast>
__device__ __forceinline__ float4 load4(const bf16_t* p, int n) {
  unsigned w[2] = {0u, 0u};
  if (kVec) {
    const uint2* q = reinterpret_cast<const uint2*>(p);
    const uint2 v = kLast ? __ldcs(q) : __ldg(q);
    w[0] = v.x, w[1] = v.y;
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) {
        const unsigned b = kLast ? __ldcs(q + j) : __ldg(q + j);
        w[j >> 1] |= b << (16 * (j & 1));
      }
  }
  return make_float4(__uint_as_float(w[0] << 16),
                     __uint_as_float(w[0] & 0xffff0000u),
                     __uint_as_float(w[1] << 16),
                     __uint_as_float(w[1] & 0xffff0000u));
}

template <bool kVec, bool kLast>
__device__ __forceinline__ unsigned load_arg(const uint8_t* p, int n) {
  if (kVec) {
    const unsigned* q = reinterpret_cast<const unsigned*>(p);
    return kLast ? __ldcs(q) : __ldg(q);
  }
  unsigned k = kNoArg;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n) {
      const unsigned b = kLast ? __ldcs(p + j) : __ldg(p + j);
      k = (k & ~(0xffu << (8 * j))) | (b << (8 * j));
    }
  return k;
}

// 4 channels stored (n of them where !kVec), streaming; bf16 each rounded
// once
template <bool kVec>
__device__ __forceinline__ void store4(float* p, const float4& v, int n) {
  if (kVec) {
    __stcs(reinterpret_cast<float4*>(p), v);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n) __stcs(p + j, comp(v, j));
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <bool kVec>
__device__ __forceinline__ void store4(bf16_t* p, const float4& v, int n) {
  if (kVec) {
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16),
                      bf16_bits(v.z) | (bf16_bits(v.w) << 16)));
    return;
  }
  unsigned short* q = reinterpret_cast<unsigned short*>(p);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < n) __stcs(q + j, (unsigned short)bf16_bits(comp(v, j)));
}

// one value of a (T, C) table as f32, and one stored (bf16 rounded once)
__device__ __forceinline__ float value(const float* p) { return *p; }
__device__ __forceinline__ float value(const bf16_t* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16_t* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// z, the leaky-ReLU's side, as K2 decides it: f32 one FMA on xhat; bf16
// the chain of bn_act_chain.cuh, every op rounded to bf16
template <typename T>
__device__ __forceinline__ float side(float v, float m, float r, float g,
                                      float b) {
  if constexpr (sizeof(T) == 4)
    return maml::bn_z(maml::bn_xhat(v, m, r), g, b);
  else
    return maml::bn_z_bf16(v, m, r, g, b);
}

// Window i of a tenant: the offset (in pixels) of its top-left position,
// whether it has a second row and column, and the offset of its pooled
// element (-1: a window of the dropped row or column).
template <typename A>
__device__ __forceinline__ void window(const A& p, int i, int& pix, bool& h1,
                                       bool& w1, int& poff) {
  const int per_image = p.Hc * p.Wc;
  const int n = i / per_image, r = i - n * per_image;
  const int hw = r / p.Wc, ww = r - hw * p.Wc;
  pix = (n * p.H + 2 * hw) * p.W + 2 * ww;
  h1 = 2 * hw + 1 < p.H;
  w1 = 2 * ww + 1 < p.W;
  poff = h1 && w1 ? (n * p.Ho + hw) * p.Wo + ww : -1;
}

// Lane 0's sum of col[0..count): lane l sums entries l, l + 32, ... in
// order, then a shuffle tree of strides 16, 8, 4, 2, 1. The partials were
// written by other blocks: loaded past L1.
__device__ __forceinline__ float merge(const float* col, int count,
                                       int lane) {
  float s = 0.f;
  for (int b = lane; b < count; b += 32) s += __ldcg(col + b);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_down_sync(~0u, s, off);
  return s;
}

// The whole call: reduce, grid barrier, merge, barrier, apply; T the
// element type (K3 f32 only: its bf16 form is bwd_body_bf16 below), a
// thread 4 channels of it.
template <typename T, int kS, bool kVec>
__device__ __forceinline__ void bwd_body(const BwdArgs& p) {
  constexpr bool kK5 = kS == 5;
  // the per-channel values of the apply pass, in shared memory: K3's mean,
  // rstd, gamma, beta, gamma * rstd, mean(dz), mean(dz xhat); K5's mean,
  // rstd, gamma, beta, ggamma, gbeta, mean(a), mean(a xhat), mean(dz
  // xhat), gamma * rstd, mean(G), mean(G xhat), the rstd term
  constexpr int kN = kK5 ? 13 : 7;
  __shared__ __align__(16) float red[kS * 4 * kThreads];
  __shared__ float sums[kS * kMaxC];
  __shared__ __align__(16) float cst[kN * kMaxC];

  const int t = blockIdx.y, tid = threadIdx.x;
  const int CP = 4 * p.G;  // C rounded up to the groups
  const int slot = tid / p.G, c0 = 4 * (tid - slot * p.G);
  const bool active = slot < p.slots;
  const int nc = min(4, p.C - c0);
  const size_t img = (size_t)t * p.N * p.H * p.W * p.C + c0;
  const size_t pooled = (size_t)t * p.N * p.Ho * p.Wo * p.C + c0;
  const T* y = static_cast<const T*>(p.y) + img;
  const T* a = kK5 ? static_cast<const T*>(p.a) + img : nullptr;
  const T* dp = static_cast<const T*>(p.dp) + pooled;
  const uint8_t* arg = p.arg + pooled;
  const int first = blockIdx.x * p.chunk;
  const int last = min(first + p.chunk, p.windows);
  const float slope = p.slope;

  // -- reduce: this thread's windows, in order ------------------------
  float acc[kS][4];
#pragma unroll
  for (int k = 0; k < kS; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[k][j] = 0.f;
  if (active) {
    const int tc = t * p.C + c0;
    const float4 mu = load4<kVec, false>(static_cast<const T*>(p.mean) + tc,
                                         nc);
    const float4 rs = load4<kVec, false>(static_cast<const T*>(p.rstd) + tc,
                                         nc);
    const float4 ga =
        load4<kVec, false>(static_cast<const T*>(p.gamma) + tc, nc);
    const float4 be = load4<kVec, false>(static_cast<const T*>(p.beta) + tc,
                                         nc);
    for (int i = first + slot; i < last; i += p.slots) {
      int pix, poff;
      bool h1, w1;
      window(p, i, pix, h1, w1, poff);
      if (!kK5 && poff < 0) continue;  // no dz in the window
      float4 yv[4], av[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = (!(q >> 1) || h1) && (!(q & 1) || w1);
        const int off = (pix + (q >> 1) * p.W + (q & 1)) * p.C;
        yv[q] = ok ? load4<kVec, false>(y + off, nc)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (kK5)
          av[q] = ok ? load4<kVec, false>(a + off, nc)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
      unsigned ks = kNoArg;
      if (poff >= 0) {
        d = load4<kVec, false>(dp + (size_t)poff * p.C, nc);
        ks = load_arg<kVec, false>(arg + (size_t)poff * p.C, nc);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float m = comp(mu, j), r = comp(rs, j);
        if constexpr (kK5) {
          // every position of the window; a missing one holds a = 0
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float x = maml::bn_xhat(comp(yv[q], j), m, r);
            acc[0][j] += comp(av[q], j);
            acc[1][j] = fmaf(comp(av[q], j), x, acc[1][j]);
          }
        }
        const int k = (ks >> (8 * j)) & 0xff;
        if (k < 4) {  // the argmax of a pooled window
          const float v = pick(yv, k, j);
          const float x = maml::bn_xhat(v, m, r);
          const float z = side<T>(v, m, r, comp(ga, j), comp(be, j));
          const float dz = z >= 0.f ? comp(d, j) : comp(d, j) * slope;
          constexpr int o = kK5 ? 2 : 0;
          acc[o][j] += dz;
          acc[o + 1][j] = fmaf(dz, x, acc[o + 1][j]);
          if constexpr (kK5)
            acc[4][j] = fmaf(pick(av, k, j), dz, acc[4][j]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kS; ++k)
      *reinterpret_cast<float4*>(&red[(slot * kS + k) * CP + c0]) =
          make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
  }
  __syncthreads();
  // the block's partials: its slots in order
  for (int col = tid; col < kS * p.C; col += kThreads) {
    const int k = col / p.C, c = col - k * p.C;
    float s = 0.f;
    for (int sl = 0; sl < p.slots; ++sl) s += red[(sl * kS + k) * CP + c];
    p.part[((size_t)(t * kS + k) * p.C + c) * p.blocks + blockIdx.x] = s;
  }
  // -- merge: every tenant's partials, one warp a column --------------
  const int lane = tid & 31, warps = kThreads / 32;
  cg::grid_group grid = cg::this_grid();
  grid.sync();
  const int cols = gridDim.y * kS * p.C;
  const int nwarps = gridDim.x * gridDim.y * warps;
  for (int col = (blockIdx.y * gridDim.x + blockIdx.x) * warps + (tid >> 5);
       col < cols; col += nwarps) {
    const float s = merge(p.part + (size_t)col * p.blocks, p.blocks, lane);
    if (lane == 0) p.tot[col] = s;
  }
  grid.sync();
  for (int col = tid; col < kS * p.C; col += kThreads)
    sums[col] = __ldcg(p.tot + (size_t)t * kS * p.C + col);
  __syncthreads();
  // -- the per-channel values; the first chunk's block writes the
  // (T, C) outputs (in T: bf16 rounded once) ---------------------------
  const float inv_m = p.inv_m;
  T* vec0 = static_cast<T*>(p.vec0);
  for (int c = tid; c < CP; c += kThreads) {
    float v[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = 0.f;  // channels past C
    if (c < p.C) {
      const int tc = t * p.C + c;
      const float m = value(static_cast<const T*>(p.mean) + tc);
      const float r = value(static_cast<const T*>(p.rstd) + tc);
      const float g = value(static_cast<const T*>(p.gamma) + tc);
      v[0] = m, v[1] = r, v[2] = g;
      v[3] = value(static_cast<const T*>(p.beta) + tc);
      if constexpr (!kK5) {
        const float s_dz = sums[c], s_dzx = sums[p.C + c];
        v[4] = g * r;
        v[5] = s_dz * inv_m;
        v[6] = s_dzx * inv_m;
        if (blockIdx.x == 0) {
          put(vec0 + tc, s_dzx);
          put(static_cast<T*>(p.vec1) + tc, s_dz);
        }
      } else {
        const float gg = value(static_cast<const T*>(p.ggamma) + tc);
        const float s_a = sums[c], s_ax = sums[p.C + c];
        const float s_dz = sums[2 * p.C + c], s_dzx = sums[3 * p.C + c];
        const float s_adz = sums[4 * p.C + c];
        const float m_a = s_a * inv_m, m_ax = s_ax * inv_m;
        const float m_dz = s_dz * inv_m, m_dzx = s_dzx * inv_m;
        // S_adz - m mean(a) mean(dz) - m mean(a xhat) mean(dz xhat)
        const float cross = s_adz - (m_a * s_dz + m_ax * s_dzx);
        const float grs = g * r;
        v[4] = gg;
        v[5] = value(static_cast<const T*>(p.gbeta) + tc);
        v[6] = m_a;
        v[7] = m_ax;
        v[8] = m_dzx;
        v[9] = grs;
        v[10] = -grs * (m_dzx * m_a + m_ax * m_dz) + gg * m_dz;
        v[11] = -2.0f * grs * m_ax * m_dzx + gg * m_dzx;
        v[12] = r * r * inv_m * g * cross;
        if (blockIdx.x == 0) put(vec0 + tc, r * cross);
      }
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) cst[k * CP + c] = v[k];
  }
  __syncthreads();
  if (!active) return;

  // -- apply: this thread's windows, last first -------------------------
  T* out = static_cast<T*>(p.out) + img;
  T* gdp = kK5 ? static_cast<T*>(p.gdp) + pooled : nullptr;
  const int mine = last - first - slot;
  if (mine <= 0) return;
  for (int i = first + slot + (mine - 1) / p.slots * p.slots; i >= first;
       i -= p.slots) {
    int pix, poff;
    bool h1, w1;
    window(p, i, pix, h1, w1, poff);
    float4 yv[4], av[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool ok = (!(q >> 1) || h1) && (!(q & 1) || w1);
      const int off = (pix + (q >> 1) * p.W + (q & 1)) * p.C;
      yv[q] = ok ? load4<kVec, true>(y + off, nc)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kK5)
        av[q] = ok ? load4<kVec, true>(a + off, nc)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
    unsigned ks = kNoArg;
    if (poff >= 0) {
      d = load4<kVec, true>(dp + (size_t)poff * p.C, nc);
      ks = load_arg<kVec, true>(arg + (size_t)poff * p.C, nc);
    }
    float4 c4[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k)
      c4[k] = *reinterpret_cast<const float4*>(&cst[k * CP + c0]);
    float4 o[4], gd = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float m = comp(c4[0], j), r = comp(c4[1], j);
      const float g = comp(c4[2], j), b = comp(c4[3], j);
      const int k = (ks >> (8 * j)) & 0xff;
      const float dj = comp(d, j);
      // the side at the argmax, where dz lives (K2's decision)
      bool pos = false;
      float dzk = 0.f;
      if (k < 4) {
        pos = side<T>(pick(yv, k, j), m, r, g, b) >= 0.f;
        dzk = pos ? dj : dj * slope;
      }
      if constexpr (!kK5) {
        const float grs = comp(c4[4], j), mdz = comp(c4[5], j),
                    mdzx = comp(c4[6], j);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float x = maml::bn_xhat(comp(yv[q], j), m, r);
          const float dz = k == q ? dzk : 0.f;
          set_comp(o[q], j, grs * (dz - mdz - x * mdzx));
        }
      } else {
        const float gg = comp(c4[4], j), gb = comp(c4[5], j);
        const float m_a = comp(c4[6], j), m_ax = comp(c4[7], j);
        const float m_dzx = comp(c4[8], j), grs = comp(c4[9], j);
        const float mean_g = comp(c4[10], j), mean_gx = comp(c4[11], j);
        const float lr = comp(c4[12], j);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float av_q = comp(av[q], j);
          const float x = maml::bn_xhat(comp(yv[q], j), m, r);
          const float dz = k == q ? dzk : 0.f;
          // g_y: the batch-norm backward of G, plus the rstd term
          const float big_g = -grs * (m_dzx * av_q + m_ax * dz) + gg * dz;
          set_comp(o[q], j, r * (big_g - mean_g - x * mean_gx) - x * lr);
          if (k == q) {  // g_dpooled: the slope-masked g_dz at the argmax
            const float gdz = grs * (av_q - m_a - x * m_ax) + gg * x + gb;
            set_comp(gd, j, pos ? gdz : gdz * slope);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool ok = (!(q >> 1) || h1) && (!(q & 1) || w1);
      if (ok)
        store4<kVec>(out + (pix + (q >> 1) * p.W + (q & 1)) * p.C, o[q],
                     nc);
    }
    if (kK5 && poff >= 0) store4<kVec>(gdp + (size_t)poff * p.C, gd, nc);
  }
}

// two blocks a SM at least (at most 128 registers a thread), so that the
// large-batch config's 256 tenants fit the card at a block a tenant
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    bn_act_pool_bwd_kernel(const BwdArgs p) {
  bwd_body<float, 2, kVec>(p);
}

// K5 in f32 and bf16: the same 20 sums a thread (5 sums x 4 channels) in
// both, a bf16 group one 8-byte load (8 channels would take 40)
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    bn_act_pool_bwd_bwd_kernel(const BwdArgs p) {
  bwd_body<T, 5, kVec>(p);
}

// -- bf16 K3 ---------------------------------------------------------------

constexpr int kV16 = 8;  // bf16 channels a thread: one 16-byte load

struct Bf16Args {
  const bf16_t* y;
  const bf16_t* dp;     // the pooled gradient
  const uint8_t* arg;   // its window argmax, 2 * dh + dw
  const bf16_t* mean;
  const bf16_t* rstd;
  const bf16_t* gamma;
  const bf16_t* beta;
  bf16_t* out;          // dy
  bf16_t* vec0;         // dgamma
  bf16_t* vec1;         // dbeta
  float* part;          // (T, 2, C, blocks): the blocks' partial sums
  float* tot;           // (T, 2, C): the merged sums
  int N, H, W, C, G, Ho, Wo, Hc, Wc, windows, slots, chunk, blocks;
  float slope, inv_m;
};

// 8 channels of bf16 from p as their raw bits (n of them where !kVec, zeros
// past them); kLast as load4
template <bool kVec, bool kLast>
__device__ __forceinline__ uint4 load8(const bf16_t* p, int n) {
  if (kVec) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    return kLast ? __ldcs(q) : __ldg(q);
  }
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kV16; ++j)
    if (j < n) {
      const unsigned b = kLast ? __ldcs(q + j) : __ldg(q + j);
      w[j >> 1] |= b << (16 * (j & 1));
    }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// channel j of 8 bf16 bits, as f32
__device__ __forceinline__ float chan(const uint4& v, int j) {
  const unsigned w = j < 2 ? v.x : j < 4 ? v.y : j < 6 ? v.z : v.w;
  return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
}

// channel j of the window position k (0-3), by selects
__device__ __forceinline__ float pick8(const uint4 (&v)[4], int k, int j) {
  const float p0 = chan(v[0], j), p1 = chan(v[1], j), p2 = chan(v[2], j),
              p3 = chan(v[3], j);
  return k == 0 ? p0 : k == 1 ? p1 : k == 2 ? p2 : p3;
}

// 8 argmax bytes (a channel's byte k >> 8 (j % 4) of word j / 4); kNoArg
// past n where !kVec
template <bool kVec, bool kLast>
__device__ __forceinline__ uint2 load_arg8(const uint8_t* p, int n) {
  if (kVec) {
    const uint2* q = reinterpret_cast<const uint2*>(p);
    return kLast ? __ldcs(q) : __ldg(q);
  }
  unsigned w[2] = {kNoArg, kNoArg};
#pragma unroll
  for (int j = 0; j < kV16; ++j)
    if (j < n) {
      const unsigned b = kLast ? __ldcs(p + j) : __ldg(p + j);
      const int s = 8 * (j & 3);
      w[j >> 2] = (w[j >> 2] & ~(0xffu << s)) | (b << s);
    }
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ int arg_of(const uint2& k, int j) {
  return (int)(((j < 4 ? k.x : k.y) >> (8 * (j & 3))) & 0xffu);
}

// 8 channels rounded once to bf16 and stored (n of them where !kVec)
template <bool kVec>
__device__ __forceinline__ void store8(bf16_t* p, const float (&o)[kV16],
                                       int n) {
  if (kVec) {
    uint4 v;
    v.x = bf16_bits(o[0]) | (bf16_bits(o[1]) << 16);
    v.y = bf16_bits(o[2]) | (bf16_bits(o[3]) << 16);
    v.z = bf16_bits(o[4]) | (bf16_bits(o[5]) << 16);
    v.w = bf16_bits(o[6]) | (bf16_bits(o[7]) << 16);
    __stcs(reinterpret_cast<uint4*>(p), v);
    return;
  }
  unsigned short* q = reinterpret_cast<unsigned short*>(p);
#pragma unroll
  for (int j = 0; j < kV16; ++j)
    if (j < n) __stcs(q + j, (unsigned short)bf16_bits(o[j]));
}

// K3 in bf16, the whole call: reduce, grid barrier, merge, barrier, apply,
// as bwd_body<2, ...> orders it, a thread 8 channels.
template <bool kVec>
__device__ __forceinline__ void bwd_body_bf16(const Bf16Args& p) {
  // the apply pass's per-channel values: mean, rstd, gamma, beta, gamma *
  // rstd, mean(dz), mean(dz xhat)
  constexpr int kN = 7;
  __shared__ __align__(16) float red[2 * kV16 * kThreads];
  __shared__ float sums[2 * kMaxC];
  __shared__ __align__(16) float cst[kN * kMaxC];

  const int t = blockIdx.y, tid = threadIdx.x;
  const int CP = kV16 * p.G;  // C rounded up to the groups
  const int slot = tid / p.G, c0 = kV16 * (tid - slot * p.G);
  const bool active = slot < p.slots;
  const int nc = min(kV16, p.C - c0);
  const size_t img = (size_t)t * p.N * p.H * p.W * p.C + c0;
  const size_t pooled = (size_t)t * p.N * p.Ho * p.Wo * p.C + c0;
  const bf16_t* y = p.y + img;
  const bf16_t* dp = p.dp + pooled;
  const uint8_t* arg = p.arg + pooled;
  const int first = blockIdx.x * p.chunk;
  const int last = min(first + p.chunk, p.windows);
  const float slope = p.slope;

  // -- reduce: this thread's windows, in order ------------------------
  float acc[2][kV16];
#pragma unroll
  for (int j = 0; j < kV16; ++j) acc[0][j] = acc[1][j] = 0.f;
  if (active) {
    const int tc = t * p.C + c0;
    const uint4 mu = load8<kVec, false>(p.mean + tc, nc);
    const uint4 rs = load8<kVec, false>(p.rstd + tc, nc);
    const uint4 ga = load8<kVec, false>(p.gamma + tc, nc);
    const uint4 be = load8<kVec, false>(p.beta + tc, nc);
    for (int i = first + slot; i < last; i += p.slots) {
      int pix, poff;
      bool h1, w1;
      window(p, i, pix, h1, w1, poff);
      if (poff < 0) continue;  // no dz in the window
      uint4 yv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = (!(q >> 1) || h1) && (!(q & 1) || w1);
        const int off = (pix + (q >> 1) * p.W + (q & 1)) * p.C;
        yv[q] = ok ? load8<kVec, false>(y + off, nc)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
      const uint4 d = load8<kVec, false>(dp + (size_t)poff * p.C, nc);
      const uint2 ks = load_arg8<kVec, false>(arg + (size_t)poff * p.C, nc);
#pragma unroll
      for (int j = 0; j < kV16; ++j) {
        const int k = arg_of(ks, j);
        if (k < 4) {  // the argmax of a pooled window
          const float v = pick8(yv, k, j);
          const float m = chan(mu, j), r = chan(rs, j);
          const float x = maml::bn_xhat(v, m, r);
          const float z = maml::bn_z_bf16(v, m, r, chan(ga, j), chan(be, j));
          const float dj = chan(d, j);
          const float dz = z >= 0.f ? dj : dj * slope;
          acc[0][j] += dz;
          acc[1][j] = fmaf(dz, x, acc[1][j]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float* r = &red[(slot * 2 + k) * CP + c0];
      *reinterpret_cast<float4*>(r) =
          make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      *reinterpret_cast<float4*>(r + 4) =
          make_float4(acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
    }
  }
  __syncthreads();
  // the block's partials: its slots in order
  for (int col = tid; col < 2 * p.C; col += kThreads) {
    const int k = col / p.C, c = col - k * p.C;
    float s = 0.f;
    for (int sl = 0; sl < p.slots; ++sl) s += red[(sl * 2 + k) * CP + c];
    p.part[((size_t)(t * 2 + k) * p.C + c) * p.blocks + blockIdx.x] = s;
  }
  // -- merge: every tenant's partials, one warp a column --------------
  const int lane = tid & 31, warps = kThreads / 32;
  cg::grid_group grid = cg::this_grid();
  grid.sync();
  const int cols = gridDim.y * 2 * p.C;
  const int nwarps = gridDim.x * gridDim.y * warps;
  for (int col = (blockIdx.y * gridDim.x + blockIdx.x) * warps + (tid >> 5);
       col < cols; col += nwarps) {
    const float s = merge(p.part + (size_t)col * p.blocks, p.blocks, lane);
    if (lane == 0) p.tot[col] = s;
  }
  grid.sync();
  for (int col = tid; col < 2 * p.C; col += kThreads)
    sums[col] = __ldcg(p.tot + (size_t)t * 2 * p.C + col);
  __syncthreads();
  // -- the per-channel values; the first chunk's block writes dgamma and
  // dbeta, each rounded once --------------------------------------------
  const float inv_m = p.inv_m;
  for (int c = tid; c < CP; c += kThreads) {
    float v[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = 0.f;  // channels past C
    if (c < p.C) {
      const int tc = t * p.C + c;
      const float m = __bfloat162float(p.mean[tc]);
      const float r = __bfloat162float(p.rstd[tc]);
      const float g = __bfloat162float(p.gamma[tc]);
      const float s_dz = sums[c], s_dzx = sums[p.C + c];
      v[0] = m, v[1] = r, v[2] = g, v[3] = __bfloat162float(p.beta[tc]);
      v[4] = g * r;
      v[5] = s_dz * inv_m;
      v[6] = s_dzx * inv_m;
      if (blockIdx.x == 0) {
        p.vec0[tc] = __float2bfloat16_rn(s_dzx);
        p.vec1[tc] = __float2bfloat16_rn(s_dz);
      }
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) cst[k * CP + c] = v[k];
  }
  __syncthreads();
  if (!active) return;

  // -- apply: this thread's windows, last first -------------------------
  const int mine = last - first - slot;
  if (mine <= 0) return;
  for (int i = first + slot + (mine - 1) / p.slots * p.slots; i >= first;
       i -= p.slots) {
    int pix, poff;
    bool h1, w1;
    window(p, i, pix, h1, w1, poff);
    uint4 yv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool ok = (!(q >> 1) || h1) && (!(q & 1) || w1);
      const int off = (pix + (q >> 1) * p.W + (q & 1)) * p.C;
      yv[q] = ok ? load8<kVec, true>(y + off, nc)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
    uint4 d = make_uint4(0u, 0u, 0u, 0u);
    uint2 ks = make_uint2(kNoArg, kNoArg);
    if (poff >= 0) {
      d = load8<kVec, true>(dp + (size_t)poff * p.C, nc);
      ks = load_arg8<kVec, true>(arg + (size_t)poff * p.C, nc);
    }
    float o[4][kV16];
#pragma unroll
    for (int j = 0; j < kV16; ++j) {
      const float* cj = &cst[c0 + j];
      const float m = cj[0], r = cj[CP], g = cj[2 * CP], b = cj[3 * CP];
      const float grs = cj[4 * CP], mdz = cj[5 * CP], mdzx = cj[6 * CP];
      const int k = arg_of(ks, j);
      float dzk = 0.f;  // dz at the argmax
      if (k < 4) {
        const float v = pick8(yv, k, j);
        const float z = maml::bn_z_bf16(v, m, r, g, b);
        const float dj = chan(d, j);
        dzk = z >= 0.f ? dj : dj * slope;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x = maml::bn_xhat(chan(yv[q], j), m, r);
        const float dz = k == q ? dzk : 0.f;
        o[q][j] = grs * (dz - mdz - x * mdzx);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool ok = (!(q >> 1) || h1) && (!(q & 1) || w1);
      if (ok)
        store8<kVec>(p.out + img + (pix + (q >> 1) * p.W + (q & 1)) * p.C,
                     o[q], nc);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    bn_act_pool_bwd_bf16_kernel(const Bf16Args p) {
  bwd_body_bf16<kVec>(p);
}

template <typename T, int kS, bool kVec>
const void* kernel() {
  if constexpr (kS == 2)
    return reinterpret_cast<const void*>(bn_act_pool_bwd_kernel<kVec>);
  else
    return reinterpret_cast<const void*>(bn_act_pool_bwd_bwd_kernel<T, kVec>);
}

template <bool kVec>
const void* bf16_kernel() {
  return reinterpret_cast<const void*>(bn_act_pool_bwd_bf16_kernel<kVec>);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline bool aligned(const void* p, unsigned long long bytes) {
  return p == nullptr ||
         (reinterpret_cast<unsigned long long>(p) & (bytes - 1)) == 0;
}

// The geometry of the plan (kernels/conv_block.py::bn_bwd_plan) at this
// shape, a channel group V channels (4: f32, and the bf16 K5; 8: the bf16
// K3); false where the shape or the plan does not match it.
template <typename A>
bool bwd_geom(A& p, int V, int T, int N, int H, int W, int C, int blocks,
              int chunk, int slots, int threads) {
  if (T < 1 || T > 65535 || N < 1 || H < 2 || W < 2 || C < 1 || C > kMaxC ||
      threads != kThreads)
    return false;
  if ((long long)N * H * W * C >= (1LL << 31)) return false;
  p.N = N, p.H = H, p.W = W, p.C = C;
  p.G = cdiv(C, V);
  p.Ho = H / 2, p.Wo = W / 2, p.Hc = cdiv(H, 2), p.Wc = cdiv(W, 2);
  p.windows = N * p.Hc * p.Wc;
  p.slots = slots, p.chunk = chunk, p.blocks = blocks;
  return slots == kThreads / p.G && chunk >= slots && chunk % slots == 0 &&
         blocks == cdiv(p.windows, chunk);
}

// kVec: C % 4 == 0 and every tensor aligned to a group's load (16 bytes of
// f32, 8 of bf16; the argmax 4 bytes); the wrapper decides, and the entry
// refuses a kVec it does not hold.
template <typename T>
bool vec_ok(const BwdArgs& p) {
  constexpr unsigned long long b = 4 * sizeof(T);
  return p.C % 4 == 0 && aligned(p.y, b) && aligned(p.a, b) &&
         aligned(p.dp, b) && aligned(p.arg, 4) && aligned(p.mean, b) &&
         aligned(p.rstd, b) && aligned(p.gamma, b) && aligned(p.beta, b) &&
         aligned(p.ggamma, b) && aligned(p.gbeta, b) && aligned(p.out, b) &&
         aligned(p.gdp, b);
}

template <typename T, int kS>
cudaError_t run(BwdArgs p, int T_, int vec, cudaStream_t st) {
  if (vec && !vec_ok<T>(p)) return cudaErrorInvalidValue;
  const dim3 grid(p.blocks, T_), block(kThreads);
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      vec ? kernel<T, kS, true>() : kernel<T, kS, false>(), grid, block,
      args, 0, st);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// K5's arguments, in f32 or bf16 (T): the plan's geometry and every
// pointer; false where the plan does not match the shape.
template <typename T>
bool k5_args(BwdArgs& p, const T* a, const T* ggamma, const T* gbeta,
             const T* dp, const uint8_t* arg, const T* y, const T* mean,
             const T* rstd, const T* gamma, const T* beta, T* g_dp, T* g_y,
             T* g_gamma, float* part, float* tot, int T_, int N, int H,
             int W, int C, int blocks, int chunk, int slots, int threads,
             float slope, float inv_m) {
  if (!bwd_geom(p, 4, T_, N, H, W, C, blocks, chunk, slots, threads))
    return false;
  p.y = y, p.a = a, p.dp = dp, p.arg = arg, p.mean = mean, p.rstd = rstd;
  p.gamma = gamma, p.beta = beta, p.ggamma = ggamma, p.gbeta = gbeta;
  p.out = g_y, p.gdp = g_dp, p.vec0 = g_gamma, p.part = part, p.tot = tot;
  p.slope = slope, p.inv_m = inv_m;
  return true;
}

}  // namespace

extern "C" {

// The blocks of 256 threads a SM can hold of the one-launch kernel of K3
// (sums 2) or K5 (sums 5), vector (vec 1) or scalar loads, f32 or bf16:
// the plan's `blocks_per_sm`, as the cooperative launch requires every
// block resident at once. Returns the CUDA error, 0 on success.
int bn_act_pool_bwd_blocks_per_sm(int sums, int vec, int bf16, int* blocks) {
  if (sums != 2 && sums != 5) return (int)cudaErrorInvalidValue;
  const void* k =
      sums == 2
          ? (bf16 ? (vec ? bf16_kernel<true>() : bf16_kernel<false>())
                  : (vec ? kernel<float, 2, true>()
                         : kernel<float, 2, false>()))
          : (bf16 ? (vec ? kernel<bf16_t, 5, true>()
                         : kernel<bf16_t, 5, false>())
                  : (vec ? kernel<float, 5, true>()
                         : kernel<float, 5, false>()));
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k,
                                                            kThreads, 0);
}

// K3: from the pooled gradient dp (T, N, H/2, W/2, C) and its argmax, y
// (T, N, H, W, C) and the (T, C) mean, rstd, gamma, beta: dy (T, N, H, W,
// C), dgamma and dbeta (T, C). `part` (T, 2, C, blocks) and `tot` (T, 2,
// C) are f32 scratch. The plan: `blocks` a tenant of `chunk` windows,
// `slots`, `threads`; `vec` the 16-byte loads. Returns the CUDA error, 0
// on success.
int bn_act_pool_bwd_f32(const float* dp, const uint8_t* arg, const float* y,
                        const float* mean, const float* rstd,
                        const float* gamma, const float* beta, float* dy,
                        float* dgamma, float* dbeta, float* part, float* tot,
                        int T, int N, int H, int W, int C, int blocks,
                        int chunk, int slots, int threads, int vec,
                        float slope, float inv_m, void* stream) {
  BwdArgs p = {};
  if (!bwd_geom(p, 4, T, N, H, W, C, blocks, chunk, slots, threads))
    return (int)cudaErrorInvalidValue;
  p.y = y, p.dp = dp, p.arg = arg, p.mean = mean, p.rstd = rstd;
  p.gamma = gamma, p.beta = beta, p.out = dy, p.vec0 = dgamma;
  p.vec1 = dbeta, p.part = part, p.tot = tot;
  p.slope = slope, p.inv_m = inv_m;
  return (int)run<float, 2>(p, T, vec, static_cast<cudaStream_t>(stream));
}

// K5: from the cotangents a (T, N, H, W, C), ggamma and gbeta (T, C) of
// K3's outputs and K3's inputs: g_dpooled (T, N, H/2, W/2, C), g_y (T, N,
// H, W, C) and g_gamma (T, C). `part` (T, 5, C, blocks) and `tot` (T, 5,
// C) are f32 scratch; the plan's arguments as K3's.
int bn_act_pool_bwd_bwd_f32(const float* a, const float* ggamma,
                            const float* gbeta, const float* dp,
                            const uint8_t* arg, const float* y,
                            const float* mean, const float* rstd,
                            const float* gamma, const float* beta,
                            float* g_dp, float* g_y, float* g_gamma,
                            float* part, float* tot, int T, int N, int H,
                            int W, int C, int blocks, int chunk, int slots,
                            int threads, int vec, float slope, float inv_m,
                            void* stream) {
  BwdArgs p = {};
  if (!k5_args(p, a, ggamma, gbeta, dp, arg, y, mean, rstd, gamma, beta,
               g_dp, g_y, g_gamma, part, tot, T, N, H, W, C, blocks, chunk,
               slots, threads, slope, inv_m))
    return (int)cudaErrorInvalidValue;
  return (int)run<float, 5>(p, T, vec, static_cast<cudaStream_t>(stream));
}

// K5 in bf16: the arguments of bn_act_pool_bwd_bwd_f32, every tensor but
// the argmax and the f32 scratch bf16; the plan's groups 4 channels, as in
// f32 (`vec`: C % 4 == 0, every bf16 tensor 8-byte aligned, the argmax
// 4-byte).
int bn_act_pool_bwd_bwd_bf16(const bf16_t* a, const bf16_t* ggamma,
                             const bf16_t* gbeta, const bf16_t* dp,
                             const uint8_t* arg, const bf16_t* y,
                             const bf16_t* mean, const bf16_t* rstd,
                             const bf16_t* gamma, const bf16_t* beta,
                             bf16_t* g_dp, bf16_t* g_y, bf16_t* g_gamma,
                             float* part, float* tot, int T, int N, int H,
                             int W, int C, int blocks, int chunk, int slots,
                             int threads, int vec, float slope, float inv_m,
                             void* stream) {
  BwdArgs p = {};
  if (!k5_args(p, a, ggamma, gbeta, dp, arg, y, mean, rstd, gamma, beta,
               g_dp, g_y, g_gamma, part, tot, T, N, H, W, C, blocks, chunk,
               slots, threads, slope, inv_m))
    return (int)cudaErrorInvalidValue;
  return (int)run<bf16_t, 5>(p, T, vec, static_cast<cudaStream_t>(stream));
}

// K3 in bf16: the arguments of bn_act_pool_bwd_f32, every tensor but the
// argmax and the f32 scratch bf16; `vec` the 16-byte loads (C % 8 == 0,
// every bf16 tensor 16-byte aligned, the argmax 8-byte).
int bn_act_pool_bwd_bf16(const bf16_t* dp, const uint8_t* arg,
                         const bf16_t* y, const bf16_t* mean,
                         const bf16_t* rstd, const bf16_t* gamma,
                         const bf16_t* beta, bf16_t* dy, bf16_t* dgamma,
                         bf16_t* dbeta, float* part, float* tot, int T, int N,
                         int H, int W, int C, int blocks, int chunk,
                         int slots, int threads, int vec, float slope,
                         float inv_m, void* stream) {
  Bf16Args p = {};
  if (!bwd_geom(p, kV16, T, N, H, W, C, blocks, chunk, slots, threads))
    return (int)cudaErrorInvalidValue;
  p.y = y, p.dp = dp, p.arg = arg, p.mean = mean, p.rstd = rstd;
  p.gamma = gamma, p.beta = beta, p.out = dy, p.vec0 = dgamma;
  p.vec1 = dbeta, p.part = part, p.tot = tot;
  p.slope = slope, p.inv_m = inv_m;
  if (vec && !(C % kV16 == 0 && aligned(y, 16) && aligned(dp, 16) &&
               aligned(arg, 8) && aligned(mean, 16) && aligned(rstd, 16) &&
               aligned(gamma, 16) && aligned(beta, 16) && aligned(dy, 16)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.blocks, T), block(kThreads);
  void* args[] = {&p};
  const void* k = vec ? bf16_kernel<true>() : bf16_kernel<false>();
  const cudaError_t err = cudaLaunchCooperativeKernel(
      k, grid, block, args, 0, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // extern "C"
