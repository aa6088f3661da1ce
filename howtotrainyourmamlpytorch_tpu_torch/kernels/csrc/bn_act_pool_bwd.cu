// K3 and K5 in f32, pooled: the backward of batch norm + leaky-ReLU + 2x2
// max pool through the batch statistics (bn_act_pool_bwd_f32) and the
// derivative of that backward (bn_act_pool_bwd_bwd_f32), each one
// cooperative launch.
//
// Replaces (JAX package) howtotrainyourmamlpytorch_tpu/ops/functional.py:
// the gradient XLA derives for the normalize/affine tail of `batch_norm`
// :368, `leaky_relu` :363 and `max_pool2d` :325 (VALID: an odd map's last
// row and column are dropped) inside `conv_bn_act` :249 (K3), and the
// derivative of that gradient, which second-order MAML takes through the
// inner loop (core/maml.py::_task_learner; K5). The bf16 and the pool-free
// modes stay on the Triton kernels of kernels/bn_act_pool.py.
//
// The arithmetic is the Triton kernels' (kernels/bn_act_pool.py derives
// K5's formulas) and the twins' (ops/functional.py::bn_act_pool_bwd,
// ::bn_act_pool_bwd_bwd). With xhat = (y - mean) * rstd, z = xhat * gamma
// + beta (one FMA, as the Triton kernels round it) and dz the pooled
// gradient at each window's argmax through the leaky slope (0 at every
// other position, the dropped row and column included), per (tenant,
// channel) over the m = N * H * W positions:
//   K3: dbeta = sum dz, dgamma = sum dz xhat,
//       dy = gamma rstd (dz - dbeta / m - xhat dgamma / m);
//   K5: from the cotangents a (of dy), ggamma and gbeta, the five sums
//       sum a, a xhat, dz, dz xhat, a dz, then g_dpooled (at the argmax),
//       g_y (every position) and g_gamma.
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
//   shape and of the blocks a SM the occupancy query reports): each
//   tenant's map cut into windows of 2 x 2 positions (an odd map's last row
//   or column into windows of one row or column, which no pooled element
//   reads), the windows into chunks of whole windows over as many blocks
//   as the card holds at once; no chunk spans two tenants. A block is 256
//   threads: `slots` windows at a time x G = ceil(C / 4) groups of 4
//   consecutive channels; a thread keeps its group, so its sums are
//   scalars in registers (C = 48 and 64 take 252 and 256 of the threads).
// * A thread loads a window's pooled gradient (16 bytes), argmax (4 bytes)
//   and its positions of y (and a) as 16-byte vectors, and writes dy (g_y)
//   the same way and g_dpooled as one vector; one float (byte) at a time
//   where C % 4 != 0 or a tensor is not 16-byte aligned (kVec false).
// * Deterministic, no atomics: a thread sums its windows in order, a block
//   its slots in order (shared memory), a warp a column's partials over
//   lane-strided blocks and then a shuffle tree; the order is the plan's,
//   so a second launch gives the first launch's bits.
// * The apply pass walks each chunk backwards, so that the windows the
//   reduce pass read last are still in L2; it loads with evict-first hints
//   and stores with streaming stores.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // a block
constexpr int kMaxC = 64;      // the channels the kernels take
constexpr unsigned kNoArg = 0xffffffffu;  // 4 argmax bytes: no window

struct BwdArgs {
  const float* y;
  const float* a;       // K5: the cotangent of K3's dy
  const float* dp;      // the pooled gradient
  const uint8_t* arg;   // its window argmax, 2 * dh + dw
  const float* mean;
  const float* rstd;
  const float* gamma;
  const float* beta;
  const float* ggamma;  // K5: the cotangents of K3's dgamma and dbeta
  const float* gbeta;
  float* out;           // K3: dy; K5: g_y
  float* gdp;           // K5: g_dpooled
  float* vec0;          // K3: dgamma; K5: g_gamma
  float* vec1;          // K3: dbeta
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

// 4 channels from p (n of them where !kVec, zeros past them); kLast: the
// pass's last read of the data, with an evict-first hint
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

// Window i of a tenant: the offset (in pixels) of its top-left position,
// whether it has a second row and column, and the offset of its pooled
// element (-1: a window of the dropped row or column).
__device__ __forceinline__ void window(const BwdArgs& p, int i, int& pix,
                                       bool& h1, bool& w1, int& poff) {
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

// The whole call: reduce, grid barrier, merge, barrier, apply.
template <int kS, bool kVec>
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
  const float* y = p.y + img;
  const float* a = kK5 ? p.a + img : nullptr;
  const float* dp = p.dp + pooled;
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
    const float4 mu = load4<kVec, false>(p.mean + tc, nc);
    const float4 rs = load4<kVec, false>(p.rstd + tc, nc);
    const float4 ga = load4<kVec, false>(p.gamma + tc, nc);
    const float4 be = load4<kVec, false>(p.beta + tc, nc);
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
            const float x = (comp(yv[q], j) - m) * r;
            acc[0][j] += comp(av[q], j);
            acc[1][j] = fmaf(comp(av[q], j), x, acc[1][j]);
          }
        }
        const int k = (ks >> (8 * j)) & 0xff;
        if (k < 4) {  // the argmax of a pooled window
          const float x = (pick(yv, k, j) - m) * r;
          const float z = fmaf(x, comp(ga, j), comp(be, j));
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
  // (T, C) outputs -----------------------------------------------------
  const float inv_m = p.inv_m;
  for (int c = tid; c < CP; c += kThreads) {
    float v[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = 0.f;  // channels past C
    if (c < p.C) {
      const int tc = t * p.C + c;
      const float m = p.mean[tc], r = p.rstd[tc], g = p.gamma[tc];
      v[0] = m, v[1] = r, v[2] = g, v[3] = p.beta[tc];
      if constexpr (!kK5) {
        const float s_dz = sums[c], s_dzx = sums[p.C + c];
        v[4] = g * r;
        v[5] = s_dz * inv_m;
        v[6] = s_dzx * inv_m;
        if (blockIdx.x == 0) {
          p.vec0[tc] = s_dzx;
          p.vec1[tc] = s_dz;
        }
      } else {
        const float gg = p.ggamma[tc];
        const float s_a = sums[c], s_ax = sums[p.C + c];
        const float s_dz = sums[2 * p.C + c], s_dzx = sums[3 * p.C + c];
        const float s_adz = sums[4 * p.C + c];
        const float m_a = s_a * inv_m, m_ax = s_ax * inv_m;
        const float m_dz = s_dz * inv_m, m_dzx = s_dzx * inv_m;
        // S_adz - m mean(a) mean(dz) - m mean(a xhat) mean(dz xhat)
        const float cross = s_adz - (m_a * s_dz + m_ax * s_dzx);
        const float grs = g * r;
        v[4] = gg;
        v[5] = p.gbeta[tc];
        v[6] = m_a;
        v[7] = m_ax;
        v[8] = m_dzx;
        v[9] = grs;
        v[10] = -grs * (m_dzx * m_a + m_ax * m_dz) + gg * m_dz;
        v[11] = -2.0f * grs * m_ax * m_dzx + gg * m_dzx;
        v[12] = r * r * inv_m * g * cross;
        if (blockIdx.x == 0) p.vec0[tc] = r * cross;
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
      if constexpr (!kK5) {
        const float grs = comp(c4[4], j), mdz = comp(c4[5], j),
                    mdzx = comp(c4[6], j);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float x = (comp(yv[q], j) - m) * r;
          const float z = fmaf(x, g, b);
          const float dz = k == q ? (z >= 0.f ? dj : dj * slope) : 0.f;
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
          const float x = (comp(yv[q], j) - m) * r;
          const float z = fmaf(x, g, b);
          const bool pos = z >= 0.f;
          const float dz = k == q ? (pos ? dj : dj * slope) : 0.f;
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
        store4<kVec>(p.out + img + (pix + (q >> 1) * p.W + (q & 1)) * p.C,
                     o[q], nc);
    }
    if (kK5 && poff >= 0)
      store4<kVec>(p.gdp + pooled + (size_t)poff * p.C, gd, nc);
  }
}

// two blocks a SM at least (at most 128 registers a thread), so that the
// large-batch config's 256 tenants fit the card at a block a tenant
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    bn_act_pool_bwd_kernel(const BwdArgs p) {
  bwd_body<2, kVec>(p);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    bn_act_pool_bwd_bwd_kernel(const BwdArgs p) {
  bwd_body<5, kVec>(p);
}

template <int kS, bool kVec>
const void* kernel() {
  if constexpr (kS == 2)
    return reinterpret_cast<const void*>(bn_act_pool_bwd_kernel<kVec>);
  else
    return reinterpret_cast<const void*>(bn_act_pool_bwd_bwd_kernel<kVec>);
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline bool aligned(const void* p, unsigned long long bytes) {
  return p == nullptr ||
         (reinterpret_cast<unsigned long long>(p) & (bytes - 1)) == 0;
}

// The geometry of the plan (kernels/conv_block.py::bn_bwd_plan) at this
// shape; false where the shape or the plan does not match it.
bool bwd_geom(BwdArgs& p, int T, int N, int H, int W, int C, int blocks,
              int chunk, int slots, int threads) {
  if (T < 1 || T > 65535 || N < 1 || H < 2 || W < 2 || C < 1 || C > kMaxC ||
      threads != kThreads)
    return false;
  if ((long long)N * H * W * C >= (1LL << 31)) return false;
  p.N = N, p.H = H, p.W = W, p.C = C;
  p.G = cdiv(C, 4);
  p.Ho = H / 2, p.Wo = W / 2, p.Hc = cdiv(H, 2), p.Wc = cdiv(W, 2);
  p.windows = N * p.Hc * p.Wc;
  p.slots = slots, p.chunk = chunk, p.blocks = blocks;
  return slots == kThreads / p.G && chunk >= slots && chunk % slots == 0 &&
         blocks == cdiv(p.windows, chunk);
}

// kVec: C % 4 == 0 and every tensor 16-byte aligned (the argmax 4-byte);
// the wrapper decides, and the entry refuses a kVec it does not hold.
bool vec_ok(const BwdArgs& p) {
  return p.C % 4 == 0 && aligned(p.y, 16) && aligned(p.a, 16) &&
         aligned(p.dp, 16) && aligned(p.arg, 4) && aligned(p.mean, 16) &&
         aligned(p.rstd, 16) && aligned(p.gamma, 16) && aligned(p.beta, 16) &&
         aligned(p.ggamma, 16) && aligned(p.gbeta, 16) && aligned(p.out, 16) &&
         aligned(p.gdp, 16);
}

template <int kS, bool kVec>
cudaError_t launch(BwdArgs p, int T, cudaStream_t st) {
  const dim3 grid(p.blocks, T), block(kThreads);
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel<kS, kVec>(), grid, block, args, 0, st);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <int kS>
cudaError_t run(const BwdArgs& p, int T, int vec, cudaStream_t st) {
  if (vec && !vec_ok(p)) return cudaErrorInvalidValue;
  return vec ? launch<kS, true>(p, T, st) : launch<kS, false>(p, T, st);
}

}  // namespace

extern "C" {

// The blocks of 256 threads a SM can hold of the one-launch kernel of K3
// (sums 2) or K5 (sums 5), vector (vec 1) or scalar loads: the plan's
// `blocks_per_sm`, as the cooperative launch requires every block
// resident at once. Returns the CUDA error, 0 on success.
int bn_act_pool_bwd_blocks_per_sm(int sums, int vec, int* blocks) {
  if (sums != 2 && sums != 5) return (int)cudaErrorInvalidValue;
  const void* k = sums == 2
                      ? (vec ? kernel<2, true>() : kernel<2, false>())
                      : (vec ? kernel<5, true>() : kernel<5, false>());
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
  if (!bwd_geom(p, T, N, H, W, C, blocks, chunk, slots, threads))
    return (int)cudaErrorInvalidValue;
  p.y = y, p.dp = dp, p.arg = arg, p.mean = mean, p.rstd = rstd;
  p.gamma = gamma, p.beta = beta, p.out = dy, p.vec0 = dgamma;
  p.vec1 = dbeta, p.part = part, p.tot = tot;
  p.slope = slope, p.inv_m = inv_m;
  return (int)run<2>(p, T, vec, static_cast<cudaStream_t>(stream));
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
  if (!bwd_geom(p, T, N, H, W, C, blocks, chunk, slots, threads))
    return (int)cudaErrorInvalidValue;
  p.y = y, p.a = a, p.dp = dp, p.arg = arg, p.mean = mean, p.rstd = rstd;
  p.gamma = gamma, p.beta = beta, p.ggamma = ggamma, p.gbeta = gbeta;
  p.out = g_y, p.gdp = g_dp, p.vec0 = g_gamma, p.part = part, p.tot = tot;
  p.slope = slope, p.inv_m = inv_m;
  return (int)run<5>(p, T, vec, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
