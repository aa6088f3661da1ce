// The layer norm's statistics (layer_norm_stats), its normalize + affine
// (layer_norm_fwd), its backward through the statistics (layer_norm_bwd)
// and the backward of that backward (layer_norm_bwd_bwd), f32 and bf16,
// one launch a call each.
//
// Replaces (JAX package) howtotrainyourmamlpytorch_tpu/ops/functional.py::
// layer_norm :447, as models/vgg.py calls it (on the conv output, or on the
// block input in the norm-first block): its per-image mean and variance
// (jnp.mean, jnp.var) and rsqrt(var + eps), the normalize and affine
// :463-464, and the first and second derivatives XLA takes of it through
// those statistics (the second in second-order MAML's inner loop). The
// twins are ops/functional.py::image_stats / layer_norm_stats,
// ::layer_norm_fwd, ::layer_norm_bwd and ::layer_norm_bwd_bwd of the port.
//
// x is (T, N, H, W, C); a ROW is one image of M = H * W * C consecutive
// values, R = T * N rows. gamma is per tenant (T, H, W, C).
//
//   stats: mean, population variance, rstd = 1 / sqrt(var + eps), (T, N);
//   fwd:   z = (x - mean) * rstd * gamma + beta;
//   bwd:   with g = dz * gamma and xhat = (x - mean) * rstd,
//          dx = rstd * (g - mean_row(g) - xhat * mean_row(g * xhat)),
//          dgamma = sum_n dz * xhat, dbeta = sum_n dz per (tenant, column);
//   bwd_bwd: from the cotangents a (of dx), ggamma and gbeta, with P(u) =
//          u - mean_row(u) - xhat * mean_row(u * xhat),
//          g_dz = gamma * rstd * P(a) + ggamma * xhat + gbeta,
//          g_x = rstd * (G - mean_row(G) - xhat * mean_row(G * xhat))
//                - xhat * rstd^2 * (mean_row(a g) - mean_row(a) mean_row(g)
//                                   - mean_row(a xhat) mean_row(g xhat)),
//          G = -rstd * (a mean_row(g xhat) + g mean_row(a xhat)) + ggamma dz,
//          g_gamma = sum_n dz * rstd * P(a): the row means of G and G xhat
//          follow from seven row sums (a, a xhat, g, g xhat, a g, ggamma
//          dz, ggamma dz xhat).
//
// bf16 keeps the Triton kernels' rounding points: every load widened to
// f32, every partial and sum f32; mean and var each rounded once, rstd the
// f32 1 / sqrt of bf16(bf16(var) + eps) rounded once (maml::store_stats);
// the forward each of its four ops rounded to bf16, as the twin's bf16
// tensor ops round them (the batch-norm chain at slope 1,
// bn_act_chain.cuh); xhat in f32 from the bf16 mean and rstd; dx, dgamma,
// dbeta, g_dz, g_x and g_gamma each rounded once at the store. The f32
// forward rounds each of the twin's four ops (x - mean, * rstd, * gamma, +
// beta; no FMA), so it is the twin's bits in both dtypes.
//
// Bound on an H100: bytes (3.35 TB/s; a few FLOPs an element, no matrix
// product). The statistics read x once; the backward must read dz and x
// twice (the row sums need the whole row before any dx, the column sums
// all N rows of a tenant), write dx, dgamma and dbeta. The forward reads
// x once and writes z once; it reads gamma and beta for each image, from
// L2 after a tenant's first. The double backward must read a, dz and x
// twice (8 accesses of an element where the bound counts 5: its share of
// the bound is at most 62.5%) and write g_dz and g_x.
//
// * layer_norm_stats: one launch, shaped by conv_block.ln_stats_plan, a
//   pure function of (R, M, dtype, vectors). A thread loads 16 bytes at a
//   time (4 f32 or 8 bf16 values; one value where M or x's alignment does
//   not allow it), kUnroll loads in flight, and folds them into a running
//   (count, mean, M2) with Chan's merge, four loads a merge in f32 and one
//   in bf16: their own mean and sum of squared deviations first, so
//   E[x^2] - E[x]^2 is never formed (in f32 a merge a load, and its
//   division, ran slower than the Triton kernels replaced). Rows of at most
//   kWarpRowVecs loads take a warp each, 8 rows a block ("warp"); larger
//   rows a thread block cluster each ("cluster", 1-8 blocks by the
//   launch's cluster attribute), each block a chunk of the row; the
//   block merges its warps in order, and rank 0 merges the blocks'
//   partials in rank order through distributed shared memory
//   (map_shared_rank) and stores; a second cluster.sync keeps the peers'
//   shared memory alive until then. No scratch, no second launch, no
//   atomics.
// * layer_norm_fwd: one plain launch, shaped by conv_block.ln_fwd_plan
//   (pure): a block a tile of 256 loads (16 bytes, or one value, each) of
//   one image, the images in order, so that the blocks running at once
//   stream through x and z and share their tenant's gamma and beta in L2.
//   (Gamma and beta held in registers by a thread walking its tenant's
//   images, which reads them once from memory, ran 3% slower in f32 at
//   the conv-first stage 0: its concurrent reads spread over many images.)
// * layer_norm_bwd: one cooperative launch (the pattern of
//   bn_act_pool_bwd.cu), on conv_block.ln_bwd_plan's grid, sized from the
//   occupancy query. A work item is (tenant, column tile); a tile is one
//   load of `tpr` threads (a row group), and the block's 256 threads are
//   256 / tpr row groups that share the item's N rows (row n to group n
//   mod groups). (1) Each block walks its items: a thread adds its
//   columns' dz and dz * xhat over its rows in registers, and each warp
//   reduces each of its rows' two partial sums over its part of the tile
//   (a shuffle tree) into f32 scratch, one pair a (row, tile, warp), with
//   no barrier between the warps; the row groups' column sums are added
//   in group order and stored as dgamma and dbeta (the block owns every
//   row of its columns: no merge). (2) Grid barrier; a warp a row adds
//   the row's partials in (tile, warp) order (lane l the partials l, l +
//   32, ... in order, then a shuffle tree). (3) Barrier; dx for the
//   block's items, last item first and last rows first, so that what step
//   1 read last is still in L2, with evict-first loads and streaming
//   stores. A block takes an even share of the items, and the grid is as
//   many blocks as the card holds at once (two a SM: four of at most 64
//   registers ran slower in f32), so each is resident, as the barriers
//   need.
// * layer_norm_bwd_bwd: layer_norm_bwd's cooperative launch with seven row
//   sums, on ln_bwd_plan's grid sized from its own occupancy query. (1)
//   Each block walks its items: a thread's load of a, dz and x of each of
//   its rows gives its seven partials, each warp reduces them (shuffle
//   trees) into f32 scratch, (row, sum, tile, warp), no barrier between
//   the warps; no column sum yet (g_gamma needs the row means). (2) Grid
//   barrier; a warp a row adds each sum's (tile, warp) partials in order
//   (lane l the partials l, l + 32, ...; four steps' loads in flight),
//   then a shuffle tree, and lane 0 the row's eight coefficients (its
//   mean, rstd, mean(a), mean(a xhat), mean(g xhat), mean(G), mean(G
//   xhat), the term through rstd: two 16-byte loads a row in (3)). (3)
//   Barrier; g_dz and g_x for the block's items, last item and last rows
//   first, evict-first loads, streaming stores; each thread adds dz * rstd
//   * P(a) over its group's rows (last first), and the row groups' sums
//   are added in group order through shared memory into g_gamma, as
//   dgamma in (1) of the backward. A row group keeps 2-4 rows in flight
//   (three loads a row), within 128 registers.
// * Deterministic: every sum runs in the plan's fixed order, no float
//   atomics, so a second launch gives the first launch's bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn_act_chain.cuh"
#include "bn_stats_merge.cuh"
#include "vec_io.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;          // a block, both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;         // the portable cluster size
constexpr int kWarpRowVecs = 256;      // the most loads of a "warp" row
constexpr int kUnroll = 4;             // stats: loads in flight a thread
constexpr int kRows = 4;               // bwd: rows in flight a row group

using maml::at;
using maml::bf16_t;
using maml::load;
using maml::Packet;
using maml::scalar;
using maml::store;
using maml::zero;

// -- layer_norm_stats ----------------------------------------------------

struct StatsArgs {
  const void* x;
  void* mean;
  void* var;
  void* rstd;
  int R, M, chunk;  // chunk: the values of a cluster block (a multiple of V)
  float eps;
};

struct Chan {
  float n, mean, m2;
};

// The running statistics merged with (nb, mb, m2b) after them (Chan et
// al.): one division.
__device__ __forceinline__ void merge(Chan& c, float nb, float mb,
                                      float m2b) {
  if (nb == 0.f) return;
  const float nn = c.n + nb;
  const float w = nb / nn;
  const float d = mb - c.mean;
  c.mean = fmaf(d, w, c.mean);
  c.m2 += m2b + d * d * c.n * w;
  c.n = nn;
}

// This thread's statistics over the loads [begin, end) of `row` (in loads
// of V values): loads begin + lane, begin + lane + stride, ..., in order,
// kUnroll in flight, folded a group of kGroup loads at a time: each load's
// sum and then the group's (in order), the group's mean, each load's sum
// of squared deviations and then the group's, then one merge. f32 folds
// four loads a merge; bf16, whose widening costs more instructions, one
// (four ran slower there).
template <typename T, int V>
__device__ __forceinline__ Chan fold_run(const T* row, int begin, int end,
                                         int lane, int stride) {
  constexpr int kGroup = sizeof(T) == 4 ? kUnroll : 1;
  Chan c = {0.f, 0.f, 0.f};
  for (int i = begin + lane; i < end; i += kUnroll * stride) {
    Packet<T, V> q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = i + u * stride;
      if (k < end)
        load<false>(row + (size_t)k * V, q[u]);
      else
        zero(q[u]);
    }
    const int live = min(kUnroll, (end - 1 - i) / stride + 1);
#pragma unroll
    for (int g0 = 0; g0 < kUnroll; g0 += kGroup) {
      float su[kGroup], mu[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        su[u] = at(q[g0 + u], 0);
#pragma unroll
        for (int v = 1; v < V; ++v) su[u] += at(q[g0 + u], v);
      }
      const int n = min(kGroup, max(0, live - g0));  // the dead loads are 0
      float sum = su[0];
#pragma unroll
      for (int u = 1; u < kGroup; ++u) sum += su[u];
      const float nb = (float)(n * V);
      const float mb = sum / fmaxf(nb, 1.f);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        mu[u] = 0.f;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float d = at(q[g0 + u], v) - mb;
          mu[u] = fmaf(d, d, mu[u]);
        }
      }
      float m2 = mu[0];
#pragma unroll
      for (int u = 1; u < kGroup; ++u)
        if (u < n) m2 += mu[u];
      merge(c, nb, mb, m2);
    }
  }
  return c;
}

// Lane 0's merge of the warp's statistics: a tree of strides 16 .. 1, each
// lane l merging lane l + stride after itself.
__device__ __forceinline__ Chan warp_merge(Chan c) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float n = __shfl_down_sync(~0u, c.n, off);
    const float m = __shfl_down_sync(~0u, c.mean, off);
    const float q = __shfl_down_sync(~0u, c.m2, off);
    merge(c, n, m, q);
  }
  return c;
}

template <typename T>
__device__ __forceinline__ void store_row(const StatsArgs& a, int row,
                                          const Chan& c) {
  maml::store_stats(static_cast<T*>(a.mean) + row,
                    static_cast<T*>(a.var) + row,
                    static_cast<T*>(a.rstd) + row, c.mean, c.m2 / c.n,
                    a.eps);
}

// Rows of at most kWarpRowVecs loads: a warp a row, kWarps rows a block.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    layer_norm_stats_warp_kernel(const StatsArgs a) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= a.R) return;  // the whole warp
  const T* x = static_cast<const T*>(a.x) + (size_t)row * a.M;
  const Chan c = warp_merge(fold_run<T, V>(x, 0, a.M / V,
                                           threadIdx.x & 31, 32));
  if ((threadIdx.x & 31) == 0) store_row<T>(a, row, c);
}

// Larger rows: a cluster a row, block (rank) r its chunk [r chunk, (r + 1)
// chunk) of the row; rank 0 merges the blocks in rank order.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    layer_norm_stats_cluster_kernel(const StatsArgs a) {
  __shared__ float warps[kWarps][3];
  __shared__ float block[3];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / cs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* x = static_cast<const T*>(a.x) + (size_t)row * a.M;
  const int per = a.chunk / V;
  const int begin = rank * per, end = min(begin + per, a.M / V);
  const Chan c = warp_merge(fold_run<T, V>(x, begin, end, tid, kThreads));
  if (lane == 0) {
    warps[warp][0] = c.n;
    warps[warp][1] = c.mean;
    warps[warp][2] = c.m2;
  }
  __syncthreads();
  if (tid == 0) {
    Chan s = {0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      merge(s, warps[w][0], warps[w][1], warps[w][2]);
    block[0] = s.n;
    block[1] = s.mean;
    block[2] = s.m2;
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    Chan s = {0.f, 0.f, 0.f};
    for (int r = 0; r < cs; ++r) {
      const float* p = cluster.map_shared_rank(block, r);
      merge(s, p[0], p[1], p[2]);
    }
    store_row<T>(a, row, s);
  }
  cluster.sync();  // the peers' shared memory stays until rank 0 has read
}

// -- layer_norm_fwd ------------------------------------------------------

struct FwdArgs {
  const void* x;
  const void* mean;
  const void* rstd;
  const void* gamma;
  const void* beta;
  void* z;
  int N, vecs, tiles;  // vecs: M / V, a row's loads; tiles: a row's blocks
};

// z of V values of one image: f32 the twin's four ops, each rounded
// (((x - mean) * rstd) * gamma + beta: no FMA); bf16 the chain at slope 1,
// each op rounded to bf16 (maml::bn_z_bf16), a conversion a pair.
template <typename T, int V>
__device__ __forceinline__ void fwd_z(const Packet<T, V>& q, float m,
                                      float r, const Packet<T, V>& g,
                                      const Packet<T, V>& b, float (&o)[V]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < V; ++i)
      o[i] = __fadd_rn(
          __fmul_rn(__fmul_rn(__fsub_rn(at(q, i), m), r), at(g, i)),
          at(b, i));
  } else if constexpr (V == 1) {
    o[0] = maml::bn_z_bf16(at(q, 0), m, r, at(g, 0), at(b, 0));
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 2) {
      o[i] = at(q, i);
      o[i + 1] = at(q, i + 1);
      maml::bn_z_bf16_2(o[i], o[i + 1], m, m, r, r, at(g, i), at(g, i + 1),
                        at(b, i), at(b, i + 1));
    }
  }
}

// Block b: image r = b / tiles (r = t N + n: a tenant's images in order),
// its tile b % tiles of kThreads loads; a thread one load (V values) of x,
// gamma and beta, the image's mean and rstd a broadcast load. x is read
// once (bf16 with an evict-first hint, f32 through L1), z written once,
// streaming; gamma and beta are read again for each of the tenant's N
// images, from L2 after the first (the blocks of one tenant's images run
// together). On an H100 this layout, the loads' and the stores' hints were
// each chosen by device time at the layer-norm models' large maps
// (PERF.md).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    layer_norm_fwd_kernel(const FwdArgs a) {
  constexpr bool kLastX = sizeof(T) != 4;
  const unsigned tiles = (unsigned)a.tiles;
  const long long r = blockIdx.x / tiles;
  const int vi = (int)(blockIdx.x % tiles) * kThreads + threadIdx.x;
  if (vi >= a.vecs) return;
  const size_t M = (size_t)a.vecs * V;
  const size_t row = (size_t)r * M + (size_t)vi * V;
  const size_t col = (size_t)(r / a.N) * M + (size_t)vi * V;
  Packet<T, V> xq, gq, bq;
  load<kLastX>(static_cast<const T*>(a.x) + row, xq);
  load<false>(static_cast<const T*>(a.gamma) + col, gq);
  load<false>(static_cast<const T*>(a.beta) + col, bq);
  const float mu = scalar(static_cast<const T*>(a.mean) + r);
  const float rs = scalar(static_cast<const T*>(a.rstd) + r);
  float o[V];
  fwd_z<T, V>(xq, mu, rs, gq, bq, o);
  store<true>(static_cast<T*>(a.z) + row, o);
}

// -- layer_norm_bwd ------------------------------------------------------

struct BwdArgs {
  const void* dz;
  const void* x;
  const void* mean;
  const void* rstd;
  const void* gamma;
  void* dx;
  void* dgamma;
  void* dbeta;
  float* part;  // (R, J, tpr / 32, 2): each (row, tile, warp)'s sums of
                //  g and g * xhat
  float* tot;   // (R, 2): each row's
  int T, N, M, tpr, groups, J, items;
  float inv_m;
};

// Lane 0's sum of v over the warp: a tree of strides 16 .. 1.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_down_sync(~0u, v, off);
  return v;
}

template <typename T, int V>
__device__ __forceinline__ void bwd_body(const BwdArgs& a) {
  // the row groups' column sums at the end of an item
  __shared__ float cols[2 * V][kThreads];

  const T* dz = static_cast<const T*>(a.dz);
  const T* x = static_cast<const T*>(a.x);
  const T* mean = static_cast<const T*>(a.mean);
  const T* rstd = static_cast<const T*>(a.rstd);
  const T* gamma = static_cast<const T*>(a.gamma);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid / a.tpr, l = tid - g * a.tpr;  // row group, its thread
  const int wpg = a.tpr / 32;                      // warps a row group
  const int G = a.groups, N = a.N, J = a.J;
  const int vecs = a.M / V;
  // the block's items: an even share, in order
  const int first = (int)((long long)blockIdx.x * a.items / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * a.items / gridDim.x);
  const int step = kRows * G;  // rows a batch
  const int jw = J * wpg;      // a row's (tile, warp) partials
  const int wg = warp - g * wpg;

  // -- (1) column sums and row partials, item by item ---------------------
  for (int it = first; it < last; ++it) {
    const int t = it / J, j = it - t * J;
    const int vi = j * a.tpr + l;
    const bool live = vi < vecs;
    const size_t col = (size_t)t * a.M + (size_t)vi * V;  // in (T, M)
    Packet<T, V> gq;
    if (live)
      load<false>(gamma + col, gq);
    else
      zero(gq);
    float ab[V], ag[V];
#pragma unroll
    for (int i = 0; i < V; ++i) ab[i] = ag[i] = 0.f;
    const int row0 = t * N;
    for (int n0 = 0; n0 < N; n0 += step) {
      Packet<T, V> dq[kRows], xq[kRows];
      float mu[kRows], rs[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int n = n0 + u * G + g;
        mu[u] = rs[u] = 0.f;
        zero(dq[u]);
        zero(xq[u]);
        if (n < N) {
          mu[u] = scalar(mean + row0 + n);
          rs[u] = scalar(rstd + row0 + n);
          if (live) {
            const size_t off = (size_t)(row0 + n) * a.M + (size_t)vi * V;
            load<false>(dz + off, dq[u]);
            load<false>(x + off, xq[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        float pg = 0.f, pgx = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = at(dq[u], i);
          const float xh = (at(xq[u], i) - mu[u]) * rs[u];
          const float gv = d * at(gq, i);
          ab[i] += d;
          ag[i] = fmaf(d, xh, ag[i]);
          pg += gv;
          pgx = fmaf(gv, xh, pgx);
        }
        // the warp's partials of the row: no barrier, each warp streams
        // on its own
        pg = warp_sum(pg);
        pgx = warp_sum(pgx);
        const int n = n0 + u * G + g;
        if (lane == 0 && n < N) {
          float* p = a.part + ((size_t)(row0 + n) * jw + j * wpg + wg) * 2;
          p[0] = pg;
          p[1] = pgx;
        }
      }
    }
    // dgamma and dbeta of the item's columns: the row groups in order
    if (G > 1) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        cols[2 * i][tid] = ag[i];
        cols[2 * i + 1][tid] = ab[i];
      }
      __syncthreads();
      if (g == 0 && live) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float sg = 0.f, sb = 0.f;
          for (int gg = 0; gg < G; ++gg) {
            sg += cols[2 * i][gg * a.tpr + l];
            sb += cols[2 * i + 1][gg * a.tpr + l];
          }
          ag[i] = sg;
          ab[i] = sb;
        }
      }
      __syncthreads();  // cols is free for the next item
    }
    if (g == 0 && live) {
      store<false>(static_cast<T*>(a.dgamma) + col, ag);
      store<false>(static_cast<T*>(a.dbeta) + col, ab);
    }
  }

  // -- (2) the row sums, a warp a row -------------------------------------
  cg::grid_group grid = cg::this_grid();
  grid.sync();
  const int R = a.T * N;
  for (int row = blockIdx.x * kWarps + warp; row < R;
       row += gridDim.x * kWarps) {
    const float* p = a.part + (size_t)row * jw * 2;
    float s0 = 0.f, s1 = 0.f;
    for (int e = lane; e < jw; e += 32) {
      s0 += __ldcg(p + 2 * e);
      s1 += __ldcg(p + 2 * e + 1);
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    if (lane == 0) {
      a.tot[2 * row] = s0;
      a.tot[2 * row + 1] = s1;
    }
  }
  grid.sync();

  // -- (3) dx, last item and last rows first ------------------------------
  const float inv_m = a.inv_m;
  const int batches = (N + step - 1) / step;
  for (int it = last - 1; it >= first; --it) {
    const int t = it / J, j = it - t * J;
    const int vi = j * a.tpr + l;
    if (vi >= vecs) continue;  // no __syncthreads below
    Packet<T, V> gq;
    load<false>(gamma + (size_t)t * a.M + (size_t)vi * V, gq);
    const int row0 = t * N;
    for (int b = batches - 1; b >= 0; --b) {
      const int n0 = b * step;
      Packet<T, V> dq[kRows], xq[kRows];
#pragma unroll
      for (int u = kRows - 1; u >= 0; --u) {
        const int n = n0 + u * G + g;
        if (n < N) {
          const size_t off = (size_t)(row0 + n) * a.M + (size_t)vi * V;
          load<true>(dz + off, dq[u]);
          load<true>(x + off, xq[u]);
        }
      }
#pragma unroll
      for (int u = kRows - 1; u >= 0; --u) {
        const int n = n0 + u * G + g;
        if (n >= N) continue;
        const int r = row0 + n;
        const float mu = scalar(mean + r), rs = scalar(rstd + r);
        const float m_g = __ldcg(a.tot + 2 * r) * inv_m;
        const float m_gx = __ldcg(a.tot + 2 * r + 1) * inv_m;
        float o[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xh = (at(xq[u], i) - mu) * rs;
          o[i] = rs * (at(dq[u], i) * at(gq, i) - m_g - xh * m_gx);
        }
        store<true>(static_cast<T*>(a.dx) + (size_t)r * a.M +
                        (size_t)vi * V,
                    o);
      }
    }
  }
}

// two blocks a SM at least (at most 128 registers a thread; four blocks of
// at most 64 ran slower in f32)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
    layer_norm_bwd_kernel(const BwdArgs a) {
  bwd_body<T, V>(a);
}

// -- layer_norm_bwd_bwd ----------------------------------------------------

struct BwdBwdArgs {
  const void* a;       // the cotangent of dx
  const void* ggamma;  // the cotangents of dgamma and dbeta (T, M)
  const void* gbeta;
  const void* dz;
  const void* x;
  const void* mean;
  const void* rstd;
  const void* gamma;
  void* g_dz;
  void* g_x;
  void* g_gamma;
  float* part;  // (R, kSums, J * tpr / 32): each row's (tile, warp)
                //  partials of each sum
  float* tot;   // (R, kCoefs), 16-byte aligned: each row's coefficients
  int T, N, M, tpr, groups, J, items;
  float inv_m;
};

// The double backward's row sums: sum a, a xhat, g, g xhat, a g, ggamma dz
// and ggamma dz xhat, with g = dz gamma; the coefficients of a row that
// the outputs take from them (two 16-byte loads).
constexpr int kSums = 7;
constexpr int kCoefs = 8;

template <typename T, int V>
__device__ __forceinline__ void bwd_bwd_body(const BwdBwdArgs& a) {
  // the row groups' column sums of g_gamma at the end of an item
  __shared__ float cols[V][kThreads];
  // the rows a row group has in flight, by the values a load takes (three
  // loads a row: 3 rows of f32 vectors and 2 of bf16 ones keep the
  // 128-register budget)
  constexpr int kRowsBB = V == 8 ? 2 : V == 4 ? 3 : 4;

  const T* av = static_cast<const T*>(a.a);
  const T* ggamma = static_cast<const T*>(a.ggamma);
  const T* gbeta = static_cast<const T*>(a.gbeta);
  const T* dz = static_cast<const T*>(a.dz);
  const T* x = static_cast<const T*>(a.x);
  const T* mean = static_cast<const T*>(a.mean);
  const T* rstd = static_cast<const T*>(a.rstd);
  const T* gamma = static_cast<const T*>(a.gamma);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = tid / a.tpr, l = tid - g * a.tpr;  // row group, its thread
  const int wpg = a.tpr / 32;                      // warps a row group
  const int G = a.groups, N = a.N, J = a.J;
  const int vecs = a.M / V;
  const int first = (int)((long long)blockIdx.x * a.items / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * a.items / gridDim.x);
  const int step = kRowsBB * G;  // rows a batch
  const int jw = J * wpg;        // a row's (tile, warp) partials of a sum
  const int wg = warp - g * wpg;

  // -- (1) the row partials, item by item ---------------------------------
  for (int it = first; it < last; ++it) {
    const int t = it / J, j = it - t * J;
    const int vi = j * a.tpr + l;
    const bool live = vi < vecs;
    const size_t col = (size_t)t * a.M + (size_t)vi * V;  // in (T, M)
    Packet<T, V> gq, ggq;
    zero(gq);
    zero(ggq);
    if (live) {
      load<false>(gamma + col, gq);
      load<false>(ggamma + col, ggq);
    }
    const int row0 = t * N;
    for (int n0 = 0; n0 < N; n0 += step) {
      Packet<T, V> aq[kRowsBB], dq[kRowsBB], xq[kRowsBB];
      float mu[kRowsBB], rs[kRowsBB];
#pragma unroll
      for (int u = 0; u < kRowsBB; ++u) {
        const int n = n0 + u * G + g;
        mu[u] = rs[u] = 0.f;
        zero(aq[u]);
        zero(dq[u]);
        zero(xq[u]);
        if (n < N) {
          mu[u] = scalar(mean + row0 + n);
          rs[u] = scalar(rstd + row0 + n);
          if (live) {
            const size_t off = (size_t)(row0 + n) * a.M + (size_t)vi * V;
            load<false>(av + off, aq[u]);
            load<false>(dz + off, dq[u]);
            load<false>(x + off, xq[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsBB; ++u) {
        float s[kSums];
#pragma unroll
        for (int k = 0; k < kSums; ++k) s[k] = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float ai = at(aq[u], i), d = at(dq[u], i);
          const float xh = (at(xq[u], i) - mu[u]) * rs[u];
          const float gv = d * at(gq, i), ggd = at(ggq, i) * d;
          s[0] += ai;
          s[1] = fmaf(ai, xh, s[1]);
          s[2] += gv;
          s[3] = fmaf(gv, xh, s[3]);
          s[4] = fmaf(ai, gv, s[4]);
          s[5] += ggd;
          s[6] = fmaf(ggd, xh, s[6]);
        }
        // the warp's partials of the row: no barrier, each warp streams
        // on its own
#pragma unroll
        for (int k = 0; k < kSums; ++k) s[k] = warp_sum(s[k]);
        const int n = n0 + u * G + g;
        if (lane == 0 && n < N) {
          float* p = a.part + (size_t)(row0 + n) * kSums * jw + j * wpg + wg;
#pragma unroll
          for (int k = 0; k < kSums; ++k) p[(size_t)k * jw] = s[k];
        }
      }
    }
  }

  // -- (2) the row sums and coefficients, a warp a row --------------------
  cg::grid_group grid = cg::this_grid();
  grid.sync();
  const int R = a.T * N;
  const float inv_m = a.inv_m;
  for (int row = blockIdx.x * kWarps + warp; row < R;
       row += gridDim.x * kWarps) {
    const float* p = a.part + (size_t)row * kSums * jw;
    float s[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] = 0.f;
    // lane l the partials l, l + 32, ... in order (unrolled: the loads of
    // four steps in flight)
#pragma unroll 4
    for (int e = lane; e < jw; e += 32)
#pragma unroll
      for (int k = 0; k < kSums; ++k) s[k] += __ldcg(p + (size_t)k * jw + e);
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] = warp_sum(s[k]);
    if (lane == 0) {
      const float m_a = s[0] * inv_m, m_ax = s[1] * inv_m;
      const float m_g = s[2] * inv_m, m_gx = s[3] * inv_m;
      const float m_ag = s[4] * inv_m, m_ggd = s[5] * inv_m;
      const float m_ggdx = s[6] * inv_m;
      const float rs = scalar(rstd + row);
      // mean(G) and mean(G xhat) of G = -r (a mean(g xhat) + g mean(a
      // xhat)) + ggamma dz, and the term through r
      float4* c = reinterpret_cast<float4*>(a.tot) + 2 * (size_t)row;
      c[0] = make_float4(scalar(mean + row), rs, m_a, m_ax);
      c[1] = make_float4(m_gx, -rs * (m_a * m_gx + m_g * m_ax) + m_ggd,
                         -2.0f * rs * m_ax * m_gx + m_ggdx,
                         m_ag - m_a * m_g - m_ax * m_gx);
    }
  }
  grid.sync();

  // -- (3) g_dz, g_x and g_gamma, last item and last rows first -------------
  const int batches = (N + step - 1) / step;
  for (int it = last - 1; it >= first; --it) {
    const int t = it / J, j = it - t * J;
    const int vi = j * a.tpr + l;
    const bool live = vi < vecs;  // a dead thread still meets the barriers
    const size_t col = (size_t)t * a.M + (size_t)vi * V;
    Packet<T, V> gq, ggq, gbq;
    zero(gq);
    zero(ggq);
    zero(gbq);
    if (live) {
      load<false>(gamma + col, gq);
      load<false>(ggamma + col, ggq);
      load<false>(gbeta + col, gbq);
    }
    float acc[V];  // sum over the group's rows of dz r P(a)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    const int row0 = t * N;
    for (int b = batches - 1; b >= 0; --b) {
      const int n0 = b * step;
      Packet<T, V> aq[kRowsBB], dq[kRowsBB], xq[kRowsBB];
#pragma unroll
      for (int u = kRowsBB - 1; u >= 0; --u) {
        const int n = n0 + u * G + g;
        if (n < N && live) {
          const size_t off = (size_t)(row0 + n) * a.M + (size_t)vi * V;
          load<true>(av + off, aq[u]);
          load<true>(dz + off, dq[u]);
          load<true>(x + off, xq[u]);
        }
      }
#pragma unroll
      for (int u = kRowsBB - 1; u >= 0; --u) {
        const int n = n0 + u * G + g;
        if (n >= N || !live) continue;
        const int r = row0 + n;
        const float4* c = reinterpret_cast<const float4*>(a.tot) + 2 * r;
        const float4 c0 = __ldcg(c), c1 = __ldcg(c + 1);
        const float mu = c0.x, rs = c0.y, m_a = c0.z, m_ax = c0.w;
        const float m_gx = c1.x, mean_g = c1.y, mean_gx = c1.z;
        const float cross = c1.w;
        float o_dz[V], o_x[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float ai = at(aq[u], i), d = at(dq[u], i);
          const float gm = at(gq, i), gg = at(ggq, i);
          const float xh = (at(xq[u], i) - mu) * rs;
          const float p_a = ai - m_a - xh * m_ax;
          o_dz[i] = gm * rs * p_a + gg * xh + at(gbq, i);
          acc[i] += d * rs * p_a;
          const float big_g = -rs * (ai * m_gx + d * gm * m_ax) + gg * d;
          o_x[i] =
              rs * (big_g - mean_g - xh * mean_gx) - xh * rs * rs * cross;
        }
        const size_t off = (size_t)r * a.M + (size_t)vi * V;
        store<true>(static_cast<T*>(a.g_dz) + off, o_dz);
        store<true>(static_cast<T*>(a.g_x) + off, o_x);
      }
    }
    // g_gamma of the item's columns: the row groups in order
    if (G > 1) {
#pragma unroll
      for (int i = 0; i < V; ++i) cols[i][tid] = acc[i];
      __syncthreads();
      if (g == 0 && live) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float s = 0.f;
          for (int h = 0; h < G; ++h) s += cols[i][h * a.tpr + l];
          acc[i] = s;
        }
      }
      __syncthreads();  // cols is free for the next item
    }
    if (g == 0 && live) store<false>(static_cast<T*>(a.g_gamma) + col, acc);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
    layer_norm_bwd_bwd_kernel(const BwdBwdArgs a) {
  bwd_bwd_body<T, V>(a);
}

// -- the entries -----------------------------------------------------------

using maml::aligned;
using maml::cdiv;
using maml::OnDevice;
using maml::ptr;

// the values a load takes: 16 bytes with `vec`, else one
inline int load_width(int bf16, int vec) {
  return vec ? (bf16 ? 8 : 4) : 1;
}

template <typename T, int V>
cudaError_t launch_stats(const StatsArgs& a, int warp_rows, int cluster,
                         int grid, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = warp_rows ? 1 : cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      warp_rows ? cudaLaunchKernelEx(&cfg, layer_norm_stats_warp_kernel<T, V>,
                                     a)
                : cudaLaunchKernelEx(
                      &cfg, layer_norm_stats_cluster_kernel<T, V>, a);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T, int V>
const void* bwd_kernel() {
  return reinterpret_cast<const void*>(layer_norm_bwd_kernel<T, V>);
}

const void* bwd_kernel_for(int bf16, int vec) {
  if (bf16)
    return vec ? bwd_kernel<bf16_t, 8>() : bwd_kernel<bf16_t, 1>();
  return vec ? bwd_kernel<float, 4>() : bwd_kernel<float, 1>();
}

template <typename T, int V>
const void* bwd_bwd_kernel() {
  return reinterpret_cast<const void*>(layer_norm_bwd_bwd_kernel<T, V>);
}

const void* bwd_bwd_kernel_for(int bf16, int vec) {
  if (bf16)
    return vec ? bwd_bwd_kernel<bf16_t, 8>() : bwd_bwd_kernel<bf16_t, 1>();
  return vec ? bwd_bwd_kernel<float, 4>() : bwd_bwd_kernel<float, 1>();
}

template <typename T, int V>
const void* fwd_kernel() {
  return reinterpret_cast<const void*>(layer_norm_fwd_kernel<T, V>);
}

const void* fwd_kernel_for(int bf16, int vec) {
  if (bf16)
    return vec ? fwd_kernel<bf16_t, 8>() : fwd_kernel<bf16_t, 1>();
  return vec ? fwd_kernel<float, 4>() : fwd_kernel<float, 1>();
}

}  // namespace

extern "C" {

// layer_norm_stats. The arguments come packed as 64-bit integers (one
// ctypes argument: the wrapper's host time is most of a call at the small
// maps), in the order of conv_block._ln_stats_args:
//   a[0..3]  x (R rows of M values, f32 or bf16 by bf16), and the R means,
//            variances and rstds of x's dtype
//   a[4..7]  R, M, bf16, vec (16-byte loads: M a multiple of their values
//            and x 16-byte aligned)
//   a[8..11] the plan (conv_block.ln_stats_plan): warp_rows (a warp a row,
//            grid = ceil(R / 8)), else a cluster of `cluster` blocks (1, 2,
//            4 or 8) a row, each `chunk` values (grid = R * cluster); grid
//   a[12..13] the device, the stream
// Refuses (launching nothing) a plan that does not match the shape. Returns
// the CUDA error, 0 on success.
int layer_norm_stats(const long long* a, float eps) {
  const int R = (int)a[4], M = (int)a[5], bf16 = (int)a[6], vec = (int)a[7];
  const int warp_rows = (int)a[8], cluster = (int)a[9], chunk = (int)a[10];
  const long long grid = a[11];
  const void* x = ptr<const void>(a[0]);
  const int v = load_width(bf16, vec);
  if (R < 1 || M < 1 || M % v || (vec && !aligned(x, 16)))
    return (int)cudaErrorInvalidValue;
  const int vecs = M / v;
  if (warp_rows) {
    if (vecs > kWarpRowVecs || cluster != 1 || grid != cdiv(R, kWarps))
      return (int)cudaErrorInvalidValue;
  } else {
    if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
        chunk < v || chunk % v || (long long)chunk * cluster < M ||
        (long long)chunk * (cluster - 1) >= M ||
        grid != (long long)R * cluster || grid > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
  }
  OnDevice on((int)a[12]);
  if (on.err != cudaSuccess) return (int)on.err;
  StatsArgs s = {x, ptr<void>(a[1]), ptr<void>(a[2]), ptr<void>(a[3]), R, M,
                 chunk, eps};
  cudaStream_t st = ptr<CUstream_st>(a[13]);
  cudaError_t err;
  if (bf16)
    err = vec ? launch_stats<bf16_t, 8>(s, warp_rows, cluster, (int)grid, st)
              : launch_stats<bf16_t, 1>(s, warp_rows, cluster, (int)grid, st);
  else
    err = vec ? launch_stats<float, 4>(s, warp_rows, cluster, (int)grid, st)
              : launch_stats<float, 1>(s, warp_rows, cluster, (int)grid, st);
  return (int)err;
}

// layer_norm_fwd, its arguments packed as 64-bit integers and passed by
// address (one ctypes argument; conv_block._packed), in the order of
// conv_block.layer_norm_fwd:
//   a[0..5]   x (T, N, M values), the (T, N) mean and rstd, the (T, M)
//             gamma and beta, z (T, N, M), all f32 or all bf16 by bf16
//   a[6..10]  T, N, M, bf16, vec (16-byte loads: M a multiple of their
//             values and x, gamma, beta and z 16-byte aligned)
//   a[11..12] the plan (conv_block.ln_fwd_plan): `tiles` blocks of 256
//             loads a row (ceil(M / values a load / 256)), the grid T N
//             tiles
//   a[13..14] the device, the stream
// Refuses (launching nothing) a plan that does not match the shape or
// vectors the pointers do not allow. Returns the CUDA error, 0 on success.
int layer_norm_fwd(const long long* a) {
  const int T = (int)a[6], N = (int)a[7], M = (int)a[8];
  const int bf16 = (int)a[9], vec = (int)a[10], tiles = (int)a[11];
  const long long grid = a[12];
  const int v = load_width(bf16, vec);
  if (T < 1 || N < 1 || M < 1 || M % v) return (int)cudaErrorInvalidValue;
  if (vec && !(aligned(ptr<void>(a[0]), 16) && aligned(ptr<void>(a[3]), 16) &&
               aligned(ptr<void>(a[4]), 16) && aligned(ptr<void>(a[5]), 16)))
    return (int)cudaErrorInvalidValue;
  if (tiles != cdiv(M / v, kThreads) ||
      grid != (long long)T * N * tiles || grid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  OnDevice on((int)a[13]);
  if (on.err != cudaSuccess) return (int)on.err;
  FwdArgs f = {ptr<const void>(a[0]), ptr<const void>(a[1]),
               ptr<const void>(a[2]), ptr<const void>(a[3]),
               ptr<const void>(a[4]), ptr<void>(a[5]), N, M / v, tiles};
  void* args[] = {&f};
  return maml::launch_error(cudaLaunchKernel(
      fwd_kernel_for(bf16, vec), dim3((unsigned)grid), dim3(kThreads), args,
      0, ptr<CUstream_st>(a[14])));
}

// The blocks of 256 threads a SM can hold of layer_norm_bwd's kernel
// (sums 2) or layer_norm_bwd_bwd's (sums 7) in f32 or bf16, with 16-byte
// loads or one value at a time: the plan's `blocks_per_sm` (the
// cooperative launch needs every block resident), on the current device.
int layer_norm_bwd_blocks_per_sm(int sums, int bf16, int vec, int* blocks) {
  if (sums != 2 && sums != kSums) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks,
      sums == 2 ? bwd_kernel_for(bf16, vec) : bwd_bwd_kernel_for(bf16, vec),
      kThreads, 0);
}

// layer_norm_bwd, its arguments packed as layer_norm_stats' (the order of
// conv_block._ln_bwd_args):
//   a[0..4]   dz and x (T, N, M values), the (T, N) mean and rstd, the
//             (T, M) gamma, all f32 or all bf16 by bf16
//   a[5..7]   dx (T, N, M), dgamma and dbeta (T, M)
//   a[8..9]   f32 scratch: part (T * N * J * tpr / 32 * 2) and tot (T *
//             N * 2)
//   a[10..14] T, N, M, bf16, vec (16-byte loads: M a multiple of their
//             values and every tensor of M values 16-byte aligned)
//   a[15..17] the plan (conv_block.ln_bwd_plan): tpr threads a row group
//             (32 .. 256, a power of two), J column tiles of tpr loads,
//             `blocks` (at most T * J; block b the items [b T J / blocks,
//             (b + 1) T J / blocks))
//   a[18..19] the device, the stream
// and inv_m = 1 / M. Refuses (launching nothing) a plan that does not match
// the shape or vectors the pointers do not allow. Returns the CUDA error, 0
// on success.
int layer_norm_bwd(const long long* a, float inv_m) {
  const int T = (int)a[10], N = (int)a[11], M = (int)a[12];
  const int bf16 = (int)a[13], vec = (int)a[14];
  const int tpr = (int)a[15], J = (int)a[16], blocks = (int)a[17];
  const int v = load_width(bf16, vec);
  if (T < 1 || N < 1 || M < 1 || M % v) return (int)cudaErrorInvalidValue;
  if (vec && !(aligned(ptr<void>(a[0]), 16) && aligned(ptr<void>(a[1]), 16) &&
               aligned(ptr<void>(a[4]), 16) && aligned(ptr<void>(a[5]), 16) &&
               aligned(ptr<void>(a[6]), 16) && aligned(ptr<void>(a[7]), 16)))
    return (int)cudaErrorInvalidValue;
  if (tpr < 32 || tpr > kThreads || (tpr & (tpr - 1)) ||
      J != cdiv(M / v, tpr) || (long long)T * J > 0x7fffffffLL ||
      blocks < 1 || blocks > T * J)
    return (int)cudaErrorInvalidValue;
  OnDevice on((int)a[18]);
  if (on.err != cudaSuccess) return (int)on.err;
  BwdArgs b = {ptr<const void>(a[0]), ptr<const void>(a[1]),
               ptr<const void>(a[2]), ptr<const void>(a[3]),
               ptr<const void>(a[4]), ptr<void>(a[5]), ptr<void>(a[6]),
               ptr<void>(a[7]), ptr<float>(a[8]), ptr<float>(a[9]),
               T, N, M, tpr, kThreads / tpr, J, T * J, inv_m};
  void* args[] = {&b};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      bwd_kernel_for(bf16, vec), dim3(blocks), dim3(kThreads), args, 0,
      ptr<CUstream_st>(a[19]));
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// layer_norm_bwd_bwd, its arguments packed as 64-bit integers and passed by
// address (conv_block._packed), in the order of
// conv_block.layer_norm_bwd_bwd:
//   a[0..7]   a, ggamma, gbeta, dz, x, mean, rstd, gamma: a, dz and x (T,
//             N, M values), the (T, N) mean and rstd, the (T, M) ggamma,
//             gbeta and gamma, all f32 or all bf16 by bf16
//   a[8..10]  g_dz and g_x (T, N, M), g_gamma (T, M)
//   a[11..12] f32 scratch: part (T * N * 7 * J * tpr / 32) and tot (T * N
//             * 8, 16-byte aligned)
//   a[13..17] T, N, M, bf16, vec (16-byte loads: M a multiple of their
//             values and every tensor of M values 16-byte aligned)
//   a[18..20] the plan (conv_block.ln_bwd_plan on this kernel's
//             occupancy): tpr, J, blocks, as layer_norm_bwd's
//   a[21..22] the device, the stream
// and inv_m = 1 / M. Refuses (launching nothing) a plan that does not match
// the shape or vectors the pointers do not allow. Returns the CUDA error, 0
// on success.
int layer_norm_bwd_bwd(const long long* a, float inv_m) {
  const int T = (int)a[13], N = (int)a[14], M = (int)a[15];
  const int bf16 = (int)a[16], vec = (int)a[17];
  const int tpr = (int)a[18], J = (int)a[19], blocks = (int)a[20];
  const int v = load_width(bf16, vec);
  if (T < 1 || N < 1 || M < 1 || M % v) return (int)cudaErrorInvalidValue;
  if (!aligned(ptr<void>(a[12]), 16)) return (int)cudaErrorInvalidValue;
  const int tensors[] = {0, 1, 2, 3, 4, 7, 8, 9, 10};  // of M values
  if (vec)
    for (int i : tensors)
      if (!aligned(ptr<void>(a[i]), 16)) return (int)cudaErrorInvalidValue;
  if (tpr < 32 || tpr > kThreads || (tpr & (tpr - 1)) ||
      J != cdiv(M / v, tpr) || (long long)T * J > 0x7fffffffLL ||
      blocks < 1 || blocks > T * J)
    return (int)cudaErrorInvalidValue;
  OnDevice on((int)a[21]);
  if (on.err != cudaSuccess) return (int)on.err;
  BwdBwdArgs b = {
      ptr<const void>(a[0]), ptr<const void>(a[1]), ptr<const void>(a[2]),
      ptr<const void>(a[3]), ptr<const void>(a[4]), ptr<const void>(a[5]),
      ptr<const void>(a[6]), ptr<const void>(a[7]), ptr<void>(a[8]),
      ptr<void>(a[9]),       ptr<void>(a[10]),      ptr<float>(a[11]),
      ptr<float>(a[12]),     T, N, M, tpr, kThreads / tpr, J, T * J, inv_m};
  void* args[] = {&b};
  return maml::launch_error(cudaLaunchCooperativeKernel(
      bwd_bwd_kernel_for(bf16, vec), dim3(blocks), dim3(kThreads), args, 0,
      ptr<CUstream_st>(a[22])));
}

}  // extern "C"
