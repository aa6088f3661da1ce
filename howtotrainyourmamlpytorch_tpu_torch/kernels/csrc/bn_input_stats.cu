// bn_input_stats: the batch statistics of a block INPUT per (tenant,
// channel) — the mean, the biased variance and rstd = 1 / sqrt(var + eps)
// — in f32 and bf16, one launch a call.
//
// Replaces (JAX package) howtotrainyourmamlpytorch_tpu/ops/functional.py::
// batch_norm :368, its statistics jnp.mean :422 and jnp.var :423 and
// lax.rsqrt :428, where models/vgg.py:243 calls it on the input of the
// norm-first block (block_order='norm_conv_relu'). The twin is
// ops/functional.py::bn_input_stats of the port; batch_norm_fwd/bwd/bwd_bwd
// (K2, K3, K5 at slope 1) take the statistics from here.
//
// x is (T, N, H, W, C), channels last: tenant t's E = N * H * W * C values
// lie in one run, the channel of value e being e mod C. Each (tenant,
// channel) reduces its P = N * H * W values into (count, mean, M2) with
// Chan's merge, which never forms E[x^2] - E[x]^2 on raw values (that
// cancels on pixels in [0, 1] with a mean near 0.45). bf16 loads bf16 and
// sums in f32; the mean and the variance are each rounded once, rstd is
// the f32 1 / sqrt of bf16(bf16(var) + eps), rounded once
// (maml::store_stats).
//
// Bound on an H100: bytes (3.35 TB/s; a few FLOPs a value). x is read
// once; the outputs are three (T, C) vectors. The largest input is the
// norm-first stage 1 (T = 8, N = 75, 42 x 42 x 48: 203 MB in f32).
//
// * Units. A thread takes UNITS of U loads of V values (V = 4 f32 or 8
//   bf16: 16 bytes; V = 1 where x is off 16-byte alignment or E is not a
//   whole number of loads), and its channels stay fixed across its units:
//   - "lanes", C a multiple of V (48 and 64): a unit is one load, V
//     consecutive channels; K = C / V units make a pixel, and a thread's
//     units are all the same slot mod K, so it holds V channels;
//   - "packed", C = 1 or 3 (the images): a unit is lcm(C, V) values (C =
//     3: three loads, 4 pixels in f32, 8 in bf16; C = 1: one load), and
//     value i of a unit has channel i mod C: every lane of every load is
//     live, and K = 1;
//   - "scalar": a unit is one value, K = C.
//   A tenant is a whole number of units (E a multiple of V, and C = 3
//   coprime to V, make E a multiple of lcm(C, V)). A block's live
//   threads are the largest multiple of K in 256; its units start at a
//   multiple of K and step by the live threads.
// * The fold. A thread loads G units (8, or 4 of three loads: 128 or 192
//   bytes in flight; half of that ran slower at the large maps) at a
//   time,
//   sums each channel's values of the group in (unit, value) order, takes
//   the group's mean (the sum times 1 / count, one division a group) and
//   its sum of squared deviations about it, and merges them into its
//   running (count, mean, M2). All its channels share the count, so the
//   merge's weight costs one division for all of them.
// * The block. Each thread's partials go to shared memory; L lanes a
//   channel (L the largest power of two <= 32 with C L <= 256: every
//   channel at once) merge the partials of the threads that hold it in
//   thread order (lane l the partials l, l + L, ..., then a shuffle tree
//   over the L lanes), into the block's (count, mean, M2) per channel.
//   Every merge is Chan's with one division (merge below; merges of two
//   divisions, maml::chan_merge, with a warp taking the channels in turn,
//   cost the grid route microseconds at every map).
// * Two routes, from conv_block.bn_stats_plan (a pure function of the
//   shape, the dtype, the vectors and the blocks a SM the occupancy query
//   reports): "block", a block a tenant, which stores the statistics
//   itself (a plain launch, no scratch, no barrier: the small maps); and
//   "grid", S blocks a tenant, each a chunk of its units, in one
//   cooperative launch of one wave of a block a SM, or two where a thread
//   gets >= 16 loads (two waves at the small maps, and more blocks a SM
//   or a grid a few blocks past a wave at any map, ran slower): the blocks
//   write their partials (T, S, 3, C) to f32 scratch, a grid barrier, then
//   a warp a (tenant, channel) merges the S partials in split order (lane
//   l the partials l, l + 32, ..., then a shuffle tree) and stores. The
//   grid T * S is at most the blocks the card holds at once.
// * Deterministic: every sum runs in the plan's fixed order and no float
//   atomics, so a second launch gives the first launch's bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn_stats_merge.cuh"
#include "vec_io.cuh"

namespace cg = cooperative_groups;

namespace {

using maml::at;
using maml::bf16_t;
using maml::load;
using maml::Packet;
using maml::zero;

constexpr int kThreads = 256;  // a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 256;     // the channels the kernel takes

// the modes (conv_block.BN_STATS_MODES)
enum Mode { kScalar = 0, kLanes = 1, kPacked1 = 2, kPacked3 = 3 };

struct Args {
  const void* x;
  void* mean;
  void* var;
  void* rstd;
  float* part;  // grid route: (T, S, 3, C) f32, each block's partials
  int T, C, E;  // E: a tenant's values (< 2^31)
  int units;    // a tenant's units: E / (U * V)
  int chunk;    // the units of a block (a multiple of K)
  int S;        // blocks a tenant
  int K;        // unit slots: a thread's units are its slot mod K
  int live;     // a block's live threads, a multiple of K
  int lanes;    // L: the lanes of a channel in the block's merge
  float eps;
};

struct Stat {
  float n, mean, m2;
};

// The statistics merged with (nb, mb, m2b) after them (Chan et al.), one
// division: from empty statistics the merge is exact (w = 1).
__device__ __forceinline__ void merge(Stat& c, float nb, float mb,
                                      float m2b) {
  if (nb == 0.f) return;
  const float nn = c.n + nb;
  const float w = nb / nn;
  const float d = mb - c.mean;
  c.mean = fmaf(d, w, c.mean);
  c.m2 += m2b + d * d * c.n * w;
  c.n = nn;
}

// Lane 0's (of each group of `width` lanes) merge of its group's
// statistics: a tree of strides width / 2 .. 1, each lane l merging lane
// l + stride after itself.
__device__ __forceinline__ Stat tree_merge(Stat c, int width) {
  for (int off = width >> 1; off; off >>= 1) {
    const float n = __shfl_down_sync(~0u, c.n, off, width);
    const float m = __shfl_down_sync(~0u, c.mean, off, width);
    const float q = __shfl_down_sync(~0u, c.m2, off, width);
    merge(c, n, m, q);
  }
  return c;
}

// Channel ch of tenant t stored from its (count, mean, M2).
template <typename T>
__device__ __forceinline__ void finish(const Args& a, int t, int ch,
                                       Stat st) {
  const int o = t * a.C + ch;
  maml::store_stats(static_cast<T*>(a.mean) + o, static_cast<T*>(a.var) + o,
                    static_cast<T*>(a.rstd) + o, st.mean, st.m2 / st.n,
                    a.eps);
}

// One block's item (tenant t, its units [first, end)) folded and merged
// into the block's per-channel statistics; with kGrid the block's partials
// go to scratch, then (after the grid barrier) a warp a (tenant, channel)
// merges the S partials and stores; without, the block stores.
// A unit is U loads of V values, CH channels a thread (value i of a unit
// has the thread's channel i mod CH).
template <typename T, int V, int U, int CH, bool kGrid>
__global__ void __launch_bounds__(kThreads, 2)
    bn_input_stats_kernel(const Args a) {
  constexpr int W = U * V;          // values a unit
  constexpr int PER = W / CH;       // values of one channel a unit
  // units a group (a merge): conv_block.BN_STATS_GROUP
  constexpr int G = U == 1 ? 8 : 4;
  __shared__ float sn[kThreads];
  __shared__ float sm[CH][kThreads];
  __shared__ float sq[CH][kThreads];

  const int tid = threadIdx.x;
  const int t = blockIdx.x / a.S, s = blockIdx.x - t * a.S;
  const T* x = static_cast<const T*>(a.x) + (size_t)t * a.E;
  const int first = s * a.chunk;
  const int end = (int)min((long long)first + a.chunk, (long long)a.units);
  const int step = a.live;

  float n = 0.f, mean[CH], m2[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) mean[c] = m2[c] = 0.f;
  if (tid < a.live) {
    for (int u0 = first + tid; u0 < end; u0 += G * step) {
      Packet<T, V> q[G][U];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int u = u0 + g * step;
#pragma unroll
        for (int j = 0; j < U; ++j) {
          if (u < end)
            load<false>(x + ((size_t)u * U + j) * V, q[g][j]);
          else
            zero(q[g][j]);
        }
      }
      const int live = min(G, (end - 1 - u0) / step + 1);
      const float nb = (float)(live * PER);
      const float inv = 1.f / nb;
      // each channel's sum in (unit, value) order; the dead units are 0
      float sum[CH], mb[CH], q2[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) sum[c] = q2[c] = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < W; ++i) sum[i % CH] += at(q[g][i / V], i % V);
#pragma unroll
      for (int c = 0; c < CH; ++c) mb[c] = sum[c] * inv;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g < live) {
#pragma unroll
          for (int i = 0; i < W; ++i) {
            const float d = at(q[g][i / V], i % V) - mb[i % CH];
            q2[i % CH] = fmaf(d, d, q2[i % CH]);
          }
        }
      }
      // the merge: one weight for every channel of the thread
      const float nn = n + nb;
      const float w = nb / nn;
      const float nw = n * w;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float d = mb[c] - mean[c];
        mean[c] = fmaf(d, w, mean[c]);
        m2[c] += q2[c] + d * d * nw;
      }
      n = nn;
    }
  }
  sn[tid] = n;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    sm[c][tid] = mean[c];
    sq[c][tid] = m2[c];
  }
  __syncthreads();

  // the block's statistics of each channel: L lanes a channel, over the
  // threads of its slot in thread order
  {
    const int L = a.lanes, per_slot = a.live / a.K;
    const int ch = tid / L, l = tid - ch * L;
    Stat st = {0.f, 0.f, 0.f};
    if (ch < a.C) {
      const int slot = ch / CH, j = ch - slot * CH;
      for (int i = l; i < per_slot; i += L) {
        const int th = slot + i * a.K;
        merge(st, sn[th], sm[j][th], sq[j][th]);
      }
    }
    st = tree_merge(st, L);
    if (l == 0 && ch < a.C) {
      if constexpr (kGrid) {
        float* p = a.part + (size_t)blockIdx.x * 3 * a.C + ch;
        p[0] = st.n;
        p[a.C] = st.mean;
        p[2 * a.C] = st.m2;
      } else {
        finish<T>(a, t, ch, st);
      }
    }
  }
  if constexpr (kGrid) {
    cg::this_grid().sync();
    // a warp a (tenant, channel): the S partials in split order
    const int lane = tid & 31, warp = tid >> 5;
    for (int p = blockIdx.x * kWarps + warp; p < a.T * a.C;
         p += gridDim.x * kWarps) {
      const int tt = p / a.C, ch = p - tt * a.C;
      Stat st = {0.f, 0.f, 0.f};
      for (int i = lane; i < a.S; i += 32) {
        const float* q = a.part + (size_t)(tt * a.S + i) * 3 * a.C + ch;
        merge(st, __ldcg(q), __ldcg(q + a.C), __ldcg(q + 2 * a.C));
      }
      st = tree_merge(st, 32);
      if (lane == 0) finish<T>(a, tt, ch, st);
    }
  }
}

// -- the entries -----------------------------------------------------------

using maml::aligned;
using maml::OnDevice;
using maml::ptr;

// the values a load takes (16 bytes) in the vector modes
inline int load_width(int bf16) { return bf16 ? 8 : 4; }

// The mode for C channels: scalar without 16-byte loads, lanes where C is
// a multiple of a load's values, packed at C = 1 and 3, scalar otherwise.
int mode_of(int C, int bf16, int vec) {
  if (!vec) return kScalar;
  if (C % load_width(bf16) == 0) return kLanes;
  if (C == 1) return kPacked1;
  if (C == 3) return kPacked3;
  return kScalar;
}

// (values a load, loads a unit, channels a thread) of a mode
void unit_of(int mode, int bf16, int* v, int* u, int* ch) {
  const int V = load_width(bf16);
  *v = mode == kScalar ? 1 : V;
  *u = mode == kPacked3 ? 3 : 1;
  *ch = mode == kScalar ? 1 : mode == kLanes ? V : mode == kPacked1 ? 1 : 3;
}

template <typename T, bool kGrid>
const void* kernel_of(int mode) {
  constexpr int V = sizeof(T) == 4 ? 4 : 8;
  switch (mode) {
    case kLanes:
      return reinterpret_cast<const void*>(
          bn_input_stats_kernel<T, V, 1, V, kGrid>);
    case kPacked1:
      return reinterpret_cast<const void*>(
          bn_input_stats_kernel<T, V, 1, 1, kGrid>);
    case kPacked3:
      return reinterpret_cast<const void*>(
          bn_input_stats_kernel<T, V, 3, 3, kGrid>);
    default:
      return reinterpret_cast<const void*>(
          bn_input_stats_kernel<T, 1, 1, 1, kGrid>);
  }
}

const void* kernel_for(int bf16, int mode, int grid_route) {
  if (bf16)
    return grid_route ? kernel_of<bf16_t, true>(mode)
                      : kernel_of<bf16_t, false>(mode);
  return grid_route ? kernel_of<float, true>(mode)
                    : kernel_of<float, false>(mode);
}

}  // namespace

extern "C" {

// The blocks of 256 threads a SM can hold of the grid route's kernel in
// f32 or bf16 and `mode` (conv_block.BN_STATS_MODES): the plan's
// `blocks_per_sm` (the cooperative launch needs every block resident), on
// the current device.
int bn_input_stats_blocks_per_sm(int bf16, int mode, int* blocks) {
  if (mode < kScalar || mode > kPacked3) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_for(bf16, mode, 1), kThreads, 0);
}

// bn_input_stats. The arguments come packed as 64-bit integers (one ctypes
// argument: a call's host time counts at the small maps), in the order of
// conv_block.bn_input_stats:
//   a[0..3]   x (T tenants of E values, f32 or bf16 by bf16), and the (T,
//             C) means, variances and rstds of x's dtype
//   a[4]      f32 scratch: the grid route's (T, S, 3, C) partials
//   a[5..8]   T, C, E (a multiple of C), bf16
//   a[9]      vec: the plan's 16-byte loads (x 16-byte aligned, E a
//             multiple of a load's values); the mode follows from C and
//             vec (mode_of, as conv_block.bn_stats_mode)
//   a[10..13] the plan (conv_block.bn_stats_plan): live threads a block,
//             chunk (units a block), S (blocks a tenant), grid
//   a[14..15] the device, the stream
// and eps (rounded to x's dtype). S = 1 is the block route (a plain
// launch, grid T), S > 1 the grid route (a cooperative launch, grid T S).
// Refuses (launching nothing) a plan that does not match the shape, or
// vectors the pointer does not allow. Returns the CUDA error, 0 on success.
int bn_input_stats(const long long* a, float eps) {
  const int T = (int)a[5], C = (int)a[6], E = (int)a[7], bf16 = (int)a[8];
  const int vec = (int)a[9], live = (int)a[10];
  const int chunk = (int)a[11], S = (int)a[12];
  const long long grid = a[13];
  const void* x = ptr<const void>(a[0]);
  if (T < 1 || C < 1 || C > kMaxC || E < C || E % C)
    return (int)cudaErrorInvalidValue;
  if (vec && (E % load_width(bf16) || !aligned(x, 16)))
    return (int)cudaErrorInvalidValue;
  const int mode = mode_of(C, bf16, vec);
  int V, U, CH;
  unit_of(mode, bf16, &V, &U, &CH);
  const int K = C / CH, units = E / (U * V);
  // every unit in one block's chunk, no block without one
  if (E % (U * V) || live != kThreads / K * K || chunk < 1 || chunk % K ||
      S < 1 || (long long)S * chunk < units ||
      (long long)(S - 1) * chunk >= units || grid != (long long)T * S ||
      grid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  OnDevice on((int)a[14]);
  if (on.err != cudaSuccess) return (int)on.err;
  int lanes = 32;  // the largest power of two <= 32 with C lanes <= 256
  while (lanes * C > kThreads) lanes >>= 1;
  Args args = {x, ptr<void>(a[1]), ptr<void>(a[2]), ptr<void>(a[3]),
               ptr<float>(a[4]), T, C, E, units, chunk, S, K, live, lanes,
               eps};
  void* params[] = {&args};
  const cudaStream_t st = ptr<CUstream_st>(a[15]);
  const void* k = kernel_for(bf16, mode, S > 1);
  const cudaError_t err =
      S > 1 ? cudaLaunchCooperativeKernel(k, dim3((unsigned)grid),
                                          dim3(kThreads), params, 0, st)
            : cudaLaunchKernel(k, dim3((unsigned)grid), dim3(kThreads),
                               params, 0, st);
  return maml::launch_error(err);
}

}  // extern "C"
