// K3 pool-free: the backward of batch norm (batch statistics) + leaky-ReLU
// with no pool, in f32 and bf16, one launch a call: the strided model's
// `bn_act_bwd`, and at slope 1 (the leaky-ReLU the identity) the
// norm-first block's standalone `batch_norm_bwd`.
//
// Replaces (JAX package) howtotrainyourmamlpytorch_tpu/ops/functional.py:
// the gradient XLA derives for `batch_norm` :368 with batch statistics
// (statistics :422-428, normalize + affine :429-430) and `leaky_relu` :363
// as `conv_bn_act` :249 composes them in the strided model
// (max_pooling=False), and the same gradient of the standalone batch norm
// that models/vgg.py:243 applies to the norm-first block's input. The
// twins: ops/functional.py::bn_act_bwd and ::batch_norm_bwd of the port.
//
// Per (tenant, channel), over the m = N * H * W positions: dz = da through
// the leaky slope at z's sign; dbeta = sum dz, dgamma = sum dz xhat; dy =
// gamma rstd (dz - dbeta / m - xhat dgamma / m). Returns dy, dgamma and
// dbeta, all three written here.
//
// Rounding. The masks are K2's decisions (bn_act_chain.cuh): f32 z =
// fma(xhat, gamma, beta) on xhat = (y - mean) * rstd; bf16 z by the chain,
// each op rounded to bf16. xhat, dz (da * slope on the negative side, in
// f32: exact in bf16) and the two sums stay f32; dy, dgamma and dbeta are
// each rounded once to the element type.
//
// Bound on an H100: bytes (3.35 TB/s; a few FLOPs an element, no tensor
// cores). The function must read da and y and write dy; the sums need
// every position before any output, so the design reads da and y twice:
// once to reduce, once to apply (the second read from shared memory where
// a block's chunk fits, else mostly from the 50 MB L2).
//
// * Units, as bn_input_stats.cu lays them out (conv_block.bn_act_bwd_plan,
//   the same plan as bn_stats_plan's): a thread takes UNITS of U loads of
//   V values (V = 4 f32 or 8 bf16: 16 bytes; V = 1 where a tensor is off
//   16-byte alignment or E is not a whole number of loads), its channels
//   fixed across its units: "lanes" (C a multiple of V: 48, 64; a unit V
//   consecutive channels, K = C / V slots), "packed" (C = 3 or 1, the
//   images: a unit lcm(C, V) values, value i of channel i mod C, every
//   lane live, K = 1), "scalar" (a value a unit, K = C). A block's live
//   threads are the largest multiple of K in 256, its units start at a
//   multiple of K and step by the live threads.
// * The reduce. A thread loads G units of da and y at a time (4, or 2 of
//   three loads), and sums dz and dz xhat of each of its channels in
//   (unit, value) order; plain f32 sums, the product by an FMA.
// * The block. The threads' sums go to shared memory; L lanes a channel (L
//   the largest power of two <= 32 with C L <= 256) sum the threads that
//   hold it in thread order (lane l the threads' sums l, l + L, ..., then a
//   shuffle tree).
// * Two routes, from the plan: "block", a block a tenant, which stores its
//   own dgamma and dbeta (no scratch, no barrier: the small maps); "grid",
//   S blocks a tenant in one cooperative launch (one wave of a block a SM,
//   or two where a thread gets >= 16 loads): the blocks' sums to f32
//   scratch (T, S, 2, C), a grid barrier, a warp a (tenant, sum, channel)
//   column sums its S partials in split order (lane l the partials l, l +
//   32, ..., then a shuffle tree) into (T, 2, C) f32 totals and stores
//   dgamma or dbeta, a second barrier, and every block reads its tenant's
//   totals.
// * The apply. A second pass over the thread's units, last first, so that
//   what the reduce read last is still in L2; evict-first loads, 16-byte
//   streaming stores of dy. Where a block's chunk of da and y fits in
//   shared memory (the grid route in one wave of a block a SM, 16-byte
//   loads, at most 200 KB: strided L1 and L2, the bf16 image, ...; the
//   plan's `stage` bytes), the reduce also stores each loaded packet to
//   the thread's own slots of dynamic shared memory and the apply reads
//   them back there, not from L2: 2-10% less device time where it applies
//   on an H100 (PERF.md §6). The sums' order is the same either way.
// * Deterministic: every sum runs in the plan's fixed order and no float
//   atomics, so a second launch gives the first launch's bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn_act_chain.cuh"
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
  const void* da;
  const void* y;
  const void* mean;
  const void* rstd;
  const void* gamma;
  const void* beta;
  void* dy;
  void* dgamma;
  void* dbeta;
  float* part;  // grid route: (T, S, 2, C) f32, each block's sums
  float* tot;   // grid route: (T, 2, C) f32, the merged sums
  int T, C, E;  // E: a tenant's values (< 2^31)
  int units;    // a tenant's units: E / (U * V)
  int chunk;    // the units of a block (a multiple of K)
  int S;        // blocks a tenant
  int K;        // unit slots: a thread's units are its slot mod K
  int live;     // a block's live threads, a multiple of K
  int lanes;    // L: the lanes of a channel in the block's sum
  float slope, inv_m;
};

// one value rounded to T and stored
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16_t* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The W values of one unit of da and y: xhat and dz (da through the slope
// at z's sign; z as K2 rounds it), channel i mod CH of value i.
template <typename T, int V, int U, int CH>
__device__ __forceinline__ void unit_terms(
    const Packet<T, V> (&qd)[U], const Packet<T, V> (&qy)[U],
    const float (&m)[CH], const float (&r)[CH], const float (&g)[CH],
    const float (&b)[CH], float slope, float (&xh)[U * V],
    float (&dz)[U * V]) {
  constexpr int W = U * V;
  float z[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    z[i] = at(qy[i / V], i % V);
    xh[i] = maml::bn_xhat(z[i], m[i % CH], r[i % CH]);
  }
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < W; ++i) z[i] = maml::bn_z(xh[i], g[i % CH], b[i % CH]);
  } else if constexpr (W == 1) {
    z[0] = maml::bn_z_bf16(z[0], m[0], r[0], g[0], b[0]);
  } else {
    static_assert(W % 2 == 0, "bf16 values go in pairs");
#pragma unroll
    for (int i = 0; i < W; i += 2) {
      const int j0 = i % CH, j1 = (i + 1) % CH;
      maml::bn_z_bf16_2(z[i], z[i + 1], m[j0], m[j1], r[j0], r[j1], g[j0],
                        g[j1], b[j0], b[j1]);
    }
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float d = at(qd[i / V], i % V);
    dz[i] = z[i] >= 0.f ? d : __fmul_rn(d, slope);
  }
}

// The whole call: reduce, the block's sums, (grid route: barrier, merge,
// barrier), apply. A unit is U loads of V values, CH channels a thread
// (value i of a unit has the thread's channel i mod CH).
// kStage: the thread's packets of da and y kept in dynamic shared memory
// from the reduce to the apply, load j of its k-th unit of tensor w at
// ((k U + j) 2 + w) live + tid.
template <typename T, int V, int U, int CH, bool kGrid, bool kStage>
__global__ void __launch_bounds__(kThreads, 2)
    bn_act_bwd_kernel(const Args a) {
  constexpr int W = U * V;  // values a unit
  // units a group: conv_block.BN_ACT_BWD_GROUP
  constexpr int G = U == 1 ? 4 : 2;
  extern __shared__ uint4 stage_raw[];
  [[maybe_unused]] Packet<T, V>* sp =
      reinterpret_cast<Packet<T, V>*>(stage_raw);
  __shared__ float ss[2][CH][kThreads];
  __shared__ float st[2][kMaxC];  // block route: the tenant's sums

  const int tid = threadIdx.x;
  const int t = blockIdx.x / a.S, s = blockIdx.x - t * a.S;
  const size_t base = (size_t)t * a.E;
  const T* da = static_cast<const T*>(a.da) + base;
  const T* y = static_cast<const T*>(a.y) + base;
  T* dy = static_cast<T*>(a.dy) + base;
  const int first = s * a.chunk;
  const int end = (int)min((long long)first + a.chunk, (long long)a.units);
  const int step = a.live;
  const bool alive = tid < a.live;
  const int c0 = (tid % a.K) * CH;  // the thread's first channel

  float m[CH], r[CH], g[CH], b[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) m[j] = r[j] = g[j] = b[j] = 0.f;
  if (alive) {
    const int tc = t * a.C + c0;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      m[j] = maml::scalar(static_cast<const T*>(a.mean) + tc + j);
      r[j] = maml::scalar(static_cast<const T*>(a.rstd) + tc + j);
      g[j] = maml::scalar(static_cast<const T*>(a.gamma) + tc + j);
      b[j] = maml::scalar(static_cast<const T*>(a.beta) + tc + j);
    }
  }

  // -- reduce: the thread's units in order ------------------------------
  float sd[CH], sx[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) sd[j] = sx[j] = 0.f;
  if (alive) {
    int kk = 0;
    for (int u0 = first + tid; u0 < end; u0 += G * step, kk += G) {
      Packet<T, V> qd[G][U], qy[G][U];
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int u = u0 + k * step;
#pragma unroll
        for (int j = 0; j < U; ++j) {
          if (u < end) {
            const size_t o = ((size_t)u * U + j) * V;
            load<false>(da + o, qd[k][j]);
            load<false>(y + o, qy[k][j]);
          } else {
            zero(qd[k][j]);
            zero(qy[k][j]);
          }
        }
      }
      if constexpr (kStage) {
#pragma unroll
        for (int k = 0; k < G; ++k)
          if (u0 + k * step < end)
#pragma unroll
            for (int j = 0; j < U; ++j) {
              sp[(((kk + k) * U + j) * 2) * a.live + tid] = qd[k][j];
              sp[(((kk + k) * U + j) * 2 + 1) * a.live + tid] = qy[k][j];
            }
      }
#pragma unroll
      for (int k = 0; k < G; ++k) {
        if (u0 + k * step < end) {
          float xh[W], dz[W];
          unit_terms<T, V, U, CH>(qd[k], qy[k], m, r, g, b, a.slope, xh, dz);
#pragma unroll
          for (int i = 0; i < W; ++i) {
            sd[i % CH] += dz[i];
            sx[i % CH] = fmaf(dz[i], xh[i], sx[i % CH]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    ss[0][j][tid] = sd[j];
    ss[1][j][tid] = sx[j];
  }
  __syncthreads();

  // -- the block's sums of each channel: L lanes a channel, over the
  // threads of its slot in thread order --------------------------------
  {
    const int L = a.lanes, per_slot = a.live / a.K;
    const int ch = tid / L, l = tid - ch * L;
    float s0 = 0.f, s1 = 0.f;
    if (ch < a.C) {
      const int slot = ch / CH, j = ch - slot * CH;
      for (int i = l; i < per_slot; i += L) {
        const int th = slot + i * a.K;
        s0 += ss[0][j][th];
        s1 += ss[1][j][th];
      }
    }
    for (int off = L >> 1; off; off >>= 1) {
      s0 += __shfl_down_sync(~0u, s0, off, L);
      s1 += __shfl_down_sync(~0u, s1, off, L);
    }
    if (l == 0 && ch < a.C) {
      if constexpr (kGrid) {
        float* p = a.part + (size_t)blockIdx.x * 2 * a.C + ch;
        p[0] = s0;
        p[a.C] = s1;
      } else {
        put(static_cast<T*>(a.dbeta) + t * a.C + ch, s0);
        put(static_cast<T*>(a.dgamma) + t * a.C + ch, s1);
        st[0][ch] = s0;
        st[1][ch] = s1;
      }
    }
  }
  float tdz[CH], tdx[CH];  // the tenant's sum dz and sum dz xhat
  if constexpr (kGrid) {
    cg::this_grid().sync();
    // a warp a (tenant, sum, channel) column: its S partials in split
    // order
    const int lane = tid & 31, warp = tid >> 5;
    for (int p = blockIdx.x * kWarps + warp; p < a.T * 2 * a.C;
         p += gridDim.x * kWarps) {
      const int tt = p / (2 * a.C), k = (p - tt * 2 * a.C) / a.C;
      const int ch = p - (tt * 2 + k) * a.C;
      float sum = 0.f;
      for (int i = lane; i < a.S; i += 32)
        sum += __ldcg(a.part + ((size_t)(tt * a.S + i) * 2 + k) * a.C + ch);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_down_sync(~0u, sum, off);
      if (lane == 0) {
        a.tot[p] = sum;
        put(static_cast<T*>(k ? a.dgamma : a.dbeta) + tt * a.C + ch, sum);
      }
    }
    cg::this_grid().sync();
    if (!alive) return;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      tdz[j] = __ldcg(a.tot + (size_t)t * 2 * a.C + c0 + j);
      tdx[j] = __ldcg(a.tot + ((size_t)t * 2 + 1) * a.C + c0 + j);
    }
  } else {
    __syncthreads();
    if (!alive) return;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      tdz[j] = st[0][c0 + j];
      tdx[j] = st[1][c0 + j];
    }
  }

  // -- apply: the thread's units, last first ----------------------------
  float grs[CH], mdz[CH], mdx[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    grs[j] = g[j] * r[j];
    mdz[j] = tdz[j] * a.inv_m;
    mdx[j] = tdx[j] * a.inv_m;
  }
  const int mine = end - first - tid;
  if (mine <= 0) return;
  for (int k0 = (mine - 1) / step; k0 >= 0; k0 -= G) {
    Packet<T, V> qd[G][U], qy[G][U];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int u = first + tid + (k0 - k) * step;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (k0 - k >= 0) {
          if constexpr (kStage) {
            qd[k][j] = sp[(((k0 - k) * U + j) * 2) * a.live + tid];
            qy[k][j] = sp[(((k0 - k) * U + j) * 2 + 1) * a.live + tid];
          } else {
            const size_t o = ((size_t)u * U + j) * V;
            load<true>(da + o, qd[k][j]);
            load<true>(y + o, qy[k][j]);
          }
        } else {
          zero(qd[k][j]);
          zero(qy[k][j]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      if (k0 - k >= 0) {
        const int u = first + tid + (k0 - k) * step;
        float xh[W], dz[W];
        unit_terms<T, V, U, CH>(qd[k], qy[k], m, r, g, b, a.slope, xh, dz);
#pragma unroll
        for (int j = 0; j < U; ++j) {
          float o[V];
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const int v = j * V + i, c = v % CH;
            o[i] = grs[c] * fmaf(-xh[v], mdx[c], dz[v] - mdz[c]);
          }
          maml::store<true>(dy + ((size_t)u * U + j) * V, o);
        }
      }
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
// a multiple of a load's values, packed at C = 1 and 3, scalar otherwise
// (conv_block.bn_stats_mode).
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

template <typename T, bool kGrid, bool kStage>
const void* kernel_of(int mode) {
  constexpr int V = sizeof(T) == 4 ? 4 : 8;
  switch (mode) {
    case kLanes:
      return reinterpret_cast<const void*>(
          bn_act_bwd_kernel<T, V, 1, V, kGrid, kStage>);
    case kPacked1:
      return reinterpret_cast<const void*>(
          bn_act_bwd_kernel<T, V, 1, 1, kGrid, kStage>);
    case kPacked3:
      return reinterpret_cast<const void*>(
          bn_act_bwd_kernel<T, V, 3, 3, kGrid, kStage>);
    default:
      return reinterpret_cast<const void*>(
          bn_act_bwd_kernel<T, 1, 1, 1, kGrid, false>);
  }
}

const void* kernel_for(int bf16, int mode, int grid_route, int stage) {
  if (stage)
    return bf16 ? kernel_of<bf16_t, true, true>(mode)
                : kernel_of<float, true, true>(mode);
  if (bf16)
    return grid_route ? kernel_of<bf16_t, true, false>(mode)
                      : kernel_of<bf16_t, false, false>(mode);
  return grid_route ? kernel_of<float, true, false>(mode)
                    : kernel_of<float, false, false>(mode);
}

}  // namespace

extern "C" {

// The blocks of 256 threads a SM can hold of the grid route's kernel in
// f32 or bf16 and `mode` (conv_block.BN_STATS_MODES): the plan's
// `blocks_per_sm` (the cooperative launch needs every block resident), on
// the current device.
int bn_act_bwd_blocks_per_sm(int bf16, int mode, int* blocks) {
  if (mode < kScalar || mode > kPacked3) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_for(bf16, mode, 1, 0), kThreads, 0);
}

// K3 pool-free. The arguments come packed as 64-bit integers, by address
// (a call's host time counts at the small maps), in the order of
// conv_block._launch_act_bwd:
//   a[0..5]   da and y (T tenants of E values, f32 or bf16 by bf16), the
//             (T, C) mean, rstd, gamma and beta of y's dtype
//   a[6..8]   the outputs: dy (as y), dgamma and dbeta (T, C)
//   a[9..10]  f32 scratch of the grid route: (T, S, 2, C) partials, (T,
//             2, C) totals
//   a[11..14] T, C, E (a multiple of C), bf16
//   a[15]     vec: the plan's 16-byte loads (da, y and dy 16-byte aligned,
//             E a multiple of a load's values); the mode follows from C
//             and vec (mode_of, as conv_block.bn_stats_mode)
//   a[16..19] the plan (conv_block.bn_act_bwd_plan): live threads a
//             block, chunk (units a block), S (blocks a tenant), grid
//   a[20..21] the device, the stream
//   a[22]     the plan's stage: the dynamic shared memory a block keeps its
//             packets of da and y in (the grid route in vectors), or 0
// and the slope (rounded to y's dtype; 1 for batch_norm_bwd) and 1 / m.
// S = 1 is the block route (a plain launch, grid T), S > 1 the grid route
// (a cooperative launch, grid T S). Refuses (launching nothing) a plan that
// does not match the shape, a stage too small for the chunk, or vectors
// the pointers do not allow. Returns the CUDA error, 0 on success.
int bn_act_bwd(const long long* a, float slope, float inv_m) {
  const int T = (int)a[11], C = (int)a[12], E = (int)a[13];
  const int bf16 = (int)a[14], vec = (int)a[15], live = (int)a[16];
  const int chunk = (int)a[17], S = (int)a[18];
  const long long grid = a[19];
  const int stage = (int)a[22];
  const void* da = ptr<const void>(a[0]);
  const void* y = ptr<const void>(a[1]);
  void* dy = ptr<void>(a[6]);
  if (T < 1 || C < 1 || C > kMaxC || E < C || E % C)
    return (int)cudaErrorInvalidValue;
  if (vec && (E % load_width(bf16) || !aligned(da, 16) || !aligned(y, 16) ||
              !aligned(dy, 16)))
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
  // a stage holds every packet of the thread's units, on the grid route
  if (stage < 0 ||
      (stage && (S < 2 || mode == kScalar ||
                 stage < (long long)((chunk + live - 1) / live) * U * 2 *
                             live * (int)sizeof(uint4))))
    return (int)cudaErrorInvalidValue;
  OnDevice on((int)a[20]);
  if (on.err != cudaSuccess) return (int)on.err;
  int lanes = 32;  // the largest power of two <= 32 with C lanes <= 256
  while (lanes * C > kThreads) lanes >>= 1;
  Args args = {da,
               y,
               ptr<const void>(a[2]),
               ptr<const void>(a[3]),
               ptr<const void>(a[4]),
               ptr<const void>(a[5]),
               dy,
               ptr<void>(a[7]),
               ptr<void>(a[8]),
               ptr<float>(a[9]),
               ptr<float>(a[10]),
               T,
               C,
               E,
               units,
               chunk,
               S,
               K,
               live,
               lanes,
               slope,
               inv_m};
  void* params[] = {&args};
  const cudaStream_t st = ptr<CUstream_st>(a[21]);
  const void* k = kernel_for(bf16, mode, S > 1, stage > 0);
  if (stage) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, stage);
    if (e != cudaSuccess) return (int)e;
  }
  const cudaError_t err =
      S > 1 ? cudaLaunchCooperativeKernel(k, dim3((unsigned)grid),
                                          dim3(kThreads), params,
                                          (size_t)stage, st)
            : cudaLaunchKernel(k, dim3((unsigned)grid), dim3(kThreads),
                               params, 0, st);
  return maml::launch_error(err);
}

}  // extern "C"
