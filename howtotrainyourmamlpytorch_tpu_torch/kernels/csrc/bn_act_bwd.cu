// K3 and K5 pool-free: the backward of batch norm (batch statistics) +
// leaky-ReLU with no pool, and the derivative of that backward, in f32 and
// bf16, one launch a call each: the strided model's `bn_act_bwd` and
// `bn_act_bwd_bwd`, and at slope 1 (the leaky-ReLU the identity) the
// norm-first block's standalone `batch_norm_bwd` and `batch_norm_bwd_bwd`.
//
// Replaces (JAX package) howtotrainyourmamlpytorch_tpu/ops/functional.py:
// the gradient XLA derives for `batch_norm` :368 with batch statistics
// (statistics :422-428, normalize + affine :429-430) and `leaky_relu` :363
// as `conv_bn_act` :249 composes them in the strided model
// (max_pooling=False), and the same gradient of the standalone batch norm
// that models/vgg.py:243 applies to the norm-first block's input (K3); and
// the second derivative XLA derives for the same when core/maml.py
// ::_task_learner :149 differentiates the inner loop (K5). The twins:
// ops/functional.py::bn_act_bwd, ::batch_norm_bwd, ::bn_act_bwd_bwd and
// ::batch_norm_bwd_bwd of the port.
//
// K3. Per (tenant, channel), over the m = N * H * W positions: dz = da
// through the leaky slope at z's sign; dbeta = sum dz, dgamma = sum dz
// xhat; dy = gamma rstd (dz - dbeta / m - xhat dgamma / m). Returns dy,
// dgamma and dbeta, all three written here.
//
// K5. From the cotangents a of K3's dy, ggamma of dgamma and gbeta of
// dbeta, the gradients with respect to da, y (through the statistics too)
// and gamma (beta's is 0: it enters only through the masks). With the five
// sums of a (tenant, channel), S_a = sum a, S_ax = sum a xhat, S_dz = sum
// dz, S_dzx = sum dz xhat, S_adz = sum a dz, their means m_* = S_* / m and
//   cross   = S_adz - (m_a S_dz + m_ax S_dzx),  grs = gamma rstd,
//   mean_g  = -grs (m_dzx m_a + m_ax m_dz) + ggamma m_dz,
//   mean_gx = -2 grs m_ax m_dzx + ggamma m_dzx,  lr = rstd^2 gamma cross / m,
// every position gives
//   g_da = (grs (a - m_a - xhat m_ax) + ggamma xhat + gbeta), slope-masked,
//   G    = -grs (m_dzx a + m_ax dz) + ggamma dz,
//   g_y  = rstd (G - mean_g - xhat mean_gx) - xhat lr,
// and g_gamma = rstd cross (the pooled K5's formulas and order of
// operations, bn_act_pool_bwd.cu, with dz at every position).
//
// Rounding. The masks are K2's decisions (bn_act_chain.cuh): f32 z =
// fma(xhat, gamma, beta) on xhat = (y - mean) * rstd; bf16 z by the chain,
// each op rounded to bf16. xhat, dz (da * slope on the negative side, in
// f32: exact in bf16) and the sums stay f32; dy, dgamma and dbeta (K3),
// g_da, g_y and g_gamma (K5) are each rounded once to the element type.
//
// Bound on an H100: bytes (3.35 TB/s; a few FLOPs an element, no tensor
// cores). K3 must read da and y and write dy; K5 must read a, da and y and
// write g_da and g_y. The sums need every position before any output, so
// the design reads the inputs twice: once to reduce, once to apply (the
// second read from shared memory where a block's chunk fits, else mostly
// from the 50 MB L2): at most 5/8 (K5) or 3/5 (K3) of the bound where the
// second read comes from device memory.
//
// * Units, as bn_input_stats.cu lays them out (conv_block.bn_act_bwd_plan
//   and bn_act_bwd_bwd_plan, the layout of bn_stats_plan): a thread takes
//   UNITS of U loads of V values (V = 4 f32 or 8 bf16: 16 bytes; V = 1
//   where a tensor is off 16-byte alignment or E is not a whole number of
//   loads), its channels fixed across its units: "lanes" (C a multiple of
//   V: 48, 64; a unit V consecutive channels, K = C / V slots), "packed"
//   (C = 3 or 1, the images: a unit lcm(C, V) values, value i of channel i
//   mod C, every lane live, K = 1), "scalar" (a value a unit, K = C). A
//   block's live threads are the largest multiple of K in 256, its units
//   start at a multiple of K and step by the live threads.
// * The reduce. A thread loads G units of its tensors at a time (K3: 4,
//   or 2 of three loads; K5: 2, or 1 of three loads), and sums each of its
//   channels' sums in (unit, value) order; plain f32 sums, each product by
//   an FMA.
// * The block. The threads' sums go to shared memory (K5 one sum at a
//   time: five rounds through one buffer); L lanes a channel (L the
//   largest power of two <= 32 with C L <= 256) sum the threads that hold
//   it in thread order (lane l the threads' sums l, l + L, ..., then a
//   shuffle tree).
// * Two routes, from the plan: "block", a block a tenant, which stores its
//   own (T, C) outputs (no scratch, no barrier: the small maps); "grid", S
//   blocks a tenant in one cooperative launch (one wave of a block a SM,
//   or two where a thread gets >= 16 loads): the blocks' sums to f32
//   scratch (T, S, sums, C), a grid barrier, a warp a (tenant, sum,
//   channel) column sums its S partials in split order (lane l the
//   partials l, l + 32, ..., then a shuffle tree) into (T, sums, C) f32
//   totals (K3: and stores dgamma or dbeta), a second barrier, and every
//   block reads its tenant's totals (K5: the tenant's first block stores
//   g_gamma).
// * K5's per-channel values (mean, rstd, gamma and beta for the masks,
//   then the apply's nine coefficients) live in a (13, C) table of shared
//   memory, which a thread reads for its channels four at a time where it
//   uses them (volatile loads, not hoisted into registers): five sums of
//   eight bf16 channels, the tables and two units in flight would not fit
//   128 registers a thread.
// * The apply. A second pass over the thread's units, last first, so that
//   what the reduce read last is still in L2; evict-first loads, 16-byte
//   streaming stores. Where a block's chunk of the inputs fits in shared
//   memory (the grid route in one wave of a block a SM, 16-byte loads, at
//   most 200 KB (K3) or 201 KB (K5): strided L1 and L2, the bf16 image,
//   ...; the plan's `stage` bytes), the reduce also stores each loaded
//   packet to the thread's own slots of dynamic shared memory and the
//   apply reads them back there, not from L2: 2-10% less device time where
//   it applies to K3 on an H100 (PERF.md §6). The sums' order is the same
//   either way.
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

// -- K5 pool-free -------------------------------------------------------------

constexpr int kSums5 = 5;    // sum a, a xhat, dz, dz xhat, a dz
constexpr int kCoefs5 = 13;  // a channel's table rows (below)
// the rows of K5's per-channel table: mean, rstd, gamma, beta (the masks);
// then the apply's coefficients (the block route keeps its five sums in
// rows 4-8 until it computes them)
enum Row5 {
  kMean = 0, kRstd, kGamma, kBeta, kGrs, kMa, kMax, kGg, kGb, kMdzx,
  kMeanG, kMeanGx, kLr
};

struct Args5 {
  const void* a;  // the cotangent of K3's dy
  const void* da;
  const void* y;
  const void* mean;
  const void* rstd;
  const void* gamma;
  const void* beta;
  const void* ggamma;
  const void* gbeta;
  void* g_da;
  void* g_y;
  void* g_gamma;
  float* part;  // grid route: (T, S, 5, C) f32, each block's sums
  float* tot;   // grid route: (T, 5, C) f32, the merged sums
  int T, C, E;  // E: a tenant's values (< 2^31)
  int units;    // a tenant's units: E / (U * V)
  int chunk;    // the units of a block (a multiple of K)
  int S;        // blocks a tenant
  int K;        // unit slots: a thread's units are its slot mod K
  int live;     // a block's live threads, a multiple of K
  int lanes;    // L: the lanes of a channel in the block's sum
  float slope, inv_m;
};

// Q consecutive floats of a row of shared memory, each a volatile load:
// kept where it is written, so that a table read in a loop is not hoisted
// into registers for the whole loop
template <int Q>
__device__ __forceinline__ void lds(const float* p, float (&v)[Q]) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  if constexpr (Q == 4) {
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                 : "r"(s));
  } else {
#pragma unroll
    for (int i = 0; i < Q; ++i)
      asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[i]) : "r"(s + 4 * i));
  }
}

// The values a pass of K5 takes at once: a pair in bf16, whose chain
// rounds a pair a conversion, else one.
template <typename T, int W>
constexpr int kPair = sizeof(T) == 2 && W > 1 ? 2 : 1;

// unit_terms for the P values i, i + 1, ... of one unit, whose channel j
// (the thread's channel i mod CH less q0) is in the chunk of Q channels
// whose mean, rstd, gamma and beta are given: xhat, dz, and z's side (K2's
// decision).
template <typename T, int V, int U, int CH, int Q, int P>
__device__ __forceinline__ void terms(
    const Packet<T, V> (&qd)[U], const Packet<T, V> (&qy)[U], int i, int q0,
    const float (&m)[Q], const float (&r)[Q], const float (&g)[Q],
    const float (&b)[Q], float slope, float (&xh)[P], float (&dz)[P],
    bool (&pos)[P]) {
  float z[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int j = (i + p) % CH - q0;
    z[p] = at(qy[(i + p) / V], (i + p) % V);
    xh[p] = maml::bn_xhat(z[p], m[j], r[j]);
  }
  if constexpr (sizeof(T) == 4) {
    const int j = i % CH - q0;
    z[0] = maml::bn_z(xh[0], g[j], b[j]);
  } else if constexpr (P == 1) {
    z[0] = maml::bn_z_bf16(z[0], m[0], r[0], g[0], b[0]);
  } else {
    const int j0 = i % CH - q0, j1 = (i + 1) % CH - q0;
    maml::bn_z_bf16_2(z[0], z[1], m[j0], m[j1], r[j0], r[j1], g[j0], g[j1],
                      b[j0], b[j1]);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float d = at(qd[(i + p) / V], (i + p) % V);
    pos[p] = z[p] >= 0.f;
    dz[p] = pos[p] ? d : __fmul_rn(d, slope);
  }
}

// The whole call: reduce, the block's sums, (grid route: barrier, merge,
// barrier), the coefficients, apply. A unit is U loads of V values, CH
// channels a thread (value i of a unit has the thread's channel i mod CH),
// their table read Q channels at a time, the values taken P at a time
// (each output load stored as its last values are done: few registers
// hold outputs).
// kStage: the thread's packets of a, da and y kept in dynamic shared
// memory from the reduce to the apply, load j of its k-th unit of tensor w
// at ((k U + j) 3 + w) live + tid.
template <typename T, int V, int U, int CH, bool kGrid, bool kStage>
__global__ void __launch_bounds__(kThreads, 2)
    bn_act_bwd_bwd_kernel(const Args5 a) {
  constexpr int W = U * V;  // values a unit
  constexpr int Q = CH % 4 == 0 ? 4 : CH;  // channels a table load
  constexpr int P = kPair<T, W>;          // values a pass
  static_assert(Q % P == 0 || Q == CH, "a pair in one chunk");
  // units a group: conv_block.BN_ACT_BWD_BWD_GROUP
  constexpr int G5 = U == 1 ? 2 : 1;
  extern __shared__ uint4 stage_raw[];
  [[maybe_unused]] Packet<T, V>* sp =
      reinterpret_cast<Packet<T, V>*>(stage_raw);
  __shared__ float ss[CH][kThreads];
  __shared__ __align__(16) float cst[kCoefs5][kMaxC];

  const int tid = threadIdx.x;
  const int t = blockIdx.x / a.S, s = blockIdx.x - t * a.S;
  const size_t base = (size_t)t * a.E;
  const T* av = static_cast<const T*>(a.a) + base;
  const T* da = static_cast<const T*>(a.da) + base;
  const T* y = static_cast<const T*>(a.y) + base;
  T* gda = static_cast<T*>(a.g_da) + base;
  T* gy = static_cast<T*>(a.g_y) + base;
  const int first = s * a.chunk;
  const int end = (int)min((long long)first + a.chunk, (long long)a.units);
  const int step = a.live;
  const bool alive = tid < a.live;
  const int c0 = (tid % a.K) * CH;  // the thread's first channel

  for (int c = tid; c < a.C; c += kThreads) {
    const int tc = t * a.C + c;
    cst[kMean][c] = maml::scalar(static_cast<const T*>(a.mean) + tc);
    cst[kRstd][c] = maml::scalar(static_cast<const T*>(a.rstd) + tc);
    cst[kGamma][c] = maml::scalar(static_cast<const T*>(a.gamma) + tc);
    cst[kBeta][c] = maml::scalar(static_cast<const T*>(a.beta) + tc);
  }
  __syncthreads();

  // -- reduce: the thread's units in order ------------------------------
  float acc[kSums5][CH];
#pragma unroll
  for (int k = 0; k < kSums5; ++k)
#pragma unroll
    for (int j = 0; j < CH; ++j) acc[k][j] = 0.f;
  if (alive) {
    int kk = 0;
    for (int u0 = first + tid; u0 < end; u0 += G5 * step, kk += G5) {
      Packet<T, V> qa[G5][U], qd[G5][U], qy[G5][U];
#pragma unroll
      for (int k = 0; k < G5; ++k) {
        const int u = u0 + k * step;
#pragma unroll
        for (int j = 0; j < U; ++j) {
          if (u < end) {
            const size_t o = ((size_t)u * U + j) * V;
            load<false>(av + o, qa[k][j]);
            load<false>(da + o, qd[k][j]);
            load<false>(y + o, qy[k][j]);
          } else {
            zero(qa[k][j]);
            zero(qd[k][j]);
            zero(qy[k][j]);
          }
        }
      }
      if constexpr (kStage) {
#pragma unroll
        for (int k = 0; k < G5; ++k)
          if (u0 + k * step < end)
#pragma unroll
            for (int j = 0; j < U; ++j) {
              const int o = ((kk + k) * U + j) * 3;
              sp[o * a.live + tid] = qa[k][j];
              sp[(o + 1) * a.live + tid] = qd[k][j];
              sp[(o + 2) * a.live + tid] = qy[k][j];
            }
      }
#pragma unroll
      for (int k = 0; k < G5; ++k) {
        if (u0 + k * step < end) {
#pragma unroll
          for (int q0 = 0; q0 < CH; q0 += Q) {
            float m[Q], r[Q], g[Q], b[Q];
            lds<Q>(&cst[kMean][c0 + q0], m);
            lds<Q>(&cst[kRstd][c0 + q0], r);
            lds<Q>(&cst[kGamma][c0 + q0], g);
            lds<Q>(&cst[kBeta][c0 + q0], b);
#pragma unroll
            for (int i = 0; i < W; i += P) {
              if (i % CH < q0 || i % CH >= q0 + Q) continue;
              float xh[P], dz[P];
              bool pos[P];
              terms<T, V, U, CH, Q, P>(qd[k], qy[k], i, q0, m, r, g, b,
                                       a.slope, xh, dz, pos);
#pragma unroll
              for (int p = 0; p < P; ++p) {
                const int c = (i + p) % CH;
                const float x = at(qa[k][(i + p) / V], (i + p) % V);
                acc[0][c] += x;
                acc[1][c] = fmaf(x, xh[p], acc[1][c]);
                acc[2][c] += dz[p];
                acc[3][c] = fmaf(dz[p], xh[p], acc[3][c]);
                acc[4][c] = fmaf(x, dz[p], acc[4][c]);
              }
            }
          }
        }
      }
    }
  }

  // -- the block's sums of each channel, one sum a round: L lanes a
  // channel, over the threads of its slot in thread order ---------------
  {
    const int L = a.lanes, per_slot = a.live / a.K;
    const int ch = tid / L, l = tid - ch * L;
#pragma unroll
    for (int k = 0; k < kSums5; ++k) {
#pragma unroll
      for (int j = 0; j < CH; ++j) ss[j][tid] = acc[k][j];
      __syncthreads();
      float sum = 0.f;
      if (ch < a.C) {
        const int slot = ch / CH, j = ch - slot * CH;
        for (int i = l; i < per_slot; i += L) sum += ss[j][slot + i * a.K];
      }
      for (int off = L >> 1; off; off >>= 1)
        sum += __shfl_down_sync(~0u, sum, off, L);
      if (l == 0 && ch < a.C) {
        if constexpr (kGrid)
          a.part[((size_t)blockIdx.x * kSums5 + k) * a.C + ch] = sum;
        else
          cst[kGrs + k][ch] = sum;
      }
      __syncthreads();
    }
  }
  if constexpr (kGrid) {
    cg::this_grid().sync();
    // a warp a (tenant, sum, channel) column: its S partials in split
    // order
    const int lane = tid & 31, warp = tid >> 5;
    const int cols = kSums5 * a.C;
    for (int p = blockIdx.x * kWarps + warp; p < a.T * cols;
         p += gridDim.x * kWarps) {
      const int tt = p / cols, col = p - tt * cols;
      float sum = 0.f;
      for (int i = lane; i < a.S; i += 32)
        sum += __ldcg(a.part + (size_t)(tt * a.S + i) * cols + col);
#pragma unroll
      for (int off = 16; off; off >>= 1)
        sum += __shfl_down_sync(~0u, sum, off);
      if (lane == 0) a.tot[p] = sum;
    }
    cg::this_grid().sync();
  }

  // -- the coefficients of each channel; the tenant's first block stores
  // g_gamma (rounded once) ---------------------------------------------
  for (int c = tid; c < a.C; c += kThreads) {
    float sm[kSums5];
#pragma unroll
    for (int k = 0; k < kSums5; ++k)
      sm[k] = kGrid ? __ldcg(a.tot + ((size_t)t * kSums5 + k) * a.C + c)
                    : cst[kGrs + k][c];
    const int tc = t * a.C + c;
    const float r = cst[kRstd][c], g = cst[kGamma][c];
    const float gg = maml::scalar(static_cast<const T*>(a.ggamma) + tc);
    const float inv_m = a.inv_m;
    const float m_a = sm[0] * inv_m, m_ax = sm[1] * inv_m;
    const float m_dz = sm[2] * inv_m, m_dzx = sm[3] * inv_m;
    // S_adz - m mean(a) mean(dz) - m mean(a xhat) mean(dz xhat)
    const float cross = sm[4] - (m_a * sm[2] + m_ax * sm[3]);
    const float grs = g * r;
    cst[kGrs][c] = grs;
    cst[kMa][c] = m_a;
    cst[kMax][c] = m_ax;
    cst[kGg][c] = gg;
    cst[kGb][c] = maml::scalar(static_cast<const T*>(a.gbeta) + tc);
    cst[kMdzx][c] = m_dzx;
    cst[kMeanG][c] = -grs * (m_dzx * m_a + m_ax * m_dz) + gg * m_dz;
    cst[kMeanGx][c] = -2.0f * grs * m_ax * m_dzx + gg * m_dzx;
    cst[kLr][c] = r * r * inv_m * g * cross;
    if (s == 0) put(static_cast<T*>(a.g_gamma) + tc, r * cross);
  }
  __syncthreads();
  if (!alive) return;

  // -- apply: the thread's units, last first ----------------------------
  const int mine = end - first - tid;
  if (mine <= 0) return;
  for (int k0 = (mine - 1) / step; k0 >= 0; k0 -= G5) {
    Packet<T, V> qa[G5][U], qd[G5][U], qy[G5][U];
#pragma unroll
    for (int k = 0; k < G5; ++k) {
      const int u = first + tid + (k0 - k) * step;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (k0 - k >= 0) {
          if constexpr (kStage) {
            const int o = ((k0 - k) * U + j) * 3;
            qa[k][j] = sp[o * a.live + tid];
            qd[k][j] = sp[(o + 1) * a.live + tid];
            qy[k][j] = sp[(o + 2) * a.live + tid];
          } else {
            const size_t o = ((size_t)u * U + j) * V;
            load<true>(av + o, qa[k][j]);
            load<true>(da + o, qd[k][j]);
            load<true>(y + o, qy[k][j]);
          }
        } else {
          zero(qa[k][j]);
          zero(qd[k][j]);
          zero(qy[k][j]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < G5; ++k) {
      if (k0 - k >= 0) {
        const int u = first + tid + (k0 - k) * step;
        float o_da[V], o_y[V];  // a load's outputs, stored as it completes
#pragma unroll
        for (int q0 = 0; q0 < CH; q0 += Q) {
          float cf[kCoefs5][Q];
#pragma unroll
          for (int row = 0; row < kCoefs5; ++row)
            lds<Q>(&cst[row][c0 + q0], cf[row]);
#pragma unroll
          for (int i = 0; i < W; i += P) {
            if (i % CH < q0 || i % CH >= q0 + Q) continue;
            float xh[P], dz[P];
            bool pos[P];
            terms<T, V, U, CH, Q, P>(qd[k], qy[k], i, q0, cf[kMean],
                                     cf[kRstd], cf[kGamma], cf[kBeta],
                                     a.slope, xh, dz, pos);
#pragma unroll
            for (int p = 0; p < P; ++p) {
              const int j = (i + p) % CH - q0, v = (i + p) % V;
              const float x = xh[p], d = dz[p];
              const float aa = at(qa[k][(i + p) / V], v);
              const float grs = cf[kGrs][j], m_ax = cf[kMax][j];
              const float gg = cf[kGg][j];
              // g_da: the slope-masked g_dz
              const float gdz =
                  grs * (aa - cf[kMa][j] - x * m_ax) + gg * x + cf[kGb][j];
              o_da[v] = pos[p] ? gdz : gdz * a.slope;
              // g_y: the batch-norm backward of G, plus the rstd term
              const float big_g =
                  -grs * (cf[kMdzx][j] * aa + m_ax * d) + gg * d;
              o_y[v] = cf[kRstd][j] *
                           (big_g - cf[kMeanG][j] - x * cf[kMeanGx][j]) -
                       x * cf[kLr][j];
            }
            if ((i + P) % V == 0) {  // the load's last values
              const size_t o = ((size_t)u * U + i / V) * V;
              maml::store<true>(gda + o, o_da);
              maml::store<true>(gy + o, o_y);
            }
          }
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

// one instantiation of K3's kernel, or of K5's with kK5
template <bool kK5, typename T, int V, int U, int CH, bool kGrid, bool kStage>
const void* instance() {
  if constexpr (kK5)
    return reinterpret_cast<const void*>(
        bn_act_bwd_bwd_kernel<T, V, U, CH, kGrid, kStage>);
  else
    return reinterpret_cast<const void*>(
        bn_act_bwd_kernel<T, V, U, CH, kGrid, kStage>);
}

template <bool kK5, typename T, bool kGrid, bool kStage>
const void* kernel_of(int mode) {
  constexpr int V = sizeof(T) == 4 ? 4 : 8;
  switch (mode) {
    case kLanes:
      return instance<kK5, T, V, 1, V, kGrid, kStage>();
    case kPacked1:
      return instance<kK5, T, V, 1, 1, kGrid, kStage>();
    case kPacked3:
      return instance<kK5, T, V, 3, 3, kGrid, kStage>();
    default:
      return instance<kK5, T, 1, 1, 1, kGrid, false>();
  }
}

template <bool kK5>
const void* kernel_for(int bf16, int mode, int grid_route, int stage) {
  if (stage)
    return bf16 ? kernel_of<kK5, bf16_t, true, true>(mode)
                : kernel_of<kK5, float, true, true>(mode);
  if (bf16)
    return grid_route ? kernel_of<kK5, bf16_t, true, false>(mode)
                      : kernel_of<kK5, bf16_t, false, false>(mode);
  return grid_route ? kernel_of<kK5, float, true, false>(mode)
                    : kernel_of<kK5, float, false, false>(mode);
}

// A launch's layout from the plan, checked against the shape.
struct Layout {
  int mode, K, units, lanes;
};

// Checks a plan (conv_block.bn_act_bwd_plan / bn_act_bwd_bwd_plan) for T
// tenants of E values of C channels, `tensors` of them read by the kernel
// (their pointers `in`, and `out` written, each 16-byte aligned where vec
// asks for vectors): every unit in one block's chunk, no block without
// one, the grid T S, a stage that holds every packet of a thread's units
// on the grid route. Fills the layout; returns the CUDA error, 0 if the
// plan holds.
int check_plan(int T, int C, int E, int bf16, int vec, int live, int chunk,
               int S, long long grid, long long stage, int tensors,
               const void* const* in, const void* const* out, int outs,
               Layout* l) {
  if (T < 1 || C < 1 || C > kMaxC || E < C || E % C)
    return (int)cudaErrorInvalidValue;
  if (vec) {
    if (E % load_width(bf16)) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < tensors; ++i)
      if (!aligned(in[i], 16)) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < outs; ++i)
      if (!aligned(out[i], 16)) return (int)cudaErrorInvalidValue;
  }
  l->mode = mode_of(C, bf16, vec);
  int V, U, CH;
  unit_of(l->mode, bf16, &V, &U, &CH);
  l->K = C / CH;
  l->units = E / (U * V);
  if (E % (U * V) || live != kThreads / l->K * l->K || chunk < 1 ||
      chunk % l->K || S < 1 || (long long)S * chunk < l->units ||
      (long long)(S - 1) * chunk >= l->units || grid != (long long)T * S ||
      grid > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (stage < 0 ||
      (stage && (S < 2 || l->mode == kScalar ||
                 stage < (long long)((chunk + live - 1) / live) * U *
                             tensors * live * (int)sizeof(uint4))))
    return (int)cudaErrorInvalidValue;
  l->lanes = 32;  // the largest power of two <= 32 with C lanes <= 256
  while (l->lanes * C > kThreads) l->lanes >>= 1;
  return 0;
}

// Launches kernel k on the plan's grid: a plain launch (the block route, S
// = 1) or a cooperative one (the grid route) with `stage` bytes of dynamic
// shared memory; the CUDA error, 0 on success.
int launch(const void* k, void* params, int S, long long grid, int stage,
           long long stream) {
  void* args[] = {params};
  const cudaStream_t st = ptr<CUstream_st>(stream);
  if (stage) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, stage);
    if (e != cudaSuccess) return (int)e;
  }
  const cudaError_t err =
      S > 1 ? cudaLaunchCooperativeKernel(k, dim3((unsigned)grid),
                                          dim3(kThreads), args,
                                          (size_t)stage, st)
            : cudaLaunchKernel(k, dim3((unsigned)grid), dim3(kThreads), args,
                               0, st);
  return maml::launch_error(err);
}

}  // namespace

extern "C" {

// The blocks of 256 threads a SM can hold of the grid route's kernel in
// f32 or bf16 and `mode` (conv_block.BN_STATS_MODES): the plan's
// `blocks_per_sm` (the cooperative launch needs every block resident), on
// the current device; K3's, and K5's below.
int bn_act_bwd_blocks_per_sm(int bf16, int mode, int* blocks) {
  if (mode < kScalar || mode > kPacked3) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_for<false>(bf16, mode, 1, 0), kThreads, 0);
}

int bn_act_bwd_bwd_blocks_per_sm(int bf16, int mode, int* blocks) {
  if (mode < kScalar || mode > kPacked3) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_for<true>(bf16, mode, 1, 0), kThreads, 0);
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
  const int chunk = (int)a[17], S = (int)a[18];
  const long long grid = a[19];
  const int stage = (int)a[22];
  const void* in[] = {ptr<const void>(a[0]), ptr<const void>(a[1])};
  void* dy = ptr<void>(a[6]);
  const void* out[] = {dy};
  Layout l;
  const int bad = check_plan(T, C, E, (int)a[14], (int)a[15], (int)a[16],
                             chunk, S, grid, a[22], 2, in, out, 1, &l);
  if (bad) return bad;
  OnDevice on((int)a[20]);
  if (on.err != cudaSuccess) return (int)on.err;
  Args args = {in[0],
               in[1],
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
               l.units,
               chunk,
               S,
               l.K,
               (int)a[16],
               l.lanes,
               slope,
               inv_m};
  return launch(kernel_for<false>((int)a[14], l.mode, S > 1, stage > 0),
                &args, S, grid, stage, a[21]);
}

// K5 pool-free, its arguments packed as K3's, in the order of
// conv_block._launch_act_bwd_bwd:
//   a[0..2]   a, da and y (T tenants of E values, f32 or bf16 by bf16)
//   a[3..8]   the (T, C) mean, rstd, gamma, beta, ggamma and gbeta of y's
//             dtype
//   a[9..11]  the outputs: g_da and g_y (as y), g_gamma (T, C)
//   a[12..13] f32 scratch of the grid route: (T, S, 5, C) partials, (T,
//             5, C) totals
//   a[14..17] T, C, E (a multiple of C), bf16
//   a[18]     vec: the plan's 16-byte loads (a, da, y, g_da and g_y
//             16-byte aligned, E a multiple of a load's values)
//   a[19..22] the plan (conv_block.bn_act_bwd_bwd_plan): live threads a
//             block, chunk, S, grid
//   a[23..24] the device, the stream
//   a[25]     the plan's stage: the dynamic shared memory a block keeps its
//             packets of a, da and y in (the grid route in vectors), or 0
// and the slope (rounded to y's dtype; 1 for batch_norm_bwd_bwd) and 1 /
// m. Refuses as K3.
int bn_act_bwd_bwd(const long long* a, float slope, float inv_m) {
  const int T = (int)a[14], C = (int)a[15], E = (int)a[16];
  const int chunk = (int)a[20], S = (int)a[21];
  const long long grid = a[22];
  const int stage = (int)a[25];
  const void* in[] = {ptr<const void>(a[0]), ptr<const void>(a[1]),
                      ptr<const void>(a[2])};
  const void* out[] = {ptr<const void>(a[9]), ptr<const void>(a[10])};
  Layout l;
  const int bad = check_plan(T, C, E, (int)a[17], (int)a[18], (int)a[19],
                             chunk, S, grid, a[25], 3, in, out, 2, &l);
  if (bad) return bad;
  OnDevice on((int)a[23]);
  if (on.err != cudaSuccess) return (int)on.err;
  Args5 args = {in[0],
                in[1],
                in[2],
                ptr<const void>(a[3]),
                ptr<const void>(a[4]),
                ptr<const void>(a[5]),
                ptr<const void>(a[6]),
                ptr<const void>(a[7]),
                ptr<const void>(a[8]),
                ptr<void>(a[9]),
                ptr<void>(a[10]),
                ptr<void>(a[11]),
                ptr<float>(a[12]),
                ptr<float>(a[13]),
                T,
                C,
                E,
                l.units,
                chunk,
                S,
                l.K,
                (int)a[19],
                l.lanes,
                slope,
                inv_m};
  return launch(kernel_for<true>((int)a[17], l.mode, S > 1, stage > 0),
                &args, S, grid, stage, a[24]);
}

}  // extern "C"
