// K2: batch-norm normalize + affine + leaky-ReLU + 2x2 max pool with its
// window argmax (bn_act_pool_fwd), and its pool-free mode (bn_act_fwd:
// the strided model's `bn_act_fwd`, and at slope 1 the norm-first block's
// standalone `batch_norm_fwd`), each templated on the element type (f32,
// bf16).
//
// Replaces (JAX package) howtotrainyourmamlpytorch_tpu/ops/functional.py:
// the normalize and affine tail of `batch_norm` :429-430 inside
// `conv_bn_act` :249, `leaky_relu` :363 and `max_pool2d` :325 (VALID: an
// odd map's last row and column are dropped; called from models/vgg.py).
// The twins: ops/functional.py::bn_act_pool_fwd, ::bn_act_fwd and
// ::batch_norm_fwd of the port.
//
// Rounding (bn_act_chain.cuh, shared with the pool-free K3 of
// bn_act_bwd.cu, so that its leaky-ReLU masks are K2's decisions). f32:
// xhat = (y - mean) * rstd, z = fma(xhat, gamma, beta) (one FMA, as K3's
// and K5's kernels of bn_act_pool_bwd.cu round it too), then z >= 0 ? z :
// z * slope; spelled with __fsub_rn / __fmul_rn / __fmaf_rn so that no
// contraction moves it. bf16: every op of the JAX package's bf16 chain
// rounded to bf16 (y - mean, * rstd, * gamma, + beta, and z * slope on the
// negative side, the slope its bf16 value), each computed in f32 from bf16
// values, as the twin computes it; the window compares those rounded
// values. Pooled, the first maximum of a window wins a tie (argmax 2 * dh
// + dw).
//
// Bound on an H100: bytes (3.35 TB/s; a few FLOPs an element, no tensor
// cores, no reduction). Pooled, K2 must read y and write the pooled values
// and a 1-byte argmax; pool-free, read y and write the activation; each
// reads four (T, C) tables, which stay in L1 and L2.
//
// * Pooled: a thread owns one pooled pixel x 4 consecutive channels (grid
//   y: the tenant; x: its pooled pixels x ceil(C / 4) channel groups,
//   groups fastest). It loads the window's four taps as vectors (16 bytes
//   in f32, 8 in bf16); the taps (dh, 0) and (dh, 1) of a pixel are
//   adjacent, so a warp's two loads of a row cover contiguous bytes of y.
//   It writes one vector of pooled values and 4 argmax bytes. One channel
//   a thread where C % 4 != 0 or a tensor is unaligned (kVec false).
// * Pool-free: the tensor flat over T * N * H * W * C, 16 bytes a thread
//   (4 elements in f32, 8 in bf16); element e finds its channel as e % C
//   and its tenant as e / (N * H * W * C), so C = 3 and C = 1 (the images
//   of the norm-first and strided norm-first models) load and store at
//   full vector width. The (T, C) tables are read as vectors where C % 4
//   == 0 and they are aligned, else an element at a time from L1 (a
//   block's copy in shared memory, staged behind a barrier, measured
//   slower at C = 3 on an H100). A scalar path takes the last partial
//   vector, and y or out when unaligned (one element a thread).
// * y is read once: evict-first loads. The outputs are stored cached: the
//   next stage's conv (K1) reads them.
// * No atomics, no reduction: a second launch gives the first launch's
//   bits.
//
// The plan (kernels/conv_block.py::bn_fwd_plan) gives the grid, the
// threads a block and the channels or elements a thread; each entry point
// checks it against the shape and refuses a plan or a vector mode that
// does not hold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn_act_chain.cuh"

namespace {

using maml::rbf;
using maml::rbf2;

constexpr int kThreads = 256;  // a block
constexpr int kMaxC = 64;      // the channels the kernels take

struct FwdArgs {
  const void* y;
  const void* mean;
  const void* rstd;
  const void* gamma;
  const void* beta;
  void* out;
  uint8_t* arg;      // pooled: the window argmax
  int N, H, W, C;
  int G;             // pooled: channel groups a pooled pixel
  int Ho, Wo;
  int pooled;        // pooled pixels a tenant, N * Ho * Wo
  int tenant;        // elements of y a tenant, N * H * W * C
  long long total;   // elements of y, T * tenant
  float slope;
};

template <typename T>
constexpr bool kBf16 = sizeof(T) == 2;

__device__ __forceinline__ unsigned short bf_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void unpack2(unsigned w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  return (unsigned)bf_bits(lo) | ((unsigned)bf_bits(hi) << 16);
}

// One element as f32; kStream: y, read once (evict-first).
template <typename T, bool kStream>
__device__ __forceinline__ float ld1(const T* p) {
  if constexpr (kBf16<T>) {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    return __uint_as_float((unsigned)(kStream ? __ldcs(q) : __ldg(q)) << 16);
  } else {
    const float* q = reinterpret_cast<const float*>(p);
    return kStream ? __ldcs(q) : __ldg(q);
  }
}

// kN consecutive elements as f32: 4 f32 (16 bytes), 4 bf16 (8 bytes) or 8
// bf16 (16 bytes), one load.
template <typename T, int kN, bool kStream>
__device__ __forceinline__ void ldv(const T* p, float (&v)[kN]) {
  if constexpr (!kBf16<T>) {
    static_assert(kN == 4, "f32 vectors are 4 elements");
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 u = kStream ? __ldcs(q) : __ldg(q);
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else if constexpr (kN == 4) {
    const uint2* q = reinterpret_cast<const uint2*>(p);
    const uint2 u = kStream ? __ldcs(q) : __ldg(q);
    unpack2(u.x, v[0], v[1]);
    unpack2(u.y, v[2], v[3]);
  } else {
    static_assert(kN == 8, "bf16 vectors are 4 or 8 elements");
    const uint4* q = reinterpret_cast<const uint4*>(p);
    const uint4 u = kStream ? __ldcs(q) : __ldg(q);
    unpack2(u.x, v[0], v[1]);
    unpack2(u.y, v[2], v[3]);
    unpack2(u.z, v[4], v[5]);
    unpack2(u.w, v[6], v[7]);
  }
}

template <typename T>
__device__ __forceinline__ void st1(T* p, float v) {
  if constexpr (kBf16<T>)
    *reinterpret_cast<unsigned short*>(p) = bf_bits(v);
  else
    *reinterpret_cast<float*>(p) = v;
}

template <typename T, int kN>
__device__ __forceinline__ void stv(T* p, const float (&v)[kN]) {
  if constexpr (!kBf16<T>) {
    static_assert(kN == 4, "f32 vectors are 4 elements");
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kN == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  } else {
    static_assert(kN == 8, "bf16 vectors are 4 or 8 elements");
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                   pack2(v[6], v[7]));
  }
}

// The activation of kN elements in place: normalize, affine, leaky-ReLU,
// rounded as the header says; in bf16 two elements share each conversion
// (the conversions, not the bytes, bound a bf16 chain of five).
template <typename T, int kN>
__device__ __forceinline__ void bn_act(float (&v)[kN], const float (&m)[kN],
                                       const float (&r)[kN],
                                       const float (&g)[kN],
                                       const float (&b)[kN], float slope) {
  if constexpr (!kBf16<T>) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float z = maml::bn_z(maml::bn_xhat(v[j], m[j], r[j]), g[j], b[j]);
      v[j] = z >= 0.f ? z : __fmul_rn(z, slope);
    }
  } else if constexpr (kN == 1) {
    const float z = maml::bn_z_bf16(v[0], m[0], r[0], g[0], b[0]);
    v[0] = z >= 0.f ? z : rbf(__fmul_rn(z, slope));
  } else {
    static_assert(kN % 2 == 0, "bf16 elements go in pairs");
#pragma unroll
    for (int j = 0; j < kN; j += 2) {
      float z0 = v[j], z1 = v[j + 1];
      maml::bn_z_bf16_2(z0, z1, m[j], m[j + 1], r[j], r[j + 1], g[j],
                        g[j + 1], b[j], b[j + 1]);
      float n0 = __fmul_rn(z0, slope), n1 = __fmul_rn(z1, slope);
      rbf2(n0, n1);
      v[j] = z0 >= 0.f ? z0 : n0;
      v[j + 1] = z1 >= 0.f ? z1 : n1;
    }
  }
}

// The four (T, C) tables at entry tc: kN channels (a vector each) or one.
template <typename T, int kN, bool kVec>
__device__ __forceinline__ void ld_params(const FwdArgs& p, int tc,
                                          float (&m)[kN], float (&r)[kN],
                                          float (&g)[kN], float (&b)[kN]) {
  const T* mean = static_cast<const T*>(p.mean) + tc;
  const T* rstd = static_cast<const T*>(p.rstd) + tc;
  const T* gamma = static_cast<const T*>(p.gamma) + tc;
  const T* beta = static_cast<const T*>(p.beta) + tc;
  if constexpr (kVec) {
    ldv<T, kN, false>(mean, m);
    ldv<T, kN, false>(rstd, r);
    ldv<T, kN, false>(gamma, g);
    ldv<T, kN, false>(beta, b);
  } else {
    static_assert(kN == 1, "scalar loads take one channel");
    m[0] = ld1<T, false>(mean);
    r[0] = ld1<T, false>(rstd);
    g[0] = ld1<T, false>(gamma);
    b[0] = ld1<T, false>(beta);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    bn_act_pool_fwd_kernel(const FwdArgs p) {
  constexpr int kI = kVec ? 4 : 1;  // channels a thread
  const int l = blockIdx.x * kThreads + threadIdx.x;
  const int pix = l / p.G;
  if (pix >= p.pooled) return;
  const int t = blockIdx.y;
  const int c0 = (l - pix * p.G) * kI;
  const int per_image = p.Ho * p.Wo;
  const int n = pix / per_image, hw = pix - n * per_image;
  const int ho = hw / p.Wo, wo = hw - ho * p.Wo;
  const T* y = static_cast<const T*>(p.y) + (size_t)t * p.tenant +
               (size_t)((n * p.H + 2 * ho) * p.W + 2 * wo) * p.C + c0;
  float v[4][kI];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const T* tap = y + ((k >> 1) * p.W + (k & 1)) * p.C;
    if constexpr (kVec)
      ldv<T, kI, true>(tap, v[k]);
    else
      v[k][0] = ld1<T, true>(tap);
  }
  float m[kI], r[kI], g[kI], b[kI];
  ld_params<T, kI, kVec>(p, t * p.C + c0, m, r, g, b);
#pragma unroll
  for (int k = 0; k < 4; ++k) bn_act<T, kI>(v[k], m, r, g, b, p.slope);
  float best[kI];
  unsigned win[kI];
#pragma unroll
  for (int j = 0; j < kI; ++j) {
    best[j] = v[0][j];
    win[j] = 0;
#pragma unroll
    for (int k = 1; k < 4; ++k)  // the first maximum wins
      if (v[k][j] > best[j]) best[j] = v[k][j], win[j] = k;
  }
  const size_t o = ((size_t)t * p.pooled + pix) * p.C + c0;
  T* out = static_cast<T*>(p.out) + o;
  if constexpr (kVec) {
    stv<T, kI>(out, best);
    *reinterpret_cast<unsigned*>(p.arg + o) =
        win[0] | (win[1] << 8) | (win[2] << 16) | (win[3] << 24);
  } else {
    st1<T>(out, best[0]);
    p.arg[o] = (uint8_t)win[0];
  }
}

// Element e's tenant t and channel c, and its offset r within the tenant;
// 32-bit division where the tensor allows.
__device__ __forceinline__ void locate(const FwdArgs& p, long long e, int& t,
                                       int& r, int& c) {
  if (p.total < (1LL << 31)) {
    const unsigned u = (unsigned)e, n = (unsigned)p.tenant;
    t = (int)(u / n);
    r = (int)(u - (unsigned)t * n);
  } else {
    t = (int)(e / p.tenant);
    r = (int)(e - (long long)t * p.tenant);
  }
  c = r % p.C;
}

// The next element's tenant, offset and channel (kStep 1), or the next 4
// elements' (kStep 4: C % 4 == 0, so a group of 4 never spans two
// tenants).
template <int kStep>
__device__ __forceinline__ void advance(const FwdArgs& p, int& t, int& r,
                                        int& c) {
  c += kStep;
  if (c == p.C) c = 0;
  r += kStep;
  if (r == p.tenant) r = 0, ++t;
}

template <typename T, bool kVec, bool kVecP>
__global__ void __launch_bounds__(kThreads) bn_act_fwd_kernel(const FwdArgs p) {
  constexpr int kI = kVec ? 16 / (int)sizeof(T) : 1;  // elements a thread
  const long long e0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kI;
  if (e0 >= p.total) return;
  const T* y = static_cast<const T*>(p.y) + e0;
  T* out = static_cast<T*>(p.out) + e0;
  int t, r, c;
  locate(p, e0, t, r, c);
  if constexpr (kVec) {
    if (e0 + kI <= p.total) {
      float v[kI];
      ldv<T, kI, true>(y, v);
#pragma unroll
      for (int q = 0; q < kI; q += 4) {
        float w[4], m[4], rs[4], g[4], b[4];
        if constexpr (kVecP) {
          ld_params<T, 4, true>(p, t * p.C + c, m, rs, g, b);
          advance<4>(p, t, r, c);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float mj[1], rj[1], gj[1], bj[1];
            ld_params<T, 1, false>(p, t * p.C + c, mj, rj, gj, bj);
            m[j] = mj[0], rs[j] = rj[0], g[j] = gj[0], b[j] = bj[0];
            advance<1>(p, t, r, c);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = v[q + j];
        bn_act<T, 4>(w, m, rs, g, b, p.slope);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[q + j] = w[j];
      }
      stv<T, kI>(out, v);
      return;
    }
  }
  // the last partial vector, or one element a thread
  for (int j = 0; j < kI && e0 + j < p.total; ++j) {
    float v[1] = {ld1<T, true>(y + j)}, m[1], rs[1], g[1], b[1];
    ld_params<T, 1, false>(p, t * p.C + c, m, rs, g, b);
    bn_act<T, 1>(v, m, rs, g, b, p.slope);
    st1<T>(out + j, v[0]);
    advance<1>(p, t, r, c);
  }
}

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

inline bool aligned(const void* p, unsigned long long bytes) {
  return (reinterpret_cast<unsigned long long>(p) & (bytes - 1)) == 0;
}

// The shape's geometry; false where the kernels do not take it.
bool geom(FwdArgs& p, int T, int N, int H, int W, int C, float slope) {
  if (T < 1 || N < 1 || H < 1 || W < 1 || C < 1 || C > kMaxC) return false;
  const long long tenant = (long long)N * H * W * C;
  if (tenant >= (1LL << 31)) return false;
  p.N = N, p.H = H, p.W = W, p.C = C;
  p.Ho = H / 2, p.Wo = W / 2;
  p.pooled = N * p.Ho * p.Wo;
  p.tenant = (int)tenant;
  p.total = tenant * T;
  p.slope = slope;
  return true;
}

// The four tables as vectors of 4 elements: 16 bytes (f32) or 8 (bf16).
bool params_vec_ok(const FwdArgs& p, int esize) {
  const unsigned long long v = 4ull * esize;
  return p.C % 4 == 0 && aligned(p.mean, v) && aligned(p.rstd, v) &&
         aligned(p.gamma, v) && aligned(p.beta, v);
}

template <typename T>
cudaError_t launch_pool(FwdArgs p, int T_, int vec, int blocks,
                        cudaStream_t st) {
  const dim3 grid(blocks, T_), block(kThreads);
  if (vec)
    bn_act_pool_fwd_kernel<T, true><<<grid, block, 0, st>>>(p);
  else
    bn_act_pool_fwd_kernel<T, false><<<grid, block, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_free(FwdArgs p, int vec, int blocks, cudaStream_t st) {
  const dim3 grid(blocks), block(kThreads);
  if (!vec)
    bn_act_fwd_kernel<T, false, false><<<grid, block, 0, st>>>(p);
  else if (params_vec_ok(p, sizeof(T)))
    bn_act_fwd_kernel<T, true, true><<<grid, block, 0, st>>>(p);
  else
    bn_act_fwd_kernel<T, true, false><<<grid, block, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K2 pooled: from y (T, N, H, W, C) and the (T, C) mean, rstd, gamma,
// beta, all f32 (bf16 0) or all bf16 (bf16 1): the pooled activation out
// (T, N, H/2, W/2, C) in y's dtype and its uint8 window argmax arg. The
// plan: `blocks` x T blocks of `threads`; `vec` 4 channels a thread (C %
// 4 == 0; y, out and the tables aligned to a vector, arg to 4 bytes), else
// one. Returns the CUDA error, 0 on success.
int bn_act_pool_fwd(const void* y, const void* mean, const void* rstd,
                    const void* gamma, const void* beta, void* out,
                    void* arg, int T, int N, int H, int W, int C, int bf16,
                    int vec, int blocks, int threads, float slope,
                    void* stream) {
  FwdArgs p = {};
  if (!geom(p, T, N, H, W, C, slope) || T > 65535 || H < 2 || W < 2 ||
      threads != kThreads)
    return (int)cudaErrorInvalidValue;
  const int esize = bf16 ? 2 : 4;
  p.y = y, p.mean = mean, p.rstd = rstd, p.gamma = gamma, p.beta = beta;
  p.out = out, p.arg = static_cast<uint8_t*>(arg);
  p.G = vec ? (C + 3) / 4 : C;
  if (blocks != cdiv((long long)p.pooled * p.G, kThreads))
    return (int)cudaErrorInvalidValue;
  if (vec && !(params_vec_ok(p, esize) && aligned(y, 4 * esize) &&
               aligned(out, 4 * esize) && aligned(arg, 4)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_pool<__nv_bfloat16>(p, T, vec, blocks, st)
                    : launch_pool<float>(p, T, vec, blocks, st));
}

// K2 pool-free: from y (T, N, H, W, C) and the (T, C) tables, all f32 or
// all bf16: the activation out (T, N, H, W, C). The plan: `blocks` blocks
// of `threads`; `vec` 16 bytes a thread (y and out aligned to 16 bytes),
// else one element. Returns the CUDA error, 0 on success.
int bn_act_fwd(const void* y, const void* mean, const void* rstd,
               const void* gamma, const void* beta, void* out, int T, int N,
               int H, int W, int C, int bf16, int vec, int blocks,
               int threads, float slope, void* stream) {
  FwdArgs p = {};
  if (!geom(p, T, N, H, W, C, slope) || threads != kThreads)
    return (int)cudaErrorInvalidValue;
  const int items = vec ? (bf16 ? 8 : 4) : 1;
  if (blocks != cdiv(cdiv(p.total, items), kThreads))
    return (int)cudaErrorInvalidValue;
  if (vec && !(aligned(y, 16) && aligned(out, 16)))
    return (int)cudaErrorInvalidValue;
  p.y = y, p.mean = mean, p.rstd = rstd, p.gamma = gamma, p.beta = beta;
  p.out = out;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_free<__nv_bfloat16>(p, vec, blocks, st)
                    : launch_free<float>(p, vec, blocks, st));
}

}  // extern "C"
