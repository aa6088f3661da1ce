// The leaky-ReLU with or without the 2x2 max pool, in f32 and bf16, one
// launch a call each way:
//   act_fwd:      z = y >= 0 ? y : y * slope, flat over the tensor (the
//                 strided norm-first and layer-norm models' activation
//                 after the conv);
//   act_bwd:      dy = y >= 0 ? da : da * slope (linear in da, and its own
//                 adjoint: the gradient of the gradient too);
//   act_pool_fwd: the leaky-ReLU, then the 2x2/2 max pool (VALID: an odd
//                 map's last row and column are dropped) and each pooled
//                 element's window argmax, uint8 2 * dh + dw, the first
//                 maximum of the activated values on ties (the pooled
//                 models' norm-first and layer-norm blocks);
//   act_pool_bwd: each pooled gradient d at its window's argmax times the
//                 leaky-ReLU's derivative at y there, d * 0 at the window's
//                 other taps, +0 on the dropped row and column;
//   act_pool_gather: the adjoint of act_pool_bwd in its gradient (the
//                 derivative second-order MAML takes through it): g_dy
//                 times the leaky-ReLU's derivative at y, at each window's
//                 argmax, into the pooled shape.
//
// Replaces (JAX package) howtotrainyourmamlpytorch_tpu/ops/functional.py:
// `leaky_relu` :363 and `max_pool2d` :325 (impl='reduce_window': the whole
// gradient to the first maximum) after the conv of the norm-first block
// (models/vgg.py:300-302), the gradients XLA derives for them, and the
// gradient of that gradient (act_pool_gather). The twins are
// ops/functional.py::act_fwd, ::act_bwd, ::act_pool_fwd, ::act_pool_bwd
// and ::act_pool_gather of the port.
//
// Rounding: in f32 one multiply; in bf16 the product of two bf16 values
// (y or da, and the slope's bf16 value) is exact in f32, so one rounding
// at the store gives the twin's bits (the JAX package's `select(y >= 0, y,
// bf16(slope * y))` and `select(y >= 0, g, bf16(slope * g))`). The pooled
// forward in bf16 rounds the negative side before the window compare (a
// pair a conversion), so that exact bf16 ties, common at full width, fall
// to the first maximum as the twin's do. The backward's zeros are the
// twin's: its unpool multiplies a one-hot by d (d * 0: the sign of d),
// its pad writes +0 on the dropped row and column. The gather's mask comes
// from y, as the twin's `select(y >= 0, g, bf16(slope * g))`. Bit for bit
// the twins in both dtypes.
//
// Bound on an H100: bytes (3.35 TB/s; a select, a multiply and a compare
// an element). act_fwd reads y and writes z; act_bwd reads da and y and
// writes dy; act_pool_fwd reads y and writes the pooled quarter and a
// byte of argmax an element of it; act_pool_bwd reads the pooled gradient
// and the argmax, y where a window routes its gradient, and writes dy;
// act_pool_gather reads the argmax, g_dy and y at it, and writes the
// pooled quarter.
// * act_fwd / act_bwd: 16 bytes of the flat tensor a thread (4 f32 or 8
//   bf16).
// * act_pool_fwd / act_pool_bwd: a thread owns one 2x2 window x 16 bytes
//   of channels (4 f32 or 8 bf16; consecutive threads the window's
//   consecutive channel groups, as K2's pooled kernel). The forward loads
//   the window's four taps as vectors before it compares, stores one
//   vector of pooled values and the argmax bytes as one 32-bit (f32) or
//   64-bit (bf16) store. The backward loads the pooled gradient and the
//   argmax bytes once and writes the four taps of dy as vectors; it reads
//   y at a tap only where some lane of its vector selects that tap. Its
//   grid covers ceil(H / 2) x ceil(W / 2) windows: those past the pooled
//   map (an odd map's dropped row and column) write their taps' zeros, in
//   the same launch.
// * act_pool_gather: the forward's mapping. A thread loads its argmax
//   bytes once, then g_dy and y as vectors only at the taps some lane of
//   its vector selects, every load before its one store. DRAM moves whole
//   32-byte sectors, so a tap's sector is read if any of its channels
//   selects the tap: with independent argmaxes about 3.6 of 4 taps in f32
//   (3.96 in bf16), which caps the gather near 38% of the bound that
//   counts g_dy and y at the argmax alone.
// * act_fwd / act_bwd load evict-first (read once); the act-pool kernels
//   load plain (an evict-first hint measured 5-10% slower at their
//   stage-0 maps), every load a thread makes before its first store.
//   Stores are cached (the next kernel reads them). The last partial
//   vector, and tensors off 16-byte alignment or channel counts off the
//   vector, one element a thread.
// * Index arithmetic is 32-bit where the tensor holds fewer than 2**31
//   elements, else 64-bit (the large-batch geometry's stage 0).
// * No atomics, no sums: a second launch gives the first launch's bits.
//
// The plans (kernels/conv_block.py::act_blocks, ::act_pool_plan) give the
// grids; each entry checks its plan against the shape and refuses one that
// does not hold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bn_act_chain.cuh"
#include "vec_io.cuh"

namespace {

using maml::at;
using maml::bf16_t;
using maml::load;
using maml::Packet;

constexpr int kThreads = 256;  // a block

struct Args {
  const void* da;  // the backward's gradient; unused by the forward
  const void* y;
  void* out;
  long long n;  // elements
  float slope;
};

// the leaky-ReLU of y (kFwd), or da times its derivative at y
template <bool kFwd>
__device__ __forceinline__ float leaky(float d, float y, float slope) {
  const float v = kFwd ? y : d;
  return y >= 0.f ? v : __fmul_rn(v, slope);
}

template <typename T, int V, bool kFwd>
__device__ __forceinline__ void act_body(const Args& a) {
  const long long e0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (e0 >= a.n) return;
  const T* da = static_cast<const T*>(a.da) + e0;
  const T* y = static_cast<const T*>(a.y) + e0;
  T* out = static_cast<T*>(a.out) + e0;
  if constexpr (V > 1) {
    if (e0 + V <= a.n) {
      Packet<T, V> qd, qy;
      if constexpr (!kFwd) load<true>(da, qd);
      load<true>(y, qy);
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if constexpr (kFwd)
          o[i] = leaky<true>(0.f, at(qy, i), a.slope);
        else
          o[i] = leaky<false>(at(qd, i), at(qy, i), a.slope);
      }
      maml::store<false>(out, o);
      return;
    }
  }
  // the last partial vector, or one element a thread
  for (int i = 0; i < V && e0 + i < a.n; ++i) {
    Packet<T, 1> qd, qy;
    float d = 0.f;
    if constexpr (!kFwd) {
      load<true>(da + i, qd);
      d = at(qd, 0);
    }
    load<true>(y + i, qy);
    const float o[1] = {leaky<kFwd>(d, at(qy, 0), a.slope)};
    maml::store<false>(out + i, o);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) act_fwd_kernel(const Args a) {
  act_body<T, V, true>(a);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) act_bwd_kernel(const Args a) {
  act_body<T, V, false>(a);
}

template <typename T, int V, bool kFwd>
const void* kernel_of() {
  return kFwd ? reinterpret_cast<const void*>(act_fwd_kernel<T, V>)
              : reinterpret_cast<const void*>(act_bwd_kernel<T, V>);
}

template <typename T, bool kFwd>
const void* kernel_for(int vec) {
  constexpr int V = sizeof(T) == 4 ? 4 : 8;
  return vec ? kernel_of<T, V, kFwd>() : kernel_of<T, 1, kFwd>();
}

// Checks a launch of n elements on `blocks` blocks with or without
// vectors, and launches it; the CUDA error, 0 on success.
template <bool kFwd>
int launch(const Args& args, int bf16, int vec, long long blocks,
           int device, long long stream) {
  const long long per = vec ? (bf16 ? 8 : 4) : 1;
  const long long threads = (args.n + per - 1) / per;
  if (args.n < 1 || blocks != (threads + kThreads - 1) / kThreads ||
      blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (vec && !((kFwd || maml::aligned(args.da, 16)) &&
               maml::aligned(args.y, 16) && maml::aligned(args.out, 16)))
    return (int)cudaErrorInvalidValue;
  maml::OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  Args a = args;
  void* params[] = {&a};
  const void* k = bf16 ? kernel_for<bf16_t, kFwd>(vec)
                       : kernel_for<float, kFwd>(vec);
  return maml::launch_error(cudaLaunchKernel(
      k, dim3((unsigned)blocks), dim3(kThreads), params, 0,
      maml::ptr<CUstream_st>(stream)));
}

// -- the leaky-ReLU with the 2x2 max pool ------------------------------------

struct PoolArgs {
  const void* dp;   // the backward's pooled gradient, the gather's g_dy;
                    // unused by the forward
  void* arg;        // the uint8 window argmax (T, N, Ho, Wo, C)
  const void* y;    // (T, N, H, W, C)
  void* out;        // the forward's pooled values, the backward's dy, the
                    // gather's pooled values
  long long work;   // threads with a window: T * N * Hw * Ww * G
  int H, W, C;
  int G;            // threads a window: C / V
  int Hw, Ww;       // the windows of a map: the forward's (Ho, Wo), the
                    // backward's (ceil(H / 2), ceil(W / 2))
  int Ho, Wo;       // the pooled map
  float slope;
};

// A thread's window (row h, column w of an image's windows) and the
// offsets of its first tap in y and of its pooled element, at its first
// channel; index type I: 32-bit (unsigned) or 64-bit.
template <typename I>
struct Window {
  I y, pooled;
  int h, w;
};

template <typename I, int V>
__device__ __forceinline__ Window<I> locate(const PoolArgs& a, I l) {
  const I q = l / (I)a.G;  // the window, over (image, h, w)
  const I c0 = (l - q * (I)a.G) * V;
  const I r = q / (I)a.Ww;  // image * Hw + h
  const I img = r / (I)a.Hw;
  Window<I> o;
  o.w = (int)(q - r * (I)a.Ww);
  o.h = (int)(r - img * (I)a.Hw);
  o.y = ((img * a.H + 2 * o.h) * a.W + 2 * o.w) * (I)a.C + c0;
  o.pooled = ((img * a.Ho + o.h) * a.Wo + o.w) * (I)a.C + c0;
  return o;
}

// tap k's offset from its window's first (k = 2 * dh + dw)
template <typename I>
__device__ __forceinline__ I tap(const PoolArgs& a, int k) {
  return ((I)(k >> 1) * a.W + (k & 1)) * a.C;
}

// the leaky-ReLU of V values of T as the window compares them: in bf16
// the negative side rounded to bf16, a pair a conversion
template <typename T, int V>
__device__ __forceinline__ void pooled_leaky(float (&v)[V], float slope) {
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = leaky<true>(0.f, v[i], slope);
  if constexpr (sizeof(T) == 2) {
    if constexpr (V == 1) {
      v[0] = maml::rbf(v[0]);
    } else {
#pragma unroll
      for (int i = 0; i < V; i += 2) maml::rbf2(v[i], v[i + 1]);
    }
  }
}

// V values of T by a plain load (a 16-byte vector, or one value)
template <typename T, int V>
__device__ __forceinline__ void load_plain(const T* p, Packet<T, V>& q) {
  q = *reinterpret_cast<const Packet<T, V>*>(p);
}

// V argmax bytes: one 32-bit (V = 4) or 64-bit (V = 8) access, or one byte
template <int V>
__device__ __forceinline__ void store_arg(uint8_t* p, const unsigned (&k)[V]) {
  if constexpr (V == 1) {
    *p = (uint8_t)k[0];
  } else if constexpr (V == 4) {
    *reinterpret_cast<unsigned*>(p) =
        k[0] | (k[1] << 8) | (k[2] << 16) | (k[3] << 24);
  } else {
    uint2 u;
    u.x = k[0] | (k[1] << 8) | (k[2] << 16) | (k[3] << 24);
    u.y = k[4] | (k[5] << 8) | (k[6] << 16) | (k[7] << 24);
    *reinterpret_cast<uint2*>(p) = u;
  }
}

template <int V>
__device__ __forceinline__ void load_arg(const uint8_t* p, unsigned (&k)[V]) {
  if constexpr (V == 1) {
    k[0] = *p;
  } else {
    unsigned w[V / 4];
    if constexpr (V == 4) {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x, w[1] = u.y;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) k[i] = (w[i >> 2] >> (8 * (i & 3))) & 0xffu;
  }
}

template <typename T, int V, typename I>
__global__ void __launch_bounds__(kThreads)
    act_pool_fwd_kernel(const PoolArgs a) {
  const I l = (I)blockIdx.x * kThreads + threadIdx.x;
  if (l >= (I)a.work) return;
  const Window<I> win = locate<I, V>(a, l);
  const T* y = static_cast<const T*>(a.y) + win.y;
  Packet<T, V> q[4];  // the four taps in flight before the compare
#pragma unroll
  for (int k = 0; k < 4; ++k) load_plain(y + tap<I>(a, k), q[k]);
  float best[V];
  unsigned arg[V];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = at(q[k], i);
    pooled_leaky<T, V>(v, a.slope);
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (k == 0 || v[i] > best[i]) best[i] = v[i], arg[i] = k;  // first wins
  }
  maml::store<false>(static_cast<T*>(a.out) + win.pooled, best);
  store_arg<V>(static_cast<uint8_t*>(a.arg) + win.pooled, arg);
}

template <typename T, int V, typename I>
__global__ void __launch_bounds__(kThreads)
    act_pool_bwd_kernel(const PoolArgs a) {
  const I l = (I)blockIdx.x * kThreads + threadIdx.x;
  if (l >= (I)a.work) return;
  const Window<I> win = locate<I, V>(a, l);
  T* dy = static_cast<T*>(a.out) + win.y;
  if (win.h >= a.Ho || win.w >= a.Wo) {
    // a window of the dropped row or column: its taps inside the map +0
    const float zero[V] = {};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (2 * win.h + (k >> 1) < a.H && 2 * win.w + (k & 1) < a.W)
        maml::store<false>(dy + tap<I>(a, k), zero);
    return;
  }
  Packet<T, V> qd;
  load_plain(static_cast<const T*>(a.dp) + win.pooled, qd);
  unsigned arg[V];
  load_arg<V>(static_cast<const uint8_t*>(a.arg) + win.pooled, arg);
  // y at a tap only where some lane takes it (or where a negative slope
  // would turn an off-argmax zero's sign); else +0, which keeps d * 0.
  // Every tap's load before the first store: dy may alias y as far as the
  // compiler knows, so a load after a store would wait for it.
  const T* y = static_cast<const T*>(a.y) + win.y;
  Packet<T, V> qy[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bool hit = false;
#pragma unroll
    for (int i = 0; i < V; ++i) hit |= arg[i] == (unsigned)k;
    if (hit || a.slope < 0.f)
      load_plain(y + tap<I>(a, k), qy[k]);
    else
      maml::zero(qy[k]);
  }
  float d[V], off[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    d[i] = at(qd, i);
    off[i] = __fmul_rn(d[i], 0.f);  // the twin's one-hot product
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float o[V];
#pragma unroll
    for (int i = 0; i < V; ++i)
      o[i] = leaky<false>(arg[i] == (unsigned)k ? d[i] : off[i],
                          at(qy[k], i), a.slope);
    maml::store<false>(dy + tap<I>(a, k), o);
  }
}

// value i of the packet of tap k (0-3) of four
template <typename T, int V>
__device__ __forceinline__ float pick(const Packet<T, V> (&q)[4], unsigned k,
                                      int i) {
  const float v0 = at(q[0], i), v1 = at(q[1], i), v2 = at(q[2], i),
              v3 = at(q[3], i);
  return k == 0 ? v0 : k == 1 ? v1 : k == 2 ? v2 : v3;
}

template <typename T, int V, typename I>
__global__ void __launch_bounds__(kThreads)
    act_pool_gather_kernel(const PoolArgs a) {
  const I l = (I)blockIdx.x * kThreads + threadIdx.x;
  if (l >= (I)a.work) return;
  const Window<I> win = locate<I, V>(a, l);
  unsigned arg[V];
  load_arg<V>(static_cast<const uint8_t*>(a.arg) + win.pooled, arg);
  // g_dy and y at a tap only where some lane takes it
  const T* g = static_cast<const T*>(a.dp) + win.y;
  const T* y = static_cast<const T*>(a.y) + win.y;
  Packet<T, V> qg[4], qy[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bool hit = false;
#pragma unroll
    for (int i = 0; i < V; ++i) hit |= arg[i] == (unsigned)k;
    if (hit) {
      load_plain(g + tap<I>(a, k), qg[k]);
      load_plain(y + tap<I>(a, k), qy[k]);
    } else {
      maml::zero(qg[k]);
      maml::zero(qy[k]);
    }
  }
  float o[V];
#pragma unroll
  for (int i = 0; i < V; ++i)
    o[i] = leaky<false>(pick(qg, arg[i], i), pick(qy, arg[i], i), a.slope);
  maml::store<false>(static_cast<T*>(a.out) + win.pooled, o);
}

// the pooled kernels: the forward, the backward, the gather
enum PoolKind { kPoolFwd = 0, kPoolBwd = 1, kPoolGather = 2 };

template <typename T, int V, typename I, int kKind>
const void* pool_kernel_of() {
  if constexpr (kKind == kPoolFwd)
    return reinterpret_cast<const void*>(act_pool_fwd_kernel<T, V, I>);
  else if constexpr (kKind == kPoolBwd)
    return reinterpret_cast<const void*>(act_pool_bwd_kernel<T, V, I>);
  else
    return reinterpret_cast<const void*>(act_pool_gather_kernel<T, V, I>);
}

template <typename T, int V, int kKind>
const void* pool_kernel_at(int wide) {
  return wide ? pool_kernel_of<T, V, unsigned long long, kKind>()
              : pool_kernel_of<T, V, unsigned, kKind>();
}

template <typename T, int kKind>
const void* pool_kernel_for(int vec, int wide) {
  constexpr int V = sizeof(T) == 4 ? 4 : 8;
  return vec ? pool_kernel_at<T, V, kKind>(wide)
             : pool_kernel_at<T, 1, kKind>(wide);
}

// Checks a pooled launch against the shape (T, N, H, W, C), the dtype, the
// vectors, the index width and the blocks, and launches it; the CUDA
// error, 0 on success. The forward and the gather run over the pooled
// windows, the backward over ceil(H / 2) x ceil(W / 2).
template <int kKind>
int launch_pool(PoolArgs p, long long T, long long N, int bf16, int vec,
                int wide, long long blocks, int device, long long stream) {
  const int V = vec ? (bf16 ? 8 : 4) : 1;
  if (T < 1 || N < 1 || p.H < 2 || p.W < 2 || p.C < 1 || p.C % V)
    return (int)cudaErrorInvalidValue;
  p.G = p.C / V;
  p.Ho = p.H / 2, p.Wo = p.W / 2;
  p.Hw = kKind == kPoolBwd ? (p.H + 1) / 2 : p.Ho;
  p.Ww = kKind == kPoolBwd ? (p.W + 1) / 2 : p.Wo;
  p.work = T * N * p.Hw * p.Ww * p.G;
  const long long total = T * N * p.H * p.W * (long long)p.C;
  if (blocks != (p.work + kThreads - 1) / kThreads ||
      blocks > 0x7fffffffLL || wide != (total >= (1LL << 31)))
    return (int)cudaErrorInvalidValue;
  // vectors: y, the pooled values (or dy and the pooled gradient; or the
  // gathered values and g_dy) on 16 bytes, the argmax on V bytes
  const unsigned long long bytes = 16;
  if (vec && !(maml::aligned(p.y, bytes) && maml::aligned(p.out, bytes) &&
               maml::aligned(p.arg, V) &&
               (kKind == kPoolFwd || maml::aligned(p.dp, bytes))))
    return (int)cudaErrorInvalidValue;
  maml::OnDevice on(device);
  if (on.err != cudaSuccess) return (int)on.err;
  void* params[] = {&p};
  const void* k = bf16 ? pool_kernel_for<bf16_t, kKind>(vec, wide)
                       : pool_kernel_for<float, kKind>(vec, wide);
  return maml::launch_error(cudaLaunchKernel(
      k, dim3((unsigned)blocks), dim3(kThreads), params, 0,
      maml::ptr<CUstream_st>(stream)));
}

}  // namespace

extern "C" {

// act_fwd. The arguments come packed as 64-bit integers (one ctypes
// argument), in the order of conv_block.act_fwd:
//   a[0..1]  y and z, n elements each, both f32 (bf16 0) or both bf16
//   a[2..3]  n, bf16
//   a[4]     vec: 16 bytes a thread (y and z 16-byte aligned), else one
//            element
//   a[5]     blocks: ceil(ceil(n / values a thread) / 256)
//   a[6..7]  the device, the stream
// and the slope, rounded to the dtype. Refuses (launching nothing) a grid
// that does not match n, or vectors the pointers do not allow. Returns the
// CUDA error, 0 on success.
int act_fwd(const long long* a, float slope) {
  const Args args = {nullptr, maml::ptr<const void>(a[0]),
                     maml::ptr<void>(a[1]), a[2], slope};
  return launch<true>(args, (int)a[3], (int)a[4], a[5], (int)a[6], a[7]);
}

// act_bwd, its arguments packed as act_fwd's, in the order of
// conv_block.act_bwd:
//   a[0..2]  da, y and dy, n elements each, all f32 (bf16 0) or all bf16
//   a[3..4]  n, bf16
//   a[5]     vec: 16 bytes a thread (da, y and dy 16-byte aligned), else
//            one element
//   a[6]     blocks: ceil(ceil(n / values a thread) / 256)
//   a[7..8]  the device, the stream
// and the slope, rounded to the dtype. Refuses as act_fwd.
int act_bwd(const long long* a, float slope) {
  const Args args = {maml::ptr<const void>(a[0]),
                     maml::ptr<const void>(a[1]), maml::ptr<void>(a[2]),
                     a[3], slope};
  return launch<false>(args, (int)a[4], (int)a[5], a[6], (int)a[7], a[8]);
}

// act_pool_fwd, its arguments packed as act_fwd's, in the order of
// conv_block.act_pool_fwd:
//   a[0..2]   y (T, N, H, W, C), the pooled values (T, N, H/2, W/2, C),
//             both f32 (bf16 0) or both bf16, and the uint8 argmax of the
//             pooled shape
//   a[3..7]   T, N, H, W, C (H, W >= 2)
//   a[8..10]  bf16; vec: 16 bytes of channels a thread (C a multiple of 4
//             f32 or 8 bf16, y and the pooled values 16-byte aligned, the
//             argmax on 4 or 8 bytes), else one channel; wide: 64-bit
//             index arithmetic, exactly where y holds 2**31 elements or
//             more
//   a[11]     blocks: ceil(T * N * (H/2) * (W/2) * C / channels a thread
//             / 256)
//   a[12..13] the device, the stream
// and the slope, rounded to the dtype. Refuses (launching nothing) a plan
// that does not match the shape, or vectors the pointers or C do not
// allow. Returns the CUDA error, 0 on success.
int act_pool_fwd(const long long* a, float slope) {
  PoolArgs p = {};
  p.y = maml::ptr<const void>(a[0]);
  p.out = maml::ptr<void>(a[1]);
  p.arg = maml::ptr<void>(a[2]);
  if (a[5] > 0x7fffffffLL || a[6] > 0x7fffffffLL || a[7] > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  p.H = (int)a[5], p.W = (int)a[6], p.C = (int)a[7];
  p.slope = slope;
  return launch_pool<kPoolFwd>(p, a[3], a[4], (int)a[8], (int)a[9],
                               (int)a[10], a[11], (int)a[12], a[13]);
}

// act_pool_bwd, its arguments packed as act_fwd's, in the order of
// conv_block.act_pool_bwd:
//   a[0..3]   the pooled gradient (T, N, H/2, W/2, C), its uint8 argmax,
//             y and dy (T, N, H, W, C), the three float tensors all f32
//             (bf16 0) or all bf16
//   a[4..8]   T, N, H, W, C (H, W >= 2)
//   a[9..11]  bf16, vec (as act_pool_fwd's; the pooled gradient 16-byte
//             aligned too), wide
//   a[12]     blocks: ceil(T * N * ceil(H/2) * ceil(W/2) * C / channels a
//             thread / 256): the dropped row and column's windows too
//   a[13..14] the device, the stream
// and the slope, rounded to the dtype. Refuses as act_pool_fwd.
int act_pool_bwd(const long long* a, float slope) {
  PoolArgs p = {};
  p.dp = maml::ptr<const void>(a[0]);
  p.arg = maml::ptr<void>(a[1]);
  p.y = maml::ptr<const void>(a[2]);
  p.out = maml::ptr<void>(a[3]);
  if (a[6] > 0x7fffffffLL || a[7] > 0x7fffffffLL || a[8] > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  p.H = (int)a[6], p.W = (int)a[7], p.C = (int)a[8];
  p.slope = slope;
  return launch_pool<kPoolBwd>(p, a[4], a[5], (int)a[9], (int)a[10],
                               (int)a[11], a[12], (int)a[13], a[14]);
}

// act_pool_gather, its arguments packed as act_fwd's, in the order of
// conv_block.act_pool_gather:
//   a[0..3]   g_dy and y (T, N, H, W, C), the uint8 argmax and the
//             gathered values (T, N, H/2, W/2, C), the three float
//             tensors all f32 (bf16 0) or all bf16
//   a[4..8]   T, N, H, W, C (H, W >= 2)
//   a[9..11]  bf16, vec (as act_pool_fwd's; g_dy 16-byte aligned too),
//             wide
//   a[12]     blocks: the forward's, ceil(T * N * (H/2) * (W/2) * C /
//             channels a thread / 256)
//   a[13..14] the device, the stream
// and the slope, rounded to the dtype. Refuses as act_pool_fwd.
int act_pool_gather(const long long* a, float slope) {
  PoolArgs p = {};
  p.dp = maml::ptr<const void>(a[0]);
  p.y = maml::ptr<const void>(a[1]);
  p.arg = maml::ptr<void>(a[2]);
  p.out = maml::ptr<void>(a[3]);
  if (a[6] > 0x7fffffffLL || a[7] > 0x7fffffffLL || a[8] > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  p.H = (int)a[6], p.W = (int)a[7], p.C = (int)a[8];
  p.slope = slope;
  return launch_pool<kPoolGather>(p, a[4], a[5], (int)a[9], (int)a[10],
                                  (int)a[11], a[12], (int)a[13], a[14]);
}

}  // extern "C"
