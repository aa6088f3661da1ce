// The global average pool and its backward, f32 and bf16, one launch a
// call each.
//
// Replaces (JAX package) howtotrainyourmamlpytorch_tpu/ops/functional.py::
// global_avg_pool2d :357 (jnp.mean over H and W, :360), which
// models/vgg.py:305 runs after the strided model's last block
// (max_pooling=False), and the gradient XLA derives for it. The twins are
// ops/functional.py::global_avg_pool2d :318 and ::global_avg_pool2d_bwd
// :677 of the port. The two are each other's adjoint, so the Functions Gap
// and GapBwd (kernels/conv_block.py) close under differentiation.
//
//   forward:  x (T, N, H, W, C) -> out (T, N, C), each image's H * W
//             pixels summed in pixel order in f32 and divided by H * W
//             (an IEEE division, as jnp.mean divides);
//   backward: g (T, N, C) -> dx (T, N, H, W, C), every pixel g / (H * W).
//
// bf16 loads bf16, sums in f32 and rounds once at the store: bf16(sum /
// HW) and bf16(f32(g) / HW), the twins' rounding points.
//
// Bound on an H100: bytes, and at the model's shapes the launch: the
// largest map is the unpadded strided model's 4 x 4 x 48 at T = 8, N = 75
// (1.8 MB in f32, 0.5 us at 3.35 TB/s). A thread takes one image's V
// consecutive channels (V = 4 in f32, 8 in bf16: 16-byte loads, where C is
// a multiple of V and x is 16-byte aligned; else one), a few thousand
// threads in all; the backward a thread 16 bytes of dx (V values of one
// pixel, C a multiple of V; else one value), reading g a value at a time.
// The host time of a call sets its time, so the entries take their
// arguments packed in one ctypes argument and set the device themselves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec_io.cuh"

namespace {

using maml::at;
using maml::bf16_t;
using maml::load;
using maml::Packet;
using maml::scalar;
using maml::store;

constexpr int kThreads = 256;  // a block, both kernels

// A thread an (image, V channels): items = images * C / V.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    global_avg_pool_fwd_kernel(const T* __restrict__ x, T* __restrict__ out,
                               int items, int HW, int C) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= items) return;
  const int groups = C / V;
  const int img = i / groups, c0 = (i - img * groups) * V;
  const T* p = x + (size_t)img * HW * C + c0;
  float s[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = 0.f;
  for (int q = 0; q < HW; ++q) {
    Packet<T, V> v;
    load<false>(p + (size_t)q * C, v);
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] += at(v, k);
  }
  const float hw = (float)HW;
#pragma unroll
  for (int k = 0; k < V; ++k) s[k] = s[k] / hw;
  store<false>(out + (size_t)img * C + c0, s);
}

// A thread V consecutive values of dx (one pixel's channels [c0, c0 + V)):
// n = the values of dx / V.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    global_avg_pool_bwd_kernel(const T* __restrict__ g, T* __restrict__ dx,
                               long long n, int HW, int C) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long e = i * V;
  const long long pixel = e / C;
  const int c0 = (int)(e - pixel * C);
  const T* src = g + (pixel / HW) * C + c0;
  const float hw = (float)HW;
  float o[V];
#pragma unroll
  for (int k = 0; k < V; ++k) o[k] = scalar(src + k) / hw;
  store<false>(dx + e, o);
}

using maml::aligned;
using maml::OnDevice;
using maml::ptr;

inline int load_width(int bf16) { return bf16 ? 8 : 4; }

template <typename T>
cudaError_t launch_fwd(const long long* a, int V, cudaStream_t st) {
  const int images = (int)a[2], HW = (int)a[3], C = (int)a[4];
  const int items = (int)((long long)images * C / V);
  const dim3 grid((items + kThreads - 1) / kThreads), block(kThreads);
  const T* x = ptr<const T>(a[0]);
  T* out = ptr<T>(a[1]);
  if (V == 1)
    global_avg_pool_fwd_kernel<T, 1><<<grid, block, 0, st>>>(x, out, items,
                                                             HW, C);
  else
    global_avg_pool_fwd_kernel<T, sizeof(T) == 4 ? 4 : 8>
        <<<grid, block, 0, st>>>(x, out, items, HW, C);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_bwd(const long long* a, int V, cudaStream_t st) {
  const int images = (int)a[2], HW = (int)a[3], C = (int)a[4];
  const long long n = (long long)images * HW * C / V;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads)), block(kThreads);
  const T* g = ptr<const T>(a[0]);
  T* dx = ptr<T>(a[1]);
  if (V == 1)
    global_avg_pool_bwd_kernel<T, 1><<<grid, block, 0, st>>>(g, dx, n, HW, C);
  else
    global_avg_pool_bwd_kernel<T, sizeof(T) == 4 ? 4 : 8>
        <<<grid, block, 0, st>>>(g, dx, n, HW, C);
  return cudaSuccess;
}

// The checks both entries share; V (the values a thread) on success.
int check(const long long* a, int* V) {
  const long long images = a[2], HW = a[3], C = a[4];
  const int bf16 = (int)a[5], vec = (int)a[6];
  if (images < 1 || HW < 1 || C < 1 || images * C > 0x7fffffffLL ||
      images * HW * C >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  *V = vec ? load_width(bf16) : 1;
  return C % *V ? (int)cudaErrorInvalidValue : 0;
}

}  // namespace

extern "C" {

// The forward. Arguments packed as 64-bit integers (the order of
// conv_block.global_avg_pool2d_fwd):
//   a[0..1] x (images of HW pixels x C channels, f32 or bf16 by bf16), out
//           (images, C) of x's dtype
//   a[2..6] images (T * N), HW, C, bf16, vec (16-byte loads: C a multiple
//           of a load's values, x and out 16-byte aligned)
//   a[7..8] the device, the stream
// Refuses (launching nothing) vectors that C or the pointers do not allow.
// Returns the CUDA error, 0 on success.
int global_avg_pool_fwd(const long long* a) {
  int V;
  if (const int bad = check(a, &V)) return bad;
  if (V > 1 && !(aligned(ptr<void>(a[0]), 16) && aligned(ptr<void>(a[1]), 16)))
    return (int)cudaErrorInvalidValue;
  OnDevice on((int)a[7]);
  if (on.err != cudaSuccess) return (int)on.err;
  const cudaStream_t st = ptr<CUstream_st>(a[8]);
  return maml::launch_error(a[5] ? launch_fwd<bf16_t>(a, V, st)
                                 : launch_fwd<float>(a, V, st));
}

// The backward, packed as the forward's (conv_block.global_avg_pool2d_bwd):
//   a[0..1] g (images, C), dx (images of HW pixels x C channels), both f32
//           or both bf16
//   a[2..6] images, HW, C, bf16, vec (16-byte stores: C a multiple of a
//           store's values, dx 16-byte aligned)
//   a[7..8] the device, the stream
int global_avg_pool_bwd(const long long* a) {
  int V;
  if (const int bad = check(a, &V)) return bad;
  if (V > 1 && !aligned(ptr<void>(a[1]), 16))
    return (int)cudaErrorInvalidValue;
  OnDevice on((int)a[7]);
  if (on.err != cudaSuccess) return (int)on.err;
  const cudaStream_t st = ptr<CUstream_st>(a[8]);
  return maml::launch_error(a[5] ? launch_bwd<bf16_t>(a, V, st)
                                 : launch_bwd<float>(a, V, st));
}

}  // extern "C"
