// The leaky-ReLU with no pool, flat over the tensor, in f32 and bf16, one
// launch a call each way: the strided norm-first and layer-norm models'
// activation after the conv.
//   act_fwd: z = y >= 0 ? y : y * slope;
//   act_bwd: dy = y >= 0 ? da : da * slope (linear in da, and its own
//            adjoint: the gradient of the gradient too).
//
// Replaces (JAX package) howtotrainyourmamlpytorch_tpu/ops/functional.py:
// `leaky_relu` :363 after the conv of the norm-first block with no pool
// (models/vgg.py:300-302), and the gradient XLA derives for it. The twins
// are ops/functional.py::act_fwd and ::act_bwd of the port.
//
// Rounding: in f32 one multiply; in bf16 the product of two bf16 values
// (y or da, and the slope's bf16 value) is exact in f32, so one rounding
// at the store gives the twin's bits (the JAX package's `select(y >= 0, y,
// bf16(slope * y))` and `select(y >= 0, g, bf16(slope * g))`). Bit for bit
// the twins in both dtypes.
//
// Bound on an H100: bytes (3.35 TB/s; a select and a multiply an
// element): the forward reads y and writes z, the backward reads da and y
// and writes dy. A thread takes 16 bytes of each (4 f32 or 8 bf16),
// evict-first loads (read once), cached stores (the next kernel reads the
// output); the last partial vector, and tensors off 16-byte alignment, one
// element a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // extern "C"
