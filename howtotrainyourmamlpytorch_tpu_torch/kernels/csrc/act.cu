// act_bwd: the leaky-ReLU's backward with no pool, dy = y >= 0 ? da : da *
// slope, flat over the tensor, in f32 and bf16, one launch a call: the
// strided norm-first and layer-norm models' activation gradient (linear
// in da, and its own adjoint: the gradient of the gradient too).
//
// Replaces (JAX package) howtotrainyourmamlpytorch_tpu/ops/functional.py:
// the gradient XLA derives for `leaky_relu` :363 after the conv of the
// norm-first block with no pool (models/vgg.py:300-302). The twin is
// ops/functional.py::act_bwd of the port.
//
// Rounding: in f32 one multiply; in bf16 the product of two bf16 values
// (da and the slope's bf16 value) is exact in f32, so one rounding at the
// store gives the twin's bits (the JAX package's `select(y >= 0, g,
// bf16(slope * g))`). Bit for bit the twin in both dtypes.
//
// Bound on an H100: bytes (3.35 TB/s; a select and a multiply an
// element): read da and y, write dy. A thread takes 16 bytes of each (4
// f32 or 8 bf16), evict-first loads (read once), cached stores (the next
// kernel reads dy); the last partial vector, and tensors off 16-byte
// alignment, one element a thread.

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
  const void* da;
  const void* y;
  void* dy;
  long long n;  // elements
  float slope;
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) act_bwd_kernel(const Args a) {
  const long long e0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * V;
  if (e0 >= a.n) return;
  const T* da = static_cast<const T*>(a.da) + e0;
  const T* y = static_cast<const T*>(a.y) + e0;
  T* dy = static_cast<T*>(a.dy) + e0;
  if constexpr (V > 1) {
    if (e0 + V <= a.n) {
      Packet<T, V> qd, qy;
      load<true>(da, qd);
      load<true>(y, qy);
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = at(qd, i);
        o[i] = at(qy, i) >= 0.f ? d : __fmul_rn(d, a.slope);
      }
      maml::store<false>(dy, o);
      return;
    }
  }
  // the last partial vector, or one element a thread
  for (int i = 0; i < V && e0 + i < a.n; ++i) {
    Packet<T, 1> qd, qy;
    load<true>(da + i, qd);
    load<true>(y + i, qy);
    const float d = at(qd, 0);
    const float o[1] = {at(qy, 0) >= 0.f ? d : __fmul_rn(d, a.slope)};
    maml::store<false>(dy + i, o);
  }
}

template <typename T>
const void* kernel_for(int vec) {
  constexpr int V = sizeof(T) == 4 ? 4 : 8;
  return vec ? reinterpret_cast<const void*>(act_bwd_kernel<T, V>)
             : reinterpret_cast<const void*>(act_bwd_kernel<T, 1>);
}

}  // namespace

extern "C" {

// act_bwd. The arguments come packed as 64-bit integers (one ctypes
// argument), in the order of conv_block.act_bwd:
//   a[0..2]  da, y and dy, n elements each, all f32 (bf16 0) or all bf16
//   a[3..4]  n, bf16
//   a[5]     vec: 16 bytes a thread (da, y and dy 16-byte aligned), else
//            one element
//   a[6]     blocks: ceil(ceil(n / values a thread) / 256)
//   a[7..8]  the device, the stream
// and the slope, rounded to the dtype. Refuses (launching nothing) a grid
// that does not match n, or vectors the pointers do not allow. Returns the
// CUDA error, 0 on success.
int act_bwd(const long long* a, float slope) {
  const long long n = a[3], blocks = a[6];
  const int bf16 = (int)a[4], vec = (int)a[5];
  const void* da = maml::ptr<const void>(a[0]);
  const void* y = maml::ptr<const void>(a[1]);
  void* dy = maml::ptr<void>(a[2]);
  const long long per = vec ? (bf16 ? 8 : 4) : 1;
  const long long threads = (n + per - 1) / per;
  if (n < 1 || blocks != (threads + kThreads - 1) / kThreads ||
      blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (vec && !(maml::aligned(da, 16) && maml::aligned(y, 16) &&
               maml::aligned(dy, 16)))
    return (int)cudaErrorInvalidValue;
  maml::OnDevice on((int)a[7]);
  if (on.err != cudaSuccess) return (int)on.err;
  Args args = {da, y, dy, n, slope};
  void* params[] = {&args};
  const void* k = bf16 ? kernel_for<bf16_t>(vec) : kernel_for<float>(vec);
  return maml::launch_error(cudaLaunchKernel(
      k, dim3((unsigned)blocks), dim3(kThreads), params, 0,
      maml::ptr<CUstream_st>(a[8])));
}

}  // extern "C"
