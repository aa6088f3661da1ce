// What the four K4 wgrad kernels share (the f32 band kernel of
// conv3x3_bwd_s1.cu, the bf16 tensor-core kernel of
// conv3x3_wgrad_s1_bf16.cu, and the f32 band and bf16 tensor-core kernels
// at stride 2 of conv3x3_wgrad_s2.cu): their entries' packed arguments, and
// the second launch, dw[t][e] = sum_s part_w[t][s][e] and db[t][c] = sum_s
// part_b[t][s][c] over each tenant's S split partials in split order (no
// atomics: a second launch gives the first one's bits), rounded once to the
// element type at the store (f32: stored as summed).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace maml {

__device__ __forceinline__ void store_sum(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_sum(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename E>
__global__ void conv3x3_wgrad_reduce_kernel(const float* __restrict__ part_w,
                                            const float* __restrict__ part_b,
                                            E* __restrict__ dw,
                                            E* __restrict__ db, int T,
                                            int S, int KC, int cout) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int per = KC + cout;
  if (idx >= (long long)T * per) return;
  const int t = (int)(idx / per);
  const int e = (int)(idx % per);
  float sum = 0.f;
  if (e < KC) {
    for (int s = 0; s < S; ++s) sum += part_w[((size_t)t * S + s) * KC + e];
    store_sum(dw + (size_t)t * KC + e, sum);
  } else {
    const int c = e - KC;
    for (int s = 0; s < S; ++s) sum += part_b[((size_t)t * S + s) * cout + c];
    store_sum(db + t * cout + c, sum);
  }
}

// The reduce of T tenants' partials (KC = 9 cin cout weights and cout
// biases each) on `st`; returns its launch's CUDA error.
template <typename E>
cudaError_t launch_wgrad_reduce(const float* part_w, const float* part_b,
                                E* dw, E* db, int T, int S, int KC, int cout,
                                cudaStream_t st) {
  const long long total = (long long)T * (KC + cout);
  conv3x3_wgrad_reduce_kernel<E>
      <<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part_w, part_b, dw,
                                                        db, T, S, KC, cout);
  return cudaGetLastError();
}

// The arguments of every wgrad entry, packed as 64-bit integers (one
// ctypes argument: a call's host time counts at the small maps), in the
// order of kernels/conv_block.py::conv3x3_wgrad:
//   a[0..5]    x, dy, part_w, part_b, dw, db
//   a[6..12]   T, N, H, W, pad, cin, cout
//   a[13..19]  the plan: splits, band_rows, kernel_rows, groups, replicas,
//              m_tiles, channels (each entry reads its kernel's)
//   a[20..21]  threads, smem
//   a[22..23]  the device, the stream
struct WgradCall {
  const void* x;
  const void* dy;
  float* part_w;
  float* part_b;
  void* dw;
  void* db;
  int T, N, H, W, pad, cin, cout;
  int splits, band_rows, kernel_rows, groups, replicas, m_tiles, channels;
  int threads, smem, device;
  cudaStream_t stream;
};

// A packed integer as an int; out of range becomes -1, which every entry's
// geometry check refuses.
inline int packed_int(long long v) {
  return v < 0 || v > 0x7fffffffll ? -1 : (int)v;
}

inline WgradCall unpack_wgrad(const long long* a) {
  WgradCall c;
  c.x = reinterpret_cast<const void*>(a[0]);
  c.dy = reinterpret_cast<const void*>(a[1]);
  c.part_w = reinterpret_cast<float*>(a[2]);
  c.part_b = reinterpret_cast<float*>(a[3]);
  c.dw = reinterpret_cast<void*>(a[4]);
  c.db = reinterpret_cast<void*>(a[5]);
  int* v[] = {&c.T,      &c.N,         &c.H,          &c.W,
              &c.pad,    &c.cin,       &c.cout,       &c.splits,
              &c.band_rows, &c.kernel_rows, &c.groups, &c.replicas,
              &c.m_tiles, &c.channels, &c.threads,    &c.smem,
              &c.device};
  for (int i = 0; i < 17; ++i) *v[i] = packed_int(a[6 + i]);
  c.stream = reinterpret_cast<cudaStream_t>(a[23]);
  return c;
}

// The call's device made current for the entry, and the caller's restored
// after it.
struct WgradDevice {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit WgradDevice(int device) {
    int cur = 0;
    err = device < 0 ? cudaErrorInvalidDevice : cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      prev = cur;
    }
  }
  ~WgradDevice() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace maml
