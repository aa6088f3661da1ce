// What the sources whose entries take their arguments packed share
// (layer_norm.cu, bn_input_stats.cu, global_avg_pool.cu): loads and stores
// of V values of f32 or bf16 (16 bytes, or one value), widened to f32 and
// rounded once at the store, and the host side of an entry (the device
// made current for the call, the packed pointers, alignment).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace maml {

typedef __nv_bfloat16 bf16_t;

// -- loads and stores of V values (16 bytes, or one value) ---------------

// The raw 16 bytes of a load, or one value.
template <typename T, int V>
struct Packet;
template <>
struct Packet<float, 4> {
  float4 v;
};
template <>
struct Packet<bf16_t, 8> {
  uint4 v;
};
template <typename T>
struct Packet<T, 1> {
  T v;
};

__device__ __forceinline__ float bf_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned short bf_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// kLast: the pass's last read of the data, with an evict-first hint
template <bool kLast>
__device__ __forceinline__ void load(const float* p, Packet<float, 4>& q) {
  const float4* a = reinterpret_cast<const float4*>(p);
  q.v = kLast ? __ldcs(a) : __ldg(a);
}
template <bool kLast>
__device__ __forceinline__ void load(const bf16_t* p, Packet<bf16_t, 8>& q) {
  const uint4* a = reinterpret_cast<const uint4*>(p);
  q.v = kLast ? __ldcs(a) : __ldg(a);
}
template <bool kLast>
__device__ __forceinline__ void load(const float* p, Packet<float, 1>& q) {
  q.v = kLast ? __ldcs(p) : __ldg(p);
}
template <bool kLast>
__device__ __forceinline__ void load(const bf16_t* p, Packet<bf16_t, 1>& q) {
  const unsigned short* a = reinterpret_cast<const unsigned short*>(p);
  q.v = __ushort_as_bfloat16(kLast ? __ldcs(a) : __ldg(a));
}

// value i of a packet, as f32
__device__ __forceinline__ float at(const Packet<float, 4>& q, int i) {
  return i == 0 ? q.v.x : i == 1 ? q.v.y : i == 2 ? q.v.z : q.v.w;
}
__device__ __forceinline__ float at(const Packet<bf16_t, 8>& q, int i) {
  const unsigned w = i < 2 ? q.v.x : i < 4 ? q.v.y : i < 6 ? q.v.z : q.v.w;
  return (i & 1) ? bf_hi(w) : bf_lo(w);
}
__device__ __forceinline__ float at(const Packet<float, 1>& q, int) {
  return q.v;
}
__device__ __forceinline__ float at(const Packet<bf16_t, 1>& q, int) {
  return __bfloat162float(q.v);
}

template <typename T, int V>
__device__ __forceinline__ void zero(Packet<T, V>& q) {
  q.v = decltype(q.v){};
}

// V values rounded once to T and stored (streaming with kStream)
template <bool kStream>
__device__ __forceinline__ void store(float* p, const float (&o)[4]) {
  const float4 v = make_float4(o[0], o[1], o[2], o[3]);
  if (kStream)
    __stcs(reinterpret_cast<float4*>(p), v);
  else
    *reinterpret_cast<float4*>(p) = v;
}
template <bool kStream>
__device__ __forceinline__ void store(bf16_t* p, const float (&o)[8]) {
  uint4 v;
  v.x = bf_bits(o[0]) | ((unsigned)bf_bits(o[1]) << 16);
  v.y = bf_bits(o[2]) | ((unsigned)bf_bits(o[3]) << 16);
  v.z = bf_bits(o[4]) | ((unsigned)bf_bits(o[5]) << 16);
  v.w = bf_bits(o[6]) | ((unsigned)bf_bits(o[7]) << 16);
  if (kStream)
    __stcs(reinterpret_cast<uint4*>(p), v);
  else
    *reinterpret_cast<uint4*>(p) = v;
}
template <bool kStream>
__device__ __forceinline__ void store(float* p, const float (&o)[1]) {
  if (kStream)
    __stcs(p, o[0]);
  else
    *p = o[0];
}
template <bool kStream>
__device__ __forceinline__ void store(bf16_t* p, const float (&o)[1]) {
  const unsigned short b = bf_bits(o[0]);
  if (kStream)
    __stcs(reinterpret_cast<unsigned short*>(p), b);
  else
    *reinterpret_cast<unsigned short*>(p) = b;
}

// one value, as f32
__device__ __forceinline__ float scalar(const float* p) { return *p; }
__device__ __forceinline__ float scalar(const bf16_t* p) {
  return __bfloat162float(*p);
}

// -- the host side of an entry ---------------------------------------------

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline bool aligned(const void* p, unsigned long long bytes) {
  return (reinterpret_cast<unsigned long long>(p) & (bytes - 1)) == 0;
}

// The device the entries launch on made current for the call, and the
// caller's restored after it.
struct OnDevice {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit OnDevice(int device) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      prev = cur;
    }
  }
  ~OnDevice() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// a pointer passed as one of the packed 64-bit integers
template <typename P>
P* ptr(long long v) {
  return reinterpret_cast<P*>(v);
}

// a CUDA launch's error: the launch's own, else the last
inline int launch_error(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace maml
