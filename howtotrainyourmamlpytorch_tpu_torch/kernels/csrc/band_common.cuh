// What the band kernels (conv3x3_fwd_s1.cu, conv3x3_bwd_s1.cu) share: the
// cp.async copies into shared memory, the host's rounding and alignment
// helpers, the block limits their plans are sized for, and the raise of a
// kernel's dynamic shared memory limit.
#pragma once

#include <cuda_runtime.h>

namespace maml {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }
inline int round4(int a) { return (a + 3) & ~3; }
inline bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

// most threads a block: two blocks of 8 warps a SM leave 128 registers a
// thread (a SM sub-partition's 16K registers over its 4 warps)
constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // 227 KB: a block's most on sm_90

// Raise a kernel's dynamic shared memory limit to kMaxSmem and prefer the
// shared-memory carveout, once per kernel and device.
template <typename K>
cudaError_t allow_smem(K kernel, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  done[dev] = true;
  return cudaSuccess;
}

}  // namespace maml
