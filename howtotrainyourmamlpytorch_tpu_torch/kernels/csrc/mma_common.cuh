// What the bf16 tensor-core kernels (conv3x3_s1_bf16.cu: K1 and dgrad;
// conv3x3_wgrad_s1_bf16.cu: wgrad; conv3x3_s2.cu: K1 and dgrad at stride
// 2) share: ldmatrix and the m16n8k16 bf16
// mma.sync with f32 sums (inline PTX, sm_80 and later), and the copy of 8
// bf16 of a row into shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "band_common.cuh"

namespace maml {

using bf16 = __nv_bfloat16;

// ldmatrix / mma.sync (sm_80 and later; the card's m16n8k16 bf16 MMA)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t& r0, uint32_t& r1,
                                          uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 bf16 of a row in shared memory from global memory: one 16-byte
// cp.async where `vec` (all 8 inside the row, 16-byte aligned), else the
// `valid` ones element by element and zeros.
__device__ __forceinline__ void stage8(bf16* dst, const bf16* src, int valid,
                                       bool vec) {
  if (vec && valid >= 8) {
    cp_async16(dst, src);
    return;
  }
  __align__(16) bf16 v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = j < valid ? src[j] : __float2bfloat16_rn(0.f);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

}  // namespace maml
