// What the stride-2 wgrad tile (conv3x3_bwd.cu, both dtypes) takes from
// the tile design it kept: the element type's widening to f32, the block
// size, the out-of-image marker and the host's division.
// The other convs run other kernels: at stride 1 the f32 band kernels of
// conv3x3_fwd_s1.cu and conv3x3_bwd_s1.cu and the bf16 tensor-core kernels
// of conv3x3_s1_bf16.cu and conv3x3_wgrad_s1_bf16.cu; K1 and dgrad at
// stride 2 the band kernels of conv3x3_s2.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace maml {

// An element widened to f32.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int kThreads = 128;
constexpr int kOutOfImage = -1000000;  // a row or tap that never lands in bounds

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace maml
