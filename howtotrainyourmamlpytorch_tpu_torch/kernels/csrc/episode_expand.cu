// episode_expand: few-shot episodes from uint8 pixels, on the card — gather
// of flat-store rows, the decode lookup, and a per-(task, class) rot90.
//
// Replaces (JAX package) howtotrainyourmamlpytorch_tpu/ops/
// device_pipeline.py ::make_decoder :62 (the (256, c) LUT gather),
// ::_rot_stack :84 (a lax.switch over four rot90s), ::make_serve_expander
// :178 and ::make_index_expander :209 (XLA's gather from the store). One
// kernel, three modes, chosen by which pointers are null:
//   (a) rows, no rot_k: gather + decode (serving's index ingest, and the
//       index ingest of sets that are not rotated);
//   (b) rows and rot_k: gather + decode + rot90 (train-time Omniglot);
//   (c) no rows: decode only, image i reading input row i (the uint8
//       ingest; one launch for the support and one for the query pixels).
//
// Every output element is a pure lookup: out[g, j, i, jj, c] =
// lut[store[row(g, j), i', jj', c'] * C + c], with (i', jj') the inverse of
// np.rot90(., k, axes=(1, 2)) and c' = C - 1 - c under reverse_channels (the
// flip acts on the uint8 pixels before the per-output-channel lookup, as
// the JAX decoder does). No arithmetic touches a pixel value: the LUT holds
// the host's own float32 decode (cast, /255, ImageNet normalisation) of all
// 256 values, so the kernel is bit-exact with its twin, and both with the
// host path, by construction. (Computing /255 here would invite the
// multiply-by-reciprocal drift the JAX decoder's docstring records.)
//
// Rows outside [0, n_store) follow jnp's store[gather] on the CPU: a
// negative row wraps once (+ n_store), then the row is clamped into range.
// A k outside [0, 3] is clamped, as lax.switch clamps its index.
//
// Two outputs: support columns [0, spc) go to out_s (G, spc, H, W, C),
// target columns [spc, S) to out_t (G, S - spc, H, W, C), both contiguous,
// so the conv wrappers (which refuse non-contiguous views) take them as they
// are.
//
// Bound on an H100: bytes. Each output float costs one uint8 read and one
// f32 write, 5 B per subpixel at 3.35 TB/s: a mini-ImageNet serve bucket of
// 8 (800 images of 84x84x3) moves 84.7 MB, 25.3 us; an Omniglot train batch
// of 8 (320 images of 28x28x1) 1.25 MB, 0.37 us, below launch latency. The
// design: the grid's x axis cuts one image into 4-float chunks, its y axis
// walks the images (a block takes every gridDim.y-th image, so the LUT it
// loads into shared memory, 256 x C floats, <= 3 KB for C = 3, serves
// several images); each thread writes its 4 consecutive output floats as
// one 16-byte store and, unrotated and unflipped, reads their 4 source
// bytes as one 32-bit load. Index arithmetic within an image is 32-bit (an
// image has far fewer than 2^31 subpixels) and walks the 4 elements
// incrementally; only the row and output offsets are 64-bit (a
// mini-ImageNet train store is 813 M bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace maml {

constexpr int kExpandThreads = 256;
// blocks in flight to aim for: about 16 per SM of an H100's 132
constexpr int kExpandTargetBlocks = 132 * 16;

__global__ void __launch_bounds__(kExpandThreads)
episode_expand_kernel(const uint8_t* __restrict__ store, long long n_store,
                      const int* __restrict__ rows,
                      const int* __restrict__ rot_k,
                      const float* __restrict__ lut, float* __restrict__ out_s,
                      float* __restrict__ out_t, int n_images, int S, int spc,
                      int H, int W, int C, int reverse, int vec4) {
  extern __shared__ float s_lut[];
  for (int i = threadIdx.x; i < 256 * C; i += blockDim.x) s_lut[i] = lut[i];
  __syncthreads();
  const int hwc = H * W * C;
  const int e0 = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e0 >= hwc) return;
  // output coordinates (i0, j0, c0) of this thread's first element
  const int c0 = e0 % C;
  const int p0 = e0 / C;
  const int i0 = p0 / W;
  const int j0 = p0 - i0 * W;
  for (int img = blockIdx.y; img < n_images; img += gridDim.y) {
    const int g = img / S;
    const int col = img - g * S;
    long long row = rows != nullptr ? (long long)rows[img] : img;
    if (row < 0) row += n_store;
    row = row < 0 ? 0 : (row >= n_store ? n_store - 1 : row);
    int k = rot_k != nullptr ? rot_k[g] : 0;
    k = k < 0 ? 0 : (k > 3 ? 3 : k);
    const uint8_t* src = store + row * hwc;
    float* dst = col < spc ? out_s + ((long long)g * spc + col) * hwc
                           : out_t + ((long long)g * (S - spc) + (col - spc)) *
                                         hwc;
    float v[4];
    if (vec4 && k == 0 && !reverse) {
      // the 4 outputs read the 4 source bytes at the same offsets
      const unsigned int b = *reinterpret_cast<const unsigned int*>(src + e0);
      int c = c0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = s_lut[(int)((b >> (8 * u)) & 0xffu) * C + c];
        c = c + 1 == C ? 0 : c + 1;
      }
    } else {
      int c = c0, i = i0, jj = j0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = 0.f;
        if (e0 + u < hwc) {
          int si, sj;  // the source pixel of output (i, jj) under rot90 by k
          switch (k) {
            case 0: si = i; sj = jj; break;
            case 1: si = jj; sj = W - 1 - i; break;
            case 2: si = H - 1 - i; sj = W - 1 - jj; break;
            default: si = H - 1 - jj; sj = i; break;
          }
          const int sc = reverse ? C - 1 - c : c;
          v[u] = s_lut[(int)src[(si * W + sj) * C + sc] * C + c];
        }
        if (++c == C) {
          c = 0;
          if (++jj == W) {
            jj = 0;
            ++i;
          }
        }
      }
    }
    if (vec4) {
      *reinterpret_cast<float4*>(dst + e0) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (e0 + u < hwc) dst[e0 + u] = v[u];
    }
  }
}

}  // namespace maml

extern "C" {

// store (n_store, H, W, C) uint8; rows (n_images) int32 or null (mode (c):
// image i reads row i); rot_k (n_images / S) int32 or null; lut (256, C)
// f32; out_s (n_images / S, spc, H, W, C) and out_t (n_images / S, S - spc,
// H, W, C) f32 (out_t unused when spc == S). One launch on `stream`;
// returns its CUDA error, 0 on success.
int episode_expand(const void* store, long long n_store, const void* rows,
                   const void* rot_k, const float* lut, float* out_s,
                   float* out_t, long long n_images, int S, int spc, int H,
                   int W, int C, int reverse, void* stream) {
  const long long hwc = (long long)H * W * C;
  if (n_store < 1 || n_images < 1 || n_images > 0x7fffffffLL || S < 1 ||
      spc < 0 || spc > S || n_images % S != 0 || H < 1 || W < 1 || C < 1 ||
      C > 32 || hwc > 0x7fffffffLL || (rot_k != nullptr && H != W))
    return (int)cudaErrorInvalidValue;
  // 16-byte stores need whole chunks and aligned outputs; the 32-bit
  // loads, 4-aligned images in the store
  const int vec4 = hwc % 4 == 0 && (uintptr_t)store % 4 == 0 &&
                   (uintptr_t)out_s % 16 == 0 &&
                   (out_t == nullptr || (uintptr_t)out_t % 16 == 0);
  const int chunk_blocks =
      (int)(((hwc + 3) / 4 + maml::kExpandThreads - 1) / maml::kExpandThreads);
  long long image_blocks =
      (maml::kExpandTargetBlocks + chunk_blocks - 1) / chunk_blocks;
  if (image_blocks > n_images) image_blocks = n_images;
  if (image_blocks > 65535) image_blocks = 65535;
  maml::episode_expand_kernel<<<dim3(chunk_blocks, (unsigned)image_blocks),
                                maml::kExpandThreads,
                                256 * C * sizeof(float),
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(store), n_store,
      static_cast<const int*>(rows), static_cast<const int*>(rot_k), lut,
      out_s, out_t, (int)n_images, S, spc, H, W, C, reverse, vec4);
  return (int)cudaGetLastError();
}

}  // extern "C"
