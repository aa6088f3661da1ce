"""The Triton kernel of ``act_pool_gather``: the gradient of the
standalone leaky-ReLU + 2x2 max pool's backward (B2) in its cotangent,
``g_dy * leaky_relu'(y)`` gathered at each window's argmax, for the
norm-first and layer-norm blocks. The act-pool forward and backward
(``act_pool_fwd``, ``act_pool_bwd``) and the pool-free mode (``act_fwd``,
``act_bwd``) are CUDA: ``csrc/act.cu``, launched by ``conv_block``.

Replaces (JAX package) the gradient XLA derives for the gradient of
``howtotrainyourmamlpytorch_tpu/ops/functional.py::max_pool2d`` :325 and
``leaky_relu`` :363 as ``models/vgg.py`` :300-302 calls them after the
conv. Ties follow the JAX package's accelerator lowering
(``reduce_window``: the whole gradient to the first maximum), whatever
``pool_impl`` says: the argmax is ``act_pool_fwd``'s, uint8 ``2 * dh +
dw``.

Bound on an H100: bytes. It reads the pooled argmax and, at it, g_dy and
y, and writes the pooled quarter; one launch, no reduction across
programs.

Tiles are ``tile(C)``: ``(BLOCK_P pixels, BLOCK_C)`` with ``BLOCK_C``
the power of two at or above C (at least 2) and ``BLOCK_P * BLOCK_C =
TILE`` (C = 48: 3 of 4 lanes).

bf16 (``compute_dtype='bfloat16'``): it loads bf16, works in f32 and
stores bf16, with the slope the bf16 value of 0.01 (the wrapper rounds
it). The JAX package's bf16 leaky-ReLU gradient is ``select(y >= 0, g,
bf16(slope * g))``: a product of two bf16 values is exact in f32, so one
rounding at the store gives the twin's bits.

``triton`` is imported at the first launch, never at import (see
``bn_act_pool.py``).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

tl = None  # bound to ``triton.language`` by ``_jit()`` at the first launch

TILE = 4096  # elements per tile: BLOCK_P x BLOCK_C


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile(C: int) -> tuple:
    """``(block_p, block_c)`` for C channels: ``block_c`` the power of two
    at or above C (at least 2), ``block_p * block_c = TILE``."""
    block_c = max(2, 1 << max(0, C - 1).bit_length())
    return max(1, TILE // block_c), block_c


def _act_pool_gather_kernel(g_ptr, arg_ptr, y_ptr, out_ptr, P, HoWo, Wo, H,
                            W, C, slope, BLOCK_P: "tl.constexpr",
                            BLOCK_C: "tl.constexpr"):
    p = tl.program_id(0).to(tl.int64) * BLOCK_P + tl.arange(0, BLOCK_P)
    c = tl.arange(0, BLOCK_C)
    mask = (p < P)[:, None] & (c < C)[None, :]
    img = p // HoWo
    r = p % HoWo
    ho = r // Wo
    wo = r % Wo
    out = p[:, None] * C + c[None, :]
    k = tl.load(arg_ptr + out, mask=mask, other=0).to(tl.int32)
    off = (((img * H + 2 * ho)[:, None] + k // 2) * W
           + 2 * wo[:, None] + k % 2) * C + c[None, :]
    g = tl.load(g_ptr + off, mask=mask, other=0.0).to(tl.float32)
    v = tl.load(y_ptr + off, mask=mask, other=0.0).to(tl.float32)
    a = tl.where(v >= 0, g, g * slope)
    tl.store(out_ptr + out, a.to(out_ptr.dtype.element_ty), mask=mask)


@functools.lru_cache(maxsize=None)
def _jit() -> SimpleNamespace:
    import triton
    import triton.language

    global tl
    tl = triton.language
    return SimpleNamespace(pool_gather=triton.jit(_act_pool_gather_kernel))


def launch_pool_gather(g_dy, arg, y, out, slope: float) -> None:
    """``act_pool_gather``: the pooled ``out`` from ``g_dy`` (the shape of
    y) at the argmax."""
    T, N, H, W, C = y.shape
    Ho, Wo = H // 2, W // 2
    P = T * N * Ho * Wo
    bp, bc = tile(C)
    _jit().pool_gather[(cdiv(P, bp),)](g_dy, arg, y, out, P, Ho * Wo, Wo,
                                       H, W, C, slope, BLOCK_P=bp,
                                       BLOCK_C=bc)
