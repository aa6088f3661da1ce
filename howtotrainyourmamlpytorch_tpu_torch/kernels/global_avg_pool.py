"""Triton kernels of the global average pool: the forward (the mean over H
and W of each image and channel) and its backward (a broadcast).

Replace (JAX package) ``howtotrainyourmamlpytorch_tpu/ops/functional.py::
global_avg_pool2d`` :357, which the strided model (``max_pooling=False``,
``models/vgg.py`` :304-305) runs once after its last block, and the
gradient XLA derives for it.

Bound on an H100: bytes, and at the model's shapes the launch. The
forward reads (T, N, H, W, C) once and writes (T, N, C); at Omniglot's
width (T = 8, N = 20, 2x2x64) that is 40,960 floats in, 10,240 out —
about 0.06 us at 3.35 TB/s, far below one launch. One program per image
sums its H*W pixels in blocks of ``BLOCK_P`` rows of all channels, in a
fixed order (no atomics), and divides by H*W. The backward writes
``dpool / (H*W)`` at every pixel: one program per ``BLOCK_P`` pixels.
Both are linear, and each is the other's adjoint, so the Functions in
``conv_block.py`` (``Gap``, ``GapBwd``) close under differentiation.

bf16 (``compute_dtype='bfloat16'``): both take a ``BF16`` constexpr (the
f32 instantiations are unchanged) and round where the JAX package's bf16
``jnp.mean`` and its transpose do. The forward loads bf16, sums in f32,
divides the f32 sum by H*W in a true f32 division (``div_rn``, not a
multiply by 1 / (H*W)) and rounds once, ``bf16(sum(x) / HW)``; the
backward is ``bf16(f32(g) / HW)``, one division and one rounding per
pixel, so both equal their twins bit for bit wherever the f32 sums agree
(at 2x2 and 4x4 maps every f32 sum of bf16 activations is exact in
practice).

``triton`` is imported at the first launch, never at import (see
``bn_act_pool.py``).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

from .bn_act_pool import is_bf16

tl = None  # bound to ``triton.language`` by ``_jit()`` at the first launch

BLOCK_P = 16  # pixels per block step


def _gap_fwd_kernel(x_ptr, out_ptr, HW, C, BLOCK_P: "tl.constexpr",
                    BLOCK_C: "tl.constexpr", BF16: "tl.constexpr"):
    img = tl.program_id(0).to(tl.int64)
    c = tl.arange(0, BLOCK_C)
    cmask = c < C
    acc = tl.zeros([BLOCK_P, BLOCK_C], tl.float32)
    for i in range(0, HW, BLOCK_P):
        p = i + tl.arange(0, BLOCK_P)
        mask = (p < HW)[:, None] & cmask[None, :]
        off = (img * HW + p)[:, None] * C + c[None, :]
        acc += tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
    total = tl.sum(acc, axis=0)
    if BF16:
        # the f32 sum over a true f32 division, rounded once by the store
        mean = tl.math.div_rn(total, tl.zeros([BLOCK_C], tl.float32) + HW)
    else:
        mean = total / HW
    tl.store(out_ptr + img * C + c, mean.to(out_ptr.dtype.element_ty),
             mask=cmask)


def _gap_bwd_kernel(g_ptr, dx_ptr, P, HW, C, BLOCK_P: "tl.constexpr",
                    BLOCK_C: "tl.constexpr", BF16: "tl.constexpr"):
    p = tl.program_id(0).to(tl.int64) * BLOCK_P + tl.arange(0, BLOCK_P)
    c = tl.arange(0, BLOCK_C)
    mask = (p < P)[:, None] & (c < C)[None, :]
    g = tl.load(g_ptr + (p // HW)[:, None] * C + c[None, :], mask=mask,
                other=0.0).to(tl.float32)
    if BF16:
        dx = tl.math.div_rn(g, tl.zeros([BLOCK_P, BLOCK_C], tl.float32) + HW)
    else:
        dx = g / HW
    tl.store(dx_ptr + p[:, None] * C + c[None, :],
             dx.to(dx_ptr.dtype.element_ty), mask=mask)


@functools.lru_cache(maxsize=None)
def _jit() -> SimpleNamespace:
    import triton
    import triton.language

    global tl
    tl = triton.language
    return SimpleNamespace(
        fwd=triton.jit(_gap_fwd_kernel),
        bwd=triton.jit(_gap_bwd_kernel),
        next_power_of_2=triton.next_power_of_2,
    )


def launch_fwd(x, out) -> None:
    """The forward on a validated contiguous f32 or bf16 CUDA ``x`` (T, N,
    H, W, C) into ``out`` (T, N, C) of its dtype (see
    ``conv_block.global_avg_pool2d_fwd``)."""
    T, N, H, W, C = x.shape
    kern = _jit()
    kern.fwd[(T * N,)](x, out, H * W, C, BLOCK_P=BLOCK_P,
                       BLOCK_C=kern.next_power_of_2(C), BF16=is_bf16(x))


def launch_bwd(g, dx) -> None:
    """The backward: ``dx`` (T, N, H, W, C) from ``g`` (T, N, C), both f32
    or both bf16 (see ``conv_block.global_avg_pool2d_bwd``)."""
    T, N, H, W, C = dx.shape
    P = T * N * H * W
    kern = _jit()
    kern.bwd[(-(-P // BLOCK_P),)](g, dx, P, H * W, C, BLOCK_P=BLOCK_P,
                                  BLOCK_C=kern.next_power_of_2(C),
                                  BF16=is_bf16(g))
