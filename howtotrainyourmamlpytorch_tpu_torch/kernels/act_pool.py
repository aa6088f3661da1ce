"""Triton kernels of the standalone leaky-ReLU + 2x2 max pool (B2) and its
derivatives, for the norm-first block (``block_order='norm_conv_relu'``),
whose activation follows the conv with no batch norm between (the
pool-free mode, ``act_fwd`` and ``act_bwd``, is CUDA: ``csrc/act.cu``,
launched by ``conv_block.act_fwd`` / ``act_bwd``):

* ``act_pool_fwd``: leaky-ReLU, then the 2x2/2 max pool (VALID: an odd
  trailing row or column is dropped) and each pooled element's window
  argmax, uint8 ``2 * dh + dw``, taken over the activated values, the
  first maximum on ties (``upd = a > best``, as K2);
* ``act_pool_bwd``: each pooled gradient to its argmax times
  ``leaky_relu'(y)`` (1 where y >= 0, else the slope), zero elsewhere;
* ``act_pool_gather``: the adjoint of ``act_pool_bwd`` in its gradient,
  ``g_dy * leaky_relu'(y)`` gathered at the argmax.

Replace (JAX package) ``howtotrainyourmamlpytorch_tpu/ops/functional.py::
max_pool2d`` :325 and ``leaky_relu`` :363 as ``models/vgg.py`` :300-302
calls them after the conv, and the gradients XLA derives for them. Ties
follow the JAX package's accelerator lowering (``reduce_window``: the whole
gradient to the first maximum), whatever ``pool_impl`` says; its CPU
lowering (``reshape``) splits it among the tied maxima.

Bound on an H100: bytes. Every pass is elementwise or a 2x2 window with
no reduction across programs and one compare or select per element. The
forward reads y once and writes the pooled quarter plus a one-byte argmax;
the backward reads the pooled gradient and the argmax and writes dy once
(y only where a window routes its gradient); the gather reads the pooled
argmax and, at it, g_dy and y, and writes the pooled quarter. Each is
one launch.

Tiles are ``tile(C)``: ``(BLOCK_P pixels, BLOCK_C)`` with ``BLOCK_C``
the power of two at or above C (at least 2) and ``BLOCK_P * BLOCK_C =
TILE`` (C = 48: 3 of 4 lanes).

bf16 (``compute_dtype='bfloat16'``): every kernel loads bf16, works in
f32 and stores bf16, with the slope the bf16 value of 0.01 (the
wrappers round it). The JAX package's bf16 leaky-ReLU and its gradient
are ``select(y >= 0, y, bf16(slope * y))`` and ``select(y >= 0, g,
bf16(slope * g))``: a product of two bf16 values is exact in f32, so one
rounding at the store gives the twin's bits in ``act_pool_bwd`` and
``act_pool_gather`` with no constexpr (their f32 instantiations are
unchanged). ``act_pool_fwd`` takes a ``BF16``
constexpr: it rounds the negative side to bf16 before the window compare
(``_rne_bf16``), so that exact bf16 ties, far more frequent than in f32,
go to the first maximum as ``reduce_window``'s do, and its pooled values
and argmax equal the twin's bit for bit.

``triton`` is imported at the first launch, never at import (see
``bn_act_pool.py``).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

from . import bn_act_pool

tl = None  # bound to ``triton.language`` by ``_jit()`` at the first launch
_rne_bf16 = None  # bound to ``bn_act_pool``'s jitted rounding by ``_jit()``

TILE = 4096  # elements per tile: BLOCK_P x BLOCK_C


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile(C: int) -> tuple:
    """``(block_p, block_c)`` for C channels: ``block_c`` the power of two
    at or above C (at least 2), ``block_p * block_c = TILE``."""
    block_c = max(2, 1 << max(0, C - 1).bit_length())
    return max(1, TILE // block_c), block_c


def _act_pool_fwd_kernel(y_ptr, out_ptr, arg_ptr, P, HoWo, Wo, H, W, C,
                         slope, BLOCK_P: "tl.constexpr",
                         BLOCK_C: "tl.constexpr", BF16: "tl.constexpr"):
    p = tl.program_id(0).to(tl.int64) * BLOCK_P + tl.arange(0, BLOCK_P)
    c = tl.arange(0, BLOCK_C)
    mask = (p < P)[:, None] & (c < C)[None, :]
    img = p // HoWo
    r = p % HoWo
    ho = r // Wo
    wo = r % Wo
    base = ((img * H + 2 * ho) * W + 2 * wo) * C
    best = tl.full([BLOCK_P, BLOCK_C], float("-inf"), tl.float32)
    arg = tl.zeros([BLOCK_P, BLOCK_C], dtype=tl.int32)
    for k in tl.static_range(4):
        off = base + ((k // 2) * W + (k % 2)) * C
        v = tl.load(y_ptr + off[:, None] + c[None, :], mask=mask,
                    other=0.0).to(tl.float32)
        if BF16:
            # the negative side rounded to bf16 before the compare, so
            # that ties fall as they do in bf16
            a = tl.where(v >= 0, v, _rne_bf16(v * slope))
        else:
            a = tl.where(v >= 0, v, v * slope)
        upd = a > best
        best = tl.where(upd, a, best)
        arg = tl.where(upd, k, arg)
    out = p[:, None] * C + c[None, :]
    tl.store(out_ptr + out, best.to(out_ptr.dtype.element_ty), mask=mask)
    tl.store(arg_ptr + out, arg.to(tl.uint8), mask=mask)


def _act_pool_bwd_kernel(dp_ptr, arg_ptr, y_ptr, dy_ptr, NP, HW, W, Ho, Wo,
                         C, slope, BLOCK_P: "tl.constexpr",
                         BLOCK_C: "tl.constexpr"):
    q = tl.program_id(0).to(tl.int64) * BLOCK_P + tl.arange(0, BLOCK_P)
    c = tl.arange(0, BLOCK_C)
    mask = (q < NP)[:, None] & (c < C)[None, :]
    img = q // HW
    r = q % HW
    h = r // W
    w = r % W
    ho = h // 2
    wo = w // 2
    pmask = mask & ((ho < Ho) & (wo < Wo))[:, None]
    poff = ((img * Ho + ho) * Wo + wo)[:, None] * C + c[None, :]
    k = tl.load(arg_ptr + poff, mask=pmask, other=255).to(tl.int32)
    sel = pmask & (k == ((h % 2) * 2 + (w % 2))[:, None])
    d = tl.load(dp_ptr + poff, mask=sel, other=0.0).to(tl.float32)
    off = q[:, None] * C + c[None, :]
    v = tl.load(y_ptr + off, mask=sel, other=0.0).to(tl.float32)
    dy = tl.where(v >= 0, d, d * slope)
    tl.store(dy_ptr + off, dy.to(dy_ptr.dtype.element_ty), mask=mask)


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

    global tl, _rne_bf16
    tl = triton.language
    # the pool's forward calls bn_act_pool's jitted rounding by this name
    _rne_bf16 = bn_act_pool._jit().rne_bf16
    return SimpleNamespace(
        pool_fwd=triton.jit(_act_pool_fwd_kernel),
        pool_bwd=triton.jit(_act_pool_bwd_kernel),
        pool_gather=triton.jit(_act_pool_gather_kernel),
    )


def launch_pool_fwd(y, out, arg, slope: float) -> None:
    """``act_pool_fwd`` on a validated contiguous f32 or bf16 CUDA ``y`` (T,
    N, H, W, C) into ``out`` of its dtype and the uint8 ``arg`` (T, N,
    H//2, W//2, C)."""
    T, N, H, W, C = y.shape
    Ho, Wo = H // 2, W // 2
    P = T * N * Ho * Wo
    bp, bc = tile(C)
    _jit().pool_fwd[(cdiv(P, bp),)](y, out, arg, P, Ho * Wo, Wo, H, W, C,
                                    slope, BLOCK_P=bp, BLOCK_C=bc,
                                    BF16=bn_act_pool.is_bf16(y))


def launch_pool_bwd(dpooled, arg, y, dy, slope: float) -> None:
    """``act_pool_bwd``: ``dy`` (the shape of y) from the pooled gradient
    and the argmax."""
    T, N, H, W, C = y.shape
    NP = T * N * H * W
    bp, bc = tile(C)
    _jit().pool_bwd[(cdiv(NP, bp),)](dpooled, arg, y, dy, NP, H * W, W,
                                     H // 2, W // 2, C, slope, BLOCK_P=bp,
                                     BLOCK_C=bc)


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
