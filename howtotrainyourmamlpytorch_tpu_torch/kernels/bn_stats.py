"""Triton kernel ``bn_input_stats``: the batch statistics of a block INPUT,
per (tenant, channel): mean, biased variance and ``rstd``.

Replaces (JAX package) the statistics half of
``howtotrainyourmamlpytorch_tpu/ops/functional.py::batch_norm`` :368 where
the norm-first block (``block_order='norm_conv_relu'``, ``models/vgg.py``
:271) calls it on the block input; its normalize, backward and double
backward are K2, K3 and K5 in their pool-free mode at slope 1
(``bn_act_pool.py``), so this is the one kernel the standalone batch norm
adds.

Bound on an H100: bytes. Each element is read once and takes a handful of
FLOPs; the outputs are three (T, C) vectors. The largest input is stage
0's image, (T, N, 84, 84, 3): at T = 8, N = 75 that is 50.8 MB, 0.015 ms
at 3.35 TB/s.

Design. Two launches, no atomics, a fixed order:

1. ``(T, S)`` programs; program (t, s) walks its chunk of tenant t's
   N*H*W pixels in tiles of ``BLOCK_P`` pixels x all channels. Per tile it
   takes the tile's own mean and sum of squared deviations (the tile sits
   in registers, so one read of x), and folds them into its running
   (count, mean, M2) with Chan's merge; it writes one partial per
   channel.
2. ``(T,)`` programs merge the S partials of a tenant in split order, again
   with Chan's merge, and write mean, ``var = M2 / count`` and
   ``rstd = 1 / sqrt(var + eps)``.

Chan's merge never forms ``E[x^2] - E[x]^2``, which cancels on pixels in
[0, 1] with a mean near 0.45.

bf16 (``compute_dtype='bfloat16'``): the partials load bf16 and keep
(count, mean, M2) in f32 as in f32; the merge takes a ``BF16`` constexpr
(the f32 instantiation is unchanged) and rounds where ``jnp.mean`` /
``jnp.var`` and ``lax.rsqrt`` of the JAX package's bf16 ``batch_norm``
(:409-428) do, as K1's ``store_stats`` (``csrc/conv3x3_fwd.cu``): the f32
mean and variance each rounded once to bf16, and ``rstd`` the f32 rsqrt
of ``bf16(bf16(var) + bf16(eps))`` (a correctly rounded sqrt and
division), rounded once. The Chan merge sums in another order than the
twin's two passes, so mean and var may differ from it by one bf16 ulp at a
rounding boundary, and rstd with them.

Channels. A tile is ``(BLOCK_P, BLOCK_C)``, ``BLOCK_C`` the power of two at
or above C (at least 2) and ``BLOCK_P * BLOCK_C = 4096``: at C = 3, 48 and
64 (mini-ImageNet's image and the two filter counts) 3 of every 4 lanes or
more are live, at C = 1 (Omniglot's image) 1 of 2, where a fixed
64-channel tile (K2's) would keep 3 of 64 at mini-ImageNet's stage 0. The loads stay
contiguous (a row of C floats, rows back to back), and the per-channel sum
is a reduction over the tile's pixel axis — no ``offset % C`` scatter.

``triton`` is imported at the first launch, never at import (see
``bn_act_pool.py``).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

from . import bn_act_pool

tl = None  # bound to ``triton.language`` by ``_jit()`` at the first launch
_rne_bf16 = None  # bound to ``bn_act_pool``'s jitted rounding by ``_jit()``

TILE = 4096          # elements per tile: BLOCK_P x BLOCK_C
TARGET_PROGRAMS = 512  # partial programs over all tenants, about


def _stats_partial_kernel(x_ptr, part_ptr, P, C, S, CHUNK,
                          BLOCK_P: "tl.constexpr", BLOCK_C: "tl.constexpr"):
    t = tl.program_id(0)
    s = tl.program_id(1)
    c = tl.arange(0, BLOCK_C)
    cmask = c < C
    n = tl.zeros([BLOCK_C], tl.float32)
    mean = tl.zeros([BLOCK_C], tl.float32)
    m2 = tl.zeros([BLOCK_C], tl.float32)
    start = s * CHUNK
    end = tl.minimum(start + CHUNK, P)
    for i in range(start, end, BLOCK_P):
        q = i + tl.arange(0, BLOCK_P)
        mask = (q < end)[:, None] & cmask[None, :]
        off = (t.to(tl.int64) * P + q)[:, None] * C + c[None, :]
        v = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
        nb = tl.minimum(end - i, BLOCK_P).to(tl.float32)
        mb = tl.sum(v, axis=0) / nb
        d = tl.where(mask, v - mb[None, :], 0.0)
        m2b = tl.sum(d * d, axis=0)
        tot = n + nb
        delta = mb - mean
        mean += delta * (nb / tot)
        m2 += m2b + delta * delta * (n * nb / tot)
        n = tot
    base = (t * S + s) * 3 * C
    tl.store(part_ptr + base + c, n, mask=cmask)
    tl.store(part_ptr + base + C + c, mean, mask=cmask)
    tl.store(part_ptr + base + 2 * C + c, m2, mask=cmask)


def _stats_merge_kernel(part_ptr, mean_ptr, var_ptr, rstd_ptr, C, S, eps,
                        BLOCK_C: "tl.constexpr", BF16: "tl.constexpr"):
    t = tl.program_id(0)
    c = tl.arange(0, BLOCK_C)
    cmask = c < C
    n = tl.zeros([BLOCK_C], tl.float32)
    mean = tl.zeros([BLOCK_C], tl.float32)
    m2 = tl.zeros([BLOCK_C], tl.float32)
    for s in range(S):
        base = (t * S + s) * 3 * C
        nb = tl.load(part_ptr + base + c, mask=cmask, other=0.0)
        mb = tl.load(part_ptr + base + C + c, mask=cmask, other=0.0)
        m2b = tl.load(part_ptr + base + 2 * C + c, mask=cmask, other=0.0)
        tot = n + nb
        # an empty split (count 0) leaves the running values as they are
        w = nb / tl.maximum(tot, 1.0)
        delta = mb - mean
        mean += delta * w
        m2 += m2b + delta * delta * n * w
        n = tot
    var = m2 / tl.maximum(n, 1.0)
    if BF16:
        # var rounded to bf16, plus bf16(eps) rounded again, then the f32
        # rsqrt (a correctly rounded sqrt and division) rounded by the store
        var = _rne_bf16(var)
        rstd = tl.math.div_rn(1.0, tl.sqrt_rn(_rne_bf16(var + eps)))
    else:
        rstd = 1.0 / tl.sqrt(var + eps)
    tl.store(mean_ptr + t * C + c, mean.to(mean_ptr.dtype.element_ty),
             mask=cmask)
    tl.store(var_ptr + t * C + c, var.to(var_ptr.dtype.element_ty),
             mask=cmask)
    tl.store(rstd_ptr + t * C + c, rstd.to(rstd_ptr.dtype.element_ty),
             mask=cmask)


@functools.lru_cache(maxsize=None)
def _jit() -> SimpleNamespace:
    import triton
    import triton.language

    global tl, _rne_bf16
    tl = triton.language
    # the merge calls bn_act_pool's jitted rounding by this global name
    _rne_bf16 = bn_act_pool._jit().rne_bf16
    return SimpleNamespace(
        partial=triton.jit(_stats_partial_kernel),
        merge=triton.jit(_stats_merge_kernel),
    )


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile(C: int) -> tuple:
    """``(block_p, block_c)`` for C channels: ``block_c`` the power of two
    at or above C (at least 2), ``block_p * block_c = TILE``. The act-pool
    kernels (``act_pool.py``) take the same tile."""
    block_c = max(2, 1 << max(0, C - 1).bit_length())
    return max(1, TILE // block_c), block_c


def plan(T: int, P: int, C: int) -> SimpleNamespace:
    """The tiling of ``T`` tenants of ``P`` pixels x ``C`` channels: the
    tile ``(block_p, block_c)``, the partial programs per tenant ``splits``
    (about ``TARGET_PROGRAMS`` over all tenants, at most one per tile) and
    the pixels of each, ``chunk`` (whole tiles)."""
    block_p, block_c = tile(C)
    splits = max(1, min(cdiv(P, block_p), cdiv(TARGET_PROGRAMS, T)))
    return SimpleNamespace(block_p=block_p, block_c=block_c, splits=splits,
                           chunk=cdiv(cdiv(P, splits), block_p) * block_p)


def launch(x, part, mean, var, rstd, eps: float) -> None:
    """Both launches on a validated contiguous f32 or bf16 CUDA ``x`` (T,
    N, H, W, C) into statistics of its dtype; ``part`` is ``(T,
    plan(...).splits, 3, C)`` f32 scratch (see
    ``conv_block.bn_input_stats``)."""
    T, N, H, W, C = x.shape
    P = N * H * W
    p = plan(T, P, C)
    kern = _jit()
    kern.partial[(T, p.splits)](x, part, P, C, p.splits, p.chunk,
                                BLOCK_P=p.block_p, BLOCK_C=p.block_c)
    kern.merge[(T,)](part, mean, var, rstd, C, p.splits, eps,
                     BLOCK_C=p.block_c, BF16=bn_act_pool.is_bf16(x))
