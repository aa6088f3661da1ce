"""The Triton kernels of the layer norm (B5c): the backward of the layer
norm's backward. Its statistics (``layer_norm_stats``), its normalize +
affine (``layer_norm_fwd``) and its backward (``layer_norm_bwd``) run the
CUDA kernels of ``csrc/layer_norm.cu``, one launch a call (their wrappers
and plans are in ``conv_block.py``).

Replace (JAX package) ``howtotrainyourmamlpytorch_tpu/ops/functional.py::
layer_norm`` :447 as ``models/vgg.py`` :250-262 calls it (on the conv
output, or on the block input in the norm-first block), and the second
derivative XLA derives for it. An image of ``(T, N, H, W, C)`` is one ROW
of M = H*W*C values; the statistics are per row, gamma and beta
elementwise per (tenant, h, w, c): ``(T, H, W, C)`` (the block expands a
shared ``(H, W, C)`` leaf).

``layer_norm_bwd_bwd``: the gradient of ``layer_norm_bwd`` with respect to
dz, x and gamma, given the cotangents ``a`` of dx, ``ggamma`` of dgamma
and ``gbeta`` of dbeta (formulas in
``ops/functional.py::layer_norm_bwd_bwd``). ``g_x`` needs the row means of
``G = -r (a mean(g xhat) + g mean(a xhat)) + ggamma dz`` and of ``G
xhat``; they follow from seven row sums, ``sum a``, ``a xhat``, ``g``, ``g
xhat``, ``a g``, ``ggamma dz`` and ``ggamma dz xhat``. Three launches: (a)
``(J, T)`` programs write the seven partials of each (row, tile); (b) the
partials added in tile order (``_row_sums_kernel``); (c) ``(J, T)``
programs loop over the rows of their column tile, write ``g_dz`` and
``g_x`` and add ``dz * r * P(a)`` into ``g_gamma``.

Bound on an H100: bytes. About 40 FLOPs an element, far under the 67
TFLOP/s FFMA peak's 20 per byte; no matrix product. The double backward
reads its inputs twice (the reduction, then the outputs), with the
column sums taken in the same pass as the row partials; no atomics, every
sum in a fixed order, so a run is deterministic. Tiles are 1-D and
contiguous (a row is M consecutive floats), ``min(tile cap,
next_pow2(M))`` wide, so the small maps of the strided model (M = 256 at
2x2x64) keep their lanes.

bf16 (``compute_dtype='bfloat16'``): the kernels load bf16 and convert
each load to f32 before any arithmetic, and each output is rounded once
where the JAX package's bf16 ``layer_norm`` (:447-464) derivatives round,
as the twin in ``ops/functional.py`` does: ``xhat = (x - mean) * rstd`` in
f32 from the bf16 mean and rstd (not the forward's rounded chain), every
partial and sum in f32 scratch, and g_dz, g_x, g_gamma each rounded once
by the store.

Bound: bytes, as in f32, at 2 bytes an element of the activations and
the parameters.

``triton`` is imported at the first launch, never at import (see
``bn_act_pool.py``).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

tl = None  # bound to ``triton.language`` by ``_jit()`` at the first launch

TILE = 1024                 # values per column tile (cap)
ROWS_PER_MERGE = 128        # rows per program of the partial-sum merge
BWD_BWD_SUMS = 7            # row sums of the double backward


def _row_sums_kernel(part_ptr, out_ptr, R, J, K: "tl.constexpr",
                     BLOCK_R: "tl.constexpr"):
    r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    rmask = r < R
    for k in tl.static_range(K):
        acc = tl.zeros([BLOCK_R], tl.float32)
        for j in range(0, J):
            acc += tl.load(part_ptr + (j * K + k) * R + r, mask=rmask,
                           other=0.0)
        tl.store(out_ptr + k * R + r, acc, mask=rmask)


def _bwd_bwd_reduce_kernel(a_ptr, gg_ptr, dz_ptr, x_ptr, mean_ptr, rstd_ptr,
                           gamma_ptr, part_ptr, M, N, R,
                           BLOCK: "tl.constexpr"):
    j = tl.program_id(0)
    t = tl.program_id(1)
    q = j * BLOCK + tl.arange(0, BLOCK)
    mask = q < M
    toff = t.to(tl.int64) * M + q
    g = tl.load(gamma_ptr + toff, mask=mask, other=0.0).to(tl.float32)
    gg = tl.load(gg_ptr + toff, mask=mask, other=0.0).to(tl.float32)
    for n in range(0, N):
        r = t * N + n
        mu = tl.load(mean_ptr + r).to(tl.float32)
        rs = tl.load(rstd_ptr + r).to(tl.float32)
        off = r.to(tl.int64) * M + q
        a = tl.load(a_ptr + off, mask=mask, other=0.0).to(tl.float32)
        d = tl.load(dz_ptr + off, mask=mask, other=0.0).to(tl.float32)
        v = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
        xh = (v - mu) * rs
        gh = d * g
        ggd = gg * d
        # partials (J, 7, R); masked lanes hold a = d = 0
        pbase = j * 7 * R + r
        tl.store(part_ptr + pbase, tl.sum(a, axis=0))
        tl.store(part_ptr + pbase + R, tl.sum(a * xh, axis=0))
        tl.store(part_ptr + pbase + 2 * R, tl.sum(gh, axis=0))
        tl.store(part_ptr + pbase + 3 * R, tl.sum(gh * xh, axis=0))
        tl.store(part_ptr + pbase + 4 * R, tl.sum(a * gh, axis=0))
        tl.store(part_ptr + pbase + 5 * R, tl.sum(ggd, axis=0))
        tl.store(part_ptr + pbase + 6 * R, tl.sum(ggd * xh, axis=0))


def _bwd_bwd_out_kernel(a_ptr, gg_ptr, gb_ptr, dz_ptr, x_ptr, mean_ptr,
                        rstd_ptr, gamma_ptr, sums_ptr, g_dz_ptr, g_x_ptr,
                        g_gamma_ptr, M, N, R, inv_m, BLOCK: "tl.constexpr"):
    j = tl.program_id(0)
    t = tl.program_id(1)
    q = j * BLOCK + tl.arange(0, BLOCK)
    mask = q < M
    toff = t.to(tl.int64) * M + q
    g = tl.load(gamma_ptr + toff, mask=mask, other=0.0).to(tl.float32)
    gg = tl.load(gg_ptr + toff, mask=mask, other=0.0).to(tl.float32)
    gb = tl.load(gb_ptr + toff, mask=mask, other=0.0).to(tl.float32)
    acc = tl.zeros([BLOCK], tl.float32)
    for n in range(0, N):
        r = t * N + n
        mu = tl.load(mean_ptr + r).to(tl.float32)
        rs = tl.load(rstd_ptr + r).to(tl.float32)
        m_a = tl.load(sums_ptr + r) * inv_m
        m_ax = tl.load(sums_ptr + R + r) * inv_m
        m_g = tl.load(sums_ptr + 2 * R + r) * inv_m
        m_gx = tl.load(sums_ptr + 3 * R + r) * inv_m
        m_ag = tl.load(sums_ptr + 4 * R + r) * inv_m
        m_ggd = tl.load(sums_ptr + 5 * R + r) * inv_m
        m_ggdx = tl.load(sums_ptr + 6 * R + r) * inv_m
        off = r.to(tl.int64) * M + q
        a = tl.load(a_ptr + off, mask=mask, other=0.0).to(tl.float32)
        d = tl.load(dz_ptr + off, mask=mask, other=0.0).to(tl.float32)
        v = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
        xh = (v - mu) * rs
        p_a = a - m_a - xh * m_ax
        g_dz = g * rs * p_a + gg * xh + gb
        tl.store(g_dz_ptr + off, g_dz.to(g_dz_ptr.dtype.element_ty),
                 mask=mask)
        acc += d * rs * p_a
        big_g = -rs * (a * m_gx + d * g * m_ax) + gg * d
        mean_g = -rs * (m_a * m_gx + m_g * m_ax) + m_ggd
        mean_gx = -2.0 * rs * m_ax * m_gx + m_ggdx
        cross = m_ag - m_a * m_g - m_ax * m_gx
        g_x = rs * (big_g - mean_g - xh * mean_gx) - xh * rs * rs * cross
        tl.store(g_x_ptr + off, g_x.to(g_x_ptr.dtype.element_ty), mask=mask)
    tl.store(g_gamma_ptr + toff, acc.to(g_gamma_ptr.dtype.element_ty),
             mask=mask)


@functools.lru_cache(maxsize=None)
def _jit() -> SimpleNamespace:
    import triton
    import triton.language

    global tl
    tl = triton.language
    return SimpleNamespace(
        row_sums=triton.jit(_row_sums_kernel),
        bwd_bwd_reduce=triton.jit(_bwd_bwd_reduce_kernel),
        bwd_bwd_out=triton.jit(_bwd_bwd_out_kernel),
    )


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def tile(M: int, cap: int = TILE) -> int:
    """The 1-D tile over a row of M values: the power of two at or above
    M, at most ``cap`` (at least 16)."""
    return max(16, min(cap, pow2_at_least(M)))


def column_tiles(M: int) -> int:
    """J, the column tiles of a row (``tile(M)`` values each) of the
    double backward; its partials are ``(J, 7, R)``."""
    return cdiv(M, tile(M))


def launch_bwd_bwd(a, ggamma, gbeta, dz, x, mean, rstd, gamma, part, sums,
                   g_dz, g_x, g_gamma) -> None:
    """The three launches of ``layer_norm_bwd_bwd``: ``part`` is ``(J, 7,
    T*N)`` and ``sums`` ``(7, T*N)`` f32 scratch; every other tensor f32,
    or every other bf16."""
    T, N, H, W, C = x.shape
    M, R = H * W * C, T * N
    block, J = tile(M), column_tiles(M)
    kern = _jit()
    kern.bwd_bwd_reduce[(J, T)](a, ggamma, dz, x, mean, rstd, gamma, part,
                                M, N, R, BLOCK=block)
    kern.row_sums[(cdiv(R, ROWS_PER_MERGE),)](part, sums, R, J,
                                              K=BWD_BWD_SUMS,
                                              BLOCK_R=ROWS_PER_MERGE)
    kern.bwd_bwd_out[(J, T)](a, ggamma, gbeta, dz, x, mean, rstd, gamma,
                             sums, g_dz, g_x, g_gamma, M, N, R, 1.0 / M,
                             BLOCK=block)
