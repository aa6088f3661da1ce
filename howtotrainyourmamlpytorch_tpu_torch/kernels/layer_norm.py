"""Triton kernels of the layer norm (B5c): per-image statistics, the
normalize + affine, its backward and the backward of that backward.

Replace (JAX package) ``howtotrainyourmamlpytorch_tpu/ops/functional.py::
layer_norm`` :447 as ``models/vgg.py`` :250-262 calls it (on the conv
output, or on the block input in the norm-first block), and the first and
second derivatives XLA derives for it. An image of ``(T, N, H, W, C)`` is
one ROW of M = H*W*C values; the statistics are per row, gamma and beta
elementwise per (tenant, h, w, c): ``(T, H, W, C)`` (the block expands a
shared ``(H, W, C)`` leaf).

* ``layer_norm_stats``: each row's mean, population variance and
  ``rstd = 1 / sqrt(var + eps)``. Two launches: ``(S, T*N)`` programs,
  program (s, r) walking its chunk of row r in 1-D tiles, each tile's own
  mean and sum of squared deviations folded into a running (count, mean,
  M2) with Chan's merge, one partial per (row, split); then the merge of
  ``bn_stats.py`` (the same kernel, with the N rows of a tenant as its
  "channels") adds the S partials of each row in split order, again with
  Chan's merge. ``E[x^2] - E[x]^2`` is never formed.
* ``layer_norm_fwd``: ``z = (x - mean) * rstd * gamma + beta``, one
  elementwise pass, ``(J, T*N)`` programs of one tile each.
* ``layer_norm_bwd``: with ``g = dz * gamma`` and ``xhat = (x - mean) *
  rstd``, ``dx = rstd * (g - mean(g) - xhat * mean(g * xhat))`` per row,
  ``dgamma = sum_n dz * xhat`` and ``dbeta = sum_n dz`` per (tenant,
  column). Three launches: (a) ``(J, T)`` programs, program (j, t) owns
  column tile j of tenant t and loops over the N rows: it adds each row
  into the column sums (coalesced, no atomics) and writes the row's two
  partial sums over its tile; (b) the partials of each row added over the
  J tiles in tile order; (c) dx, elementwise.
* ``layer_norm_bwd_bwd``: the gradient of ``layer_norm_bwd`` with respect
  to dz, x and gamma, given the cotangents ``a`` of dx, ``ggamma`` of
  dgamma and ``gbeta`` of dbeta (formulas in
  ``ops/functional.py::layer_norm_bwd_bwd``). ``g_x`` needs the row means
  of ``G = -r (a mean(g xhat) + g mean(a xhat)) + ggamma dz`` and of ``G
  xhat``; they follow from seven row sums, ``sum a``, ``a xhat``, ``g``,
  ``g xhat``, ``a g``, ``ggamma dz`` and ``ggamma dz xhat``. Three
  launches: (a) ``(J, T)`` programs write the seven partials of each (row,
  tile); (b) the partials added in tile order; (c) ``(J, T)`` programs loop
  over the rows of their column tile, write ``g_dz`` and ``g_x`` and add
  ``dz * r * P(a)`` into ``g_gamma``.

Bound on an H100: bytes. A handful of FLOPs per element (the double
backward's ~40 is far under the 67 TFLOP/s FFMA peak's 20 per byte), no
matrix product. At the conv-first model's stage 0 (M = 338,688) with T =
8, N = 75 the statistics read 812.9 MB (0.24 ms at 3.35 TB/s) and the
forward moves 1.63 GB (0.49 ms). The design reads each input the fewest
times its reductions allow: the statistics once; the backward twice (the
reduction, then dx) and the double backward twice, with the column sums
taken in the same pass as the row partials; no atomics, every sum in a
fixed order, so a run is deterministic. Tiles are 1-D and contiguous
(a row is M consecutive floats), ``min(tile cap, next_pow2(M))`` wide,
so the small maps of the strided model (M = 256 at 2x2x64) keep their
lanes.

bf16 (``compute_dtype='bfloat16'``): every kernel loads bf16 and
converts each load to f32 before any arithmetic; partials, row sums and
column sums are f32 scratch, as in f32, and each output is rounded once
where the JAX package's bf16 ``layer_norm`` (:447-464) and its
derivatives round, as the twins in ``ops/functional.py`` do:

* ``layer_norm_stats``: the f32 Chan partials of the bf16 loads, merged by
  ``bn_stats.py``'s merge with its ``BF16`` constexpr: mean and var each
  rounded once (``jnp.mean`` / ``jnp.var``), ``rstd`` the f32 rsqrt of
  ``bf16(var + bf16(eps))``, rounded once (``lax.rsqrt`` in bf16). The
  merge sums in another order than the twin's two passes, so a value at a
  rounding boundary may land one bf16 ulp away;
* ``layer_norm_fwd`` takes a ``BF16`` constexpr (the f32 instantiation is
  unchanged): the chain ``(x - mean)``, ``* rstd``, ``* gamma``, ``+
  beta``, each op rounded to bf16 (``bn_act_pool._bf16_chain`` at slope
  1, whose activation is the identity), so it equals its twin bit for
  bit;
* ``layer_norm_bwd`` and ``layer_norm_bwd_bwd``: ``xhat = (x - mean) *
  rstd`` in f32 from the bf16 mean and rstd (not the forward's rounded
  chain), every partial and sum in f32, and dx, dgamma, dbeta (g_dz, g_x,
  g_gamma) each rounded once by the store.

Bound: bytes, as in f32, at 2 bytes an element of the activations,
gamma and beta.

``triton`` is imported at the first launch, never at import (see
``bn_act_pool.py``).
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

from . import bn_act_pool, bn_stats
from .bn_stats import cdiv

tl = None  # bound to ``triton.language`` by ``_jit()`` at the first launch
_bf16_chain = None  # bound to ``bn_act_pool``'s jitted chain by ``_jit()``

STATS_TILE = bn_stats.TILE  # values per statistics tile (cap)
TILE = 1024                 # values per column tile (cap)
ROWS_PER_MERGE = 128        # rows per program of the partial-sum merge
BWD_SUMS = 2                # row sums of the backward
BWD_BWD_SUMS = 7            # row sums of the double backward


def _stats_partial_kernel(x_ptr, part_ptr, M, N, S, CHUNK,
                          BLOCK: "tl.constexpr"):
    s = tl.program_id(0)
    r = tl.program_id(1)
    t = r // N
    n = r % N
    zero = tl.sum(tl.zeros([BLOCK], tl.float32), axis=0)
    cnt = zero
    mean = zero
    m2 = zero
    start = s * CHUNK
    end = tl.minimum(start + CHUNK, M)
    row = r.to(tl.int64) * M
    for i in range(start, end, BLOCK):
        q = i + tl.arange(0, BLOCK)
        mask = q < end
        v = tl.load(x_ptr + row + q, mask=mask, other=0.0).to(tl.float32)
        nb = tl.minimum(end - i, BLOCK).to(tl.float32)
        mb = tl.sum(v, axis=0) / nb
        d = tl.where(mask, v - mb, 0.0)
        m2b = tl.sum(d * d, axis=0)
        tot = cnt + nb
        delta = mb - mean
        mean += delta * (nb / tot)
        m2 += m2b + delta * delta * (cnt * nb / tot)
        cnt = tot
    # bn_stats' merge layout (T, S, 3, C) with the N rows as channels
    base = (t * S + s) * 3 * N + n
    tl.store(part_ptr + base, cnt)
    tl.store(part_ptr + base + N, mean)
    tl.store(part_ptr + base + 2 * N, m2)


def _fwd_kernel(x_ptr, mean_ptr, rstd_ptr, gamma_ptr, beta_ptr, z_ptr, M, N,
                BLOCK: "tl.constexpr", BF16: "tl.constexpr"):
    j = tl.program_id(0)
    r = tl.program_id(1)
    t = r // N
    q = j * BLOCK + tl.arange(0, BLOCK)
    mask = q < M
    mu = tl.load(mean_ptr + r).to(tl.float32)
    rs = tl.load(rstd_ptr + r).to(tl.float32)
    off = r.to(tl.int64) * M + q
    toff = t.to(tl.int64) * M + q
    v = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
    g = tl.load(gamma_ptr + toff, mask=mask, other=0.0).to(tl.float32)
    b = tl.load(beta_ptr + toff, mask=mask, other=0.0).to(tl.float32)
    if BF16:
        # every op rounded to bf16: the chain at slope 1
        z, _ = _bf16_chain(v, mu, rs, g, b, 1.0)
    else:
        z = (v - mu) * rs * g + b
    tl.store(z_ptr + off, z.to(z_ptr.dtype.element_ty), mask=mask)


def _bwd_reduce_kernel(dz_ptr, x_ptr, mean_ptr, rstd_ptr, gamma_ptr,
                       part_ptr, dgamma_ptr, dbeta_ptr, M, N, R,
                       BLOCK: "tl.constexpr"):
    j = tl.program_id(0)
    t = tl.program_id(1)
    q = j * BLOCK + tl.arange(0, BLOCK)
    mask = q < M
    toff = t.to(tl.int64) * M + q
    g = tl.load(gamma_ptr + toff, mask=mask, other=0.0).to(tl.float32)
    acc_b = tl.zeros([BLOCK], tl.float32)
    acc_g = tl.zeros([BLOCK], tl.float32)
    for n in range(0, N):
        r = t * N + n
        mu = tl.load(mean_ptr + r).to(tl.float32)
        rs = tl.load(rstd_ptr + r).to(tl.float32)
        off = r.to(tl.int64) * M + q
        d = tl.load(dz_ptr + off, mask=mask, other=0.0).to(tl.float32)
        v = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
        xh = (v - mu) * rs
        gh = d * g
        acc_b += d
        acc_g += d * xh
        # partials (J, 2, R); masked lanes hold d = g = 0
        pbase = j * 2 * R + r
        tl.store(part_ptr + pbase, tl.sum(gh, axis=0))
        tl.store(part_ptr + pbase + R, tl.sum(gh * xh, axis=0))
    tl.store(dbeta_ptr + toff, acc_b.to(dbeta_ptr.dtype.element_ty),
             mask=mask)
    tl.store(dgamma_ptr + toff, acc_g.to(dgamma_ptr.dtype.element_ty),
             mask=mask)


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


def _bwd_dx_kernel(dz_ptr, x_ptr, mean_ptr, rstd_ptr, gamma_ptr, sums_ptr,
                   dx_ptr, M, N, R, inv_m, BLOCK: "tl.constexpr"):
    j = tl.program_id(0)
    r = tl.program_id(1)
    t = r // N
    q = j * BLOCK + tl.arange(0, BLOCK)
    mask = q < M
    mu = tl.load(mean_ptr + r).to(tl.float32)
    rs = tl.load(rstd_ptr + r).to(tl.float32)
    m_g = tl.load(sums_ptr + r) * inv_m
    m_gx = tl.load(sums_ptr + R + r) * inv_m
    off = r.to(tl.int64) * M + q
    toff = t.to(tl.int64) * M + q
    d = tl.load(dz_ptr + off, mask=mask, other=0.0).to(tl.float32)
    v = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
    g = tl.load(gamma_ptr + toff, mask=mask, other=0.0).to(tl.float32)
    xh = (v - mu) * rs
    dx = rs * (d * g - m_g - xh * m_gx)
    tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=mask)


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

    global tl, _bf16_chain
    tl = triton.language
    # the forward calls bn_act_pool's jitted chain by this global name
    bn_act_pool._jit()
    _bf16_chain = bn_act_pool._bf16_chain
    return SimpleNamespace(
        stats_partial=triton.jit(_stats_partial_kernel),
        fwd=triton.jit(_fwd_kernel),
        bwd_reduce=triton.jit(_bwd_reduce_kernel),
        row_sums=triton.jit(_row_sums_kernel),
        bwd_dx=triton.jit(_bwd_dx_kernel),
        bwd_bwd_reduce=triton.jit(_bwd_bwd_reduce_kernel),
        bwd_bwd_out=triton.jit(_bwd_bwd_out_kernel),
    )


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def tile(M: int, cap: int = TILE) -> int:
    """The 1-D tile over a row of M values: the power of two at or above
    M, at most ``cap`` (at least 16)."""
    return max(16, min(cap, _pow2_at_least(M)))


def stats_plan(R: int, M: int) -> SimpleNamespace:
    """The statistics' tiling of R rows of M values: the tile ``block``,
    the partial programs per row ``splits`` (about
    ``bn_stats.TARGET_PROGRAMS`` over all rows, at most one per tile) and
    the values of each, ``chunk`` (whole tiles)."""
    block = tile(M, STATS_TILE)
    splits = max(1, min(cdiv(M, block), cdiv(bn_stats.TARGET_PROGRAMS, R)))
    return SimpleNamespace(block=block, splits=splits,
                           chunk=cdiv(cdiv(M, splits), block) * block)


def column_tiles(M: int) -> int:
    """J, the column tiles of a row (``tile(M)`` values each) of the
    backward and double backward; their partials are ``(J, sums, R)``."""
    return cdiv(M, tile(M))


def launch_stats(x, part, mean, var, rstd, eps: float) -> None:
    """Both launches on a validated contiguous f32 or bf16 CUDA ``x`` (T,
    N, H, W, C) into the (T, N) ``mean``, ``var`` and ``rstd`` of its
    dtype; ``part`` is ``(T, stats_plan(...).splits, 3, N)`` f32 scratch
    (see ``conv_block.layer_norm_stats``)."""
    T, N, H, W, C = x.shape
    M = H * W * C
    p = stats_plan(T * N, M)
    kern = _jit()
    kern.stats_partial[(p.splits, T * N)](x, part, M, N, p.splits, p.chunk,
                                          BLOCK=p.block)
    bn_stats._jit().merge[(T,)](part, mean, var, rstd, N, p.splits, eps,
                                BLOCK_C=bn_stats.tile(N)[1],
                                BF16=bn_act_pool.is_bf16(x))


def launch_fwd(x, mean, rstd, gamma, beta, z) -> None:
    """``z`` (the shape of x) from x, the (T, N) statistics and the (T, H,
    W, C) gamma and beta, all f32 or all bf16."""
    T, N, H, W, C = x.shape
    M = H * W * C
    block = tile(M)
    _jit().fwd[(cdiv(M, block), T * N)](x, mean, rstd, gamma, beta, z, M, N,
                                       BLOCK=block,
                                       BF16=bn_act_pool.is_bf16(x))


def launch_bwd(dz, x, mean, rstd, gamma, part, sums, dx, dgamma,
               dbeta) -> None:
    """The three launches of ``layer_norm_bwd``: ``part`` is ``(J, 2, T*N)``
    and ``sums`` ``(2, T*N)`` f32 scratch (``column_tiles``); every other
    tensor f32, or every other bf16."""
    T, N, H, W, C = x.shape
    M, R = H * W * C, T * N
    block, J = tile(M), column_tiles(M)
    kern = _jit()
    kern.bwd_reduce[(J, T)](dz, x, mean, rstd, gamma, part, dgamma, dbeta,
                            M, N, R, BLOCK=block)
    kern.row_sums[(cdiv(R, ROWS_PER_MERGE),)](part, sums, R, J, K=BWD_SUMS,
                                              BLOCK_R=ROWS_PER_MERGE)
    kern.bwd_dx[(J, R)](dz, x, mean, rstd, gamma, sums, dx, M, N, R,
                        1.0 / M, BLOCK=block)


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
