"""Triton kernels K2 and K3: batch-norm normalize + affine + leaky-ReLU +
2x2 max pool, and its backward.

Replace (JAX package) ``howtotrainyourmamlpytorch_tpu/ops/functional.py``:
the normalize/affine tail of ``batch_norm`` :368 inside ``conv_bn_act``
:249, ``leaky_relu`` and ``max_pool2d`` :325 (VALID; a trailing odd row or
column is dropped), and the gradient XLA derives for them.

Bound on an H100: bytes. Both are elementwise passes with a 2x2 window and
per-channel broadcasts — a handful of FLOPs per element, no reduction
across blocks in the forward, no tensor-core work — so the least time is
the bytes over 3.35 TB/s. The design reads y once and writes only the
pooled quarter plus a one-byte window argmax (K2); the backward reads the
pooled gradient, the argmax and y, and writes dy once (K3b), after a
reduction pass (K3a) over the POOLED positions only (every other position
has dz = 0). Triton's masked block loads handle the ragged 21 -> 10 edge.

K3a writes per-(tenant, split) partial sums, which K3b adds in a fixed
order: deterministic, no atomics.

``triton`` is imported at the first launch, never at import: the kernel
bodies below are plain functions until ``_jit()`` compiles them, and they
resolve ``tl`` in this module's namespace, which ``_jit()`` binds.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

tl = None  # bound to ``triton.language`` by ``_jit()`` at the first launch

BLOCK_P = 64   # pixels per program
BLOCK_C = 64   # channels per program (power of two >= C; C = 48 here)
SPLITS = 32    # K3a programs per tenant


def _bn_act_pool_fwd_kernel(y_ptr, mean_ptr, rstd_ptr, gamma_ptr, beta_ptr,
                            out_ptr, arg_ptr, P, NHoWo, HoWo, Wo, H, W, C,
                            slope, BLOCK_P: "tl.constexpr",
                            BLOCK_C: "tl.constexpr"):
    p = tl.program_id(0).to(tl.int64) * BLOCK_P + tl.arange(0, BLOCK_P)
    c = tl.arange(0, BLOCK_C)
    mask = (p < P)[:, None] & (c < C)[None, :]
    t = p // NHoWo
    img = p // HoWo
    r = p % HoWo
    ho = r // Wo
    wo = r % Wo
    tc = t[:, None] * C + c[None, :]
    mu = tl.load(mean_ptr + tc, mask=mask, other=0.0)
    rs = tl.load(rstd_ptr + tc, mask=mask, other=0.0)
    g = tl.load(gamma_ptr + tc, mask=mask, other=0.0)
    b = tl.load(beta_ptr + tc, mask=mask, other=0.0)
    base = ((img * H + 2 * ho) * W + 2 * wo) * C
    best = tl.full([BLOCK_P, BLOCK_C], float("-inf"), tl.float32)
    arg = tl.zeros([BLOCK_P, BLOCK_C], dtype=tl.int32)
    for k in tl.static_range(4):
        off = base + ((k // 2) * W + (k % 2)) * C
        v = tl.load(y_ptr + off[:, None] + c[None, :], mask=mask, other=0.0)
        z = (v - mu) * rs * g + b
        a = tl.where(z >= 0, z, z * slope)
        upd = a > best
        best = tl.where(upd, a, best)
        arg = tl.where(upd, k, arg)
    out = p[:, None] * C + c[None, :]
    tl.store(out_ptr + out, best, mask=mask)
    tl.store(arg_ptr + out, arg.to(tl.uint8), mask=mask)


def _bn_act_pool_bwd_reduce_kernel(dp_ptr, arg_ptr, y_ptr, mean_ptr,
                                   rstd_ptr, gamma_ptr, beta_ptr, part_ptr,
                                   PT, HoWo, Wo, H, W, C, S, CHUNK, slope,
                                   BLOCK_P: "tl.constexpr",
                                   BLOCK_C: "tl.constexpr"):
    t = tl.program_id(0)
    s = tl.program_id(1)
    c = tl.arange(0, BLOCK_C)
    cmask = c < C
    mu = tl.load(mean_ptr + t * C + c, mask=cmask, other=0.0)[None, :]
    rs = tl.load(rstd_ptr + t * C + c, mask=cmask, other=0.0)[None, :]
    g = tl.load(gamma_ptr + t * C + c, mask=cmask, other=0.0)[None, :]
    b = tl.load(beta_ptr + t * C + c, mask=cmask, other=0.0)[None, :]
    acc_dz = tl.zeros([BLOCK_P, BLOCK_C], tl.float32)
    acc_dzx = tl.zeros([BLOCK_P, BLOCK_C], tl.float32)
    start = s * CHUNK
    end = tl.minimum(start + CHUNK, PT)
    for i in range(start, end, BLOCK_P):
        q = i + tl.arange(0, BLOCK_P)
        mask = (q < end)[:, None] & cmask[None, :]
        p = t.to(tl.int64) * PT + q
        img = p // HoWo
        r = p % HoWo
        ho = r // Wo
        wo = r % Wo
        poff = p[:, None] * C + c[None, :]
        k = tl.load(arg_ptr + poff, mask=mask, other=0).to(tl.int32)
        yoff = ((img[:, None] * H + 2 * ho[:, None] + k // 2) * W
                + 2 * wo[:, None] + k % 2) * C + c[None, :]
        v = tl.load(y_ptr + yoff, mask=mask, other=0.0)
        xh = (v - mu) * rs
        z = xh * g + b
        d = tl.load(dp_ptr + poff, mask=mask, other=0.0)
        dz = tl.where(z >= 0, d, d * slope)
        dz = tl.where(mask, dz, 0.0)
        acc_dz += dz
        acc_dzx += dz * xh
    base = (t * S + s) * 2 * C
    tl.store(part_ptr + base + c, tl.sum(acc_dz, axis=0), mask=cmask)
    tl.store(part_ptr + base + C + c, tl.sum(acc_dzx, axis=0), mask=cmask)


def _bn_act_pool_bwd_dy_kernel(dp_ptr, arg_ptr, y_ptr, mean_ptr, rstd_ptr,
                               gamma_ptr, beta_ptr, part_ptr, dy_ptr, NHW,
                               HW, Ho, Wo, W, C, S, inv_m, slope,
                               BLOCK_P: "tl.constexpr",
                               BLOCK_C: "tl.constexpr"):
    t = tl.program_id(1)
    q = tl.program_id(0) * BLOCK_P + tl.arange(0, BLOCK_P)
    c = tl.arange(0, BLOCK_C)
    cmask = c < C
    mask = (q < NHW)[:, None] & cmask[None, :]
    sum_dz = tl.zeros([BLOCK_C], tl.float32)
    sum_dzx = tl.zeros([BLOCK_C], tl.float32)
    for s in range(S):
        base = (t * S + s) * 2 * C
        sum_dz += tl.load(part_ptr + base + c, mask=cmask, other=0.0)
        sum_dzx += tl.load(part_ptr + base + C + c, mask=cmask, other=0.0)
    mu = tl.load(mean_ptr + t * C + c, mask=cmask, other=0.0)
    rs = tl.load(rstd_ptr + t * C + c, mask=cmask, other=0.0)
    g = tl.load(gamma_ptr + t * C + c, mask=cmask, other=0.0)
    b = tl.load(beta_ptr + t * C + c, mask=cmask, other=0.0)
    pos = t.to(tl.int64) * NHW + q
    img = pos // HW
    r = q % HW
    h = r // W
    w = r % W
    ho = h // 2
    wo = w // 2
    in_window = (ho < Ho) & (wo < Wo)
    pidx = (img * Ho + ho) * Wo + wo
    pmask = mask & in_window[:, None]
    poff = pidx[:, None] * C + c[None, :]
    k = tl.load(arg_ptr + poff, mask=pmask, other=255).to(tl.int32)
    sel = pmask & (k == ((h % 2) * 2 + (w % 2))[:, None])
    d = tl.load(dp_ptr + poff, mask=sel, other=0.0)
    yoff = pos[:, None] * C + c[None, :]
    v = tl.load(y_ptr + yoff, mask=mask, other=0.0)
    xh = (v - mu[None, :]) * rs[None, :]
    z = xh * g[None, :] + b[None, :]
    dz = tl.where(z >= 0, d, d * slope)
    dy = (g * rs)[None, :] * (dz - (sum_dz * inv_m)[None, :]
                              - xh * (sum_dzx * inv_m)[None, :])
    tl.store(dy_ptr + yoff, dy, mask=mask)


@functools.lru_cache(maxsize=None)
def _jit() -> SimpleNamespace:
    import triton
    import triton.language

    global tl
    tl = triton.language
    return SimpleNamespace(
        fwd=triton.jit(_bn_act_pool_fwd_kernel),
        bwd_reduce=triton.jit(_bn_act_pool_bwd_reduce_kernel),
        bwd_dy=triton.jit(_bn_act_pool_bwd_dy_kernel),
    )


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_fwd(y, mean, rstd, gamma, beta, out, arg, slope: float) -> None:
    """K2 on validated contiguous f32 CUDA tensors (see
    ``conv_block.bn_act_pool_fwd``)."""
    T, N, H, W, C = y.shape
    Ho, Wo = H // 2, W // 2
    P = T * N * Ho * Wo
    if C > BLOCK_C:
        raise NotImplementedError(
            f"bn_act_pool_fwd takes at most {BLOCK_C} channels, got {C}"
        )
    _jit().fwd[(_cdiv(P, BLOCK_P),)](
        y, mean, rstd, gamma, beta, out, arg, P, N * Ho * Wo, Ho * Wo, Wo,
        H, W, C, slope, BLOCK_P=BLOCK_P, BLOCK_C=BLOCK_C,
    )


def launch_bwd(dpooled, arg, y, mean, rstd, gamma, beta, part, dy,
               slope: float) -> None:
    """K3a then K3b on validated contiguous f32 CUDA tensors; ``part`` is
    ``(T, SPLITS, 2, C)`` scratch that K3a fills with the partial
    ``sum(dz)`` and ``sum(dz * xhat)`` (see ``conv_block.bn_act_pool_bwd``)."""
    T, N, H, W, C = y.shape
    Ho, Wo = H // 2, W // 2
    PT = N * Ho * Wo
    if C > BLOCK_C:
        raise NotImplementedError(
            f"bn_act_pool_bwd takes at most {BLOCK_C} channels, got {C}"
        )
    chunk = _cdiv(_cdiv(PT, SPLITS), BLOCK_P) * BLOCK_P
    kern = _jit()
    kern.bwd_reduce[(T, SPLITS)](
        dpooled, arg, y, mean, rstd, gamma, beta, part, PT, Ho * Wo, Wo, H,
        W, C, SPLITS, chunk, slope, BLOCK_P=BLOCK_P, BLOCK_C=BLOCK_C,
    )
    NHW = N * H * W
    kern.bwd_dy[(_cdiv(NHW, BLOCK_P), T)](
        dpooled, arg, y, mean, rstd, gamma, beta, part, dy, NHW, H * W, Ho,
        Wo, W, C, SPLITS, 1.0 / NHW, slope, BLOCK_P=BLOCK_P, BLOCK_C=BLOCK_C,
    )
