"""Triton kernels K5 pool-free: the backward of K3's pool-free mode (the
backward of batch-norm normalize + affine + leaky-ReLU through the batch
statistics), in both dtypes: the strided model's ``bn_act_bwd_bwd``
(``max_pooling=False``) and, at slope 1, the norm-first block's standalone
``batch_norm_bwd_bwd``. K3 and K5 pooled run the cooperative CUDA kernels
of ``csrc/bn_act_pool_bwd.cu`` in both dtypes (``conv_block.bn_bwd_plan``);
K3's pool-free mode is CUDA in both dtypes (``csrc/bn_act_bwd.cu``,
``conv_block.bn_act_bwd_plan``), as is their forward, K2, in both modes
(``csrc/bn_act_fwd.cu``); all round their masks as ``_bf16_chain`` below
(``csrc/bn_act_chain.cuh``).

Replace (JAX package) ``howtotrainyourmamlpytorch_tpu/ops/functional.py``:
the second derivative XLA derives for the normalize/affine tail of
``batch_norm`` :368 inside ``conv_bn_act`` :249 and ``leaky_relu``, with no
pool (the strided model), when the JAX package differentiates its
inner-loop gradient (second-order MAML, ``core/maml.py::_task_learner``).
Given the cotangents ``a`` of K3's dy and ``ggamma``/``gbeta`` of its
dgamma/dbeta, K5 returns the gradients with respect to K3's inputs da, y
and gamma (beta enters only through the piecewise-constant masks, so its
gradient is 0). With ``P(v) = v - mean(v) - xhat * mean(v * xhat)`` (K3's
projection), per (tenant, channel) over m = N*H*W positions::

    g_dz      = gamma * r * P(a) + ggamma * xhat + gbeta
    g_da      = g_dz, slope-masked
    g_gamma   = r * (S_adz - m * mean(a) * mean(dz) - m * mean(a xhat) * mean(dz xhat))
    G         = -gamma * r * (mean(dz xhat) * a + mean(a xhat) * dz) + ggamma * dz
    g_y       = r * (G - mean(G) - xhat * mean(G xhat)) - r^2 * xhat / m * L_r
    L_r       = gamma * (S_adz - m * mean(a) mean(dz) - m * mean(a xhat) mean(dz xhat))

with ``r = rstd`` and dz the slope-masked da; ``mean(G)`` and ``mean(G
xhat)`` follow from the same five sums, Σa, Σa·xhat, Σdz, Σdz·xhat and
Σa·dz (the pooled K5 takes the same formulas with dz at each window's
argmax and g_dz gathered there). Bound on an H100: bytes (a handful of
FLOPs per element, no tensor-core work) — K5a reads a, da and y once and
writes 5 partial sums per split; K5b reads them again and writes g_da and
g_y densely, plus g_gamma (program 0 of each tenant). Two launches,
partial sums in a fixed order, no atomics: deterministic. The masked
block loads cover the ragged maps (7x7, 4x4 and 2x2 at Omniglot's width).

bf16 (``compute_dtype='bfloat16'``): every kernel here takes a ``BF16``
constexpr (the f32 instantiations are unchanged): the masks from K2's bf16
chain (``_bf16_chain``: bf16 after every op of the JAX package's chain —
``y - mean``, ``* rstd``, ``* gamma``, ``+ beta``, then ``z * slope`` on
the negative side, the slope the bf16 value of 0.01; a mask decided on the
f32 ``xhat * gamma + beta`` would flip wherever the chain rounds across
zero), xhat and the five partial sums in f32, and ``g_da``, ``g_y`` and
``g_gamma`` each rounded once to bf16, as the twin does.

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
SPLITS = 32    # K5a programs per tenant


def _rne_bf16(x):
    """An f32 value rounded to the nearest bf16 (ties to even), kept in
    f32, by integer ops on its bits (finite values only). The chain below
    needs every rounding: written as ``.to(tl.bfloat16).to(tl.float32)``
    round trips, a Triton kernel missed its twin by an ulp at places on the
    card."""
    bits = x.to(tl.int32, bitcast=True)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & -65536
    return bits.to(tl.float32, bitcast=True)


def _bf16_chain(v, mu, rs, g, b, slope):
    """K2's bf16 chain (csrc/bn_act_fwd.cu) on f32 values of bf16 operands:
    ``(z, act)``, each op rounded to bf16 (``_rne_bf16``)."""
    z = _rne_bf16(v - mu)
    z = _rne_bf16(z * rs)
    z = _rne_bf16(z * g)
    z = _rne_bf16(z + b)
    return z, tl.where(z >= 0, z, _rne_bf16(z * slope))


def _bn_act_bwd_bwd_reduce_kernel(a_ptr, da_ptr, y_ptr, mean_ptr, rstd_ptr,
                                  gamma_ptr, beta_ptr, part_ptr, NHW, C, S,
                                  CHUNK, slope, BLOCK_P: "tl.constexpr",
                                  BLOCK_C: "tl.constexpr",
                                  BF16: "tl.constexpr"):
    t = tl.program_id(0)
    s = tl.program_id(1)
    c = tl.arange(0, BLOCK_C)
    cmask = c < C
    mu = tl.load(mean_ptr + t * C + c, mask=cmask,
                 other=0.0).to(tl.float32)[None, :]
    rs = tl.load(rstd_ptr + t * C + c, mask=cmask,
                 other=0.0).to(tl.float32)[None, :]
    g = tl.load(gamma_ptr + t * C + c, mask=cmask,
                other=0.0).to(tl.float32)[None, :]
    b = tl.load(beta_ptr + t * C + c, mask=cmask,
                other=0.0).to(tl.float32)[None, :]
    acc_a = tl.zeros([BLOCK_P, BLOCK_C], tl.float32)
    acc_ax = tl.zeros([BLOCK_P, BLOCK_C], tl.float32)
    acc_dz = tl.zeros([BLOCK_P, BLOCK_C], tl.float32)
    acc_dzx = tl.zeros([BLOCK_P, BLOCK_C], tl.float32)
    acc_adz = tl.zeros([BLOCK_P, BLOCK_C], tl.float32)
    start = s * CHUNK
    end = tl.minimum(start + CHUNK, NHW)
    for i in range(start, end, BLOCK_P):
        q = i + tl.arange(0, BLOCK_P)
        mask = (q < end)[:, None] & cmask[None, :]
        off = (t.to(tl.int64) * NHW + q)[:, None] * C + c[None, :]
        v = tl.load(y_ptr + off, mask=mask, other=0.0).to(tl.float32)
        d = tl.load(da_ptr + off, mask=mask, other=0.0).to(tl.float32)
        av = tl.load(a_ptr + off, mask=mask, other=0.0).to(tl.float32)
        xh = tl.where(mask, (v - mu) * rs, 0.0)
        if BF16:
            z, _ = _bf16_chain(v, mu, rs, g, b, slope)
        else:
            z = xh * g + b
        dz = tl.where(z >= 0, d, d * slope)
        acc_a += av
        acc_ax += av * xh
        acc_dz += dz
        acc_dzx += dz * xh
        acc_adz += av * dz
    base = (t * S + s) * 5 * C
    tl.store(part_ptr + base + c, tl.sum(acc_a, axis=0), mask=cmask)
    tl.store(part_ptr + base + C + c, tl.sum(acc_ax, axis=0), mask=cmask)
    tl.store(part_ptr + base + 2 * C + c, tl.sum(acc_dz, axis=0), mask=cmask)
    tl.store(part_ptr + base + 3 * C + c, tl.sum(acc_dzx, axis=0), mask=cmask)
    tl.store(part_ptr + base + 4 * C + c, tl.sum(acc_adz, axis=0), mask=cmask)


def _bn_act_bwd_bwd_out_kernel(a_ptr, ggamma_ptr, gbeta_ptr, da_ptr, y_ptr,
                               mean_ptr, rstd_ptr, gamma_ptr, beta_ptr,
                               part_ptr, gda_ptr, gy_ptr, ggam_out_ptr, NHW,
                               C, S, inv_m, slope, BLOCK_P: "tl.constexpr",
                               BLOCK_C: "tl.constexpr", BF16: "tl.constexpr"):
    t = tl.program_id(1)
    q = tl.program_id(0) * BLOCK_P + tl.arange(0, BLOCK_P)
    c = tl.arange(0, BLOCK_C)
    cmask = c < C
    mask = (q < NHW)[:, None] & cmask[None, :]
    s_a = tl.zeros([BLOCK_C], tl.float32)
    s_ax = tl.zeros([BLOCK_C], tl.float32)
    s_dz = tl.zeros([BLOCK_C], tl.float32)
    s_dzx = tl.zeros([BLOCK_C], tl.float32)
    s_adz = tl.zeros([BLOCK_C], tl.float32)
    for s in range(S):
        base = (t * S + s) * 5 * C
        s_a += tl.load(part_ptr + base + c, mask=cmask, other=0.0)
        s_ax += tl.load(part_ptr + base + C + c, mask=cmask, other=0.0)
        s_dz += tl.load(part_ptr + base + 2 * C + c, mask=cmask, other=0.0)
        s_dzx += tl.load(part_ptr + base + 3 * C + c, mask=cmask, other=0.0)
        s_adz += tl.load(part_ptr + base + 4 * C + c, mask=cmask, other=0.0)
    mu = tl.load(mean_ptr + t * C + c, mask=cmask, other=0.0).to(tl.float32)
    rs = tl.load(rstd_ptr + t * C + c, mask=cmask, other=0.0).to(tl.float32)
    g = tl.load(gamma_ptr + t * C + c, mask=cmask, other=0.0).to(tl.float32)
    b = tl.load(beta_ptr + t * C + c, mask=cmask, other=0.0).to(tl.float32)
    gg = tl.load(ggamma_ptr + t * C + c, mask=cmask,
                 other=0.0).to(tl.float32)
    gb = tl.load(gbeta_ptr + t * C + c, mask=cmask, other=0.0).to(tl.float32)
    m_a = s_a * inv_m
    m_ax = s_ax * inv_m
    m_dz = s_dz * inv_m
    m_dzx = s_dzx * inv_m
    cross = s_adz - (m_a * s_dz + m_ax * s_dzx)
    grs = g * rs
    mean_g = -grs * (m_dzx * m_a + m_ax * m_dz) + gg * m_dz
    mean_gx = -2.0 * grs * m_ax * m_dzx + gg * m_dzx
    lr_coef = rs * rs * inv_m * g * cross
    if tl.program_id(0) == 0:
        tl.store(ggam_out_ptr + t * C + c,
                 (rs * cross).to(ggam_out_ptr.dtype.element_ty), mask=cmask)

    off = (t.to(tl.int64) * NHW + q)[:, None] * C + c[None, :]
    v = tl.load(y_ptr + off, mask=mask, other=0.0).to(tl.float32)
    d = tl.load(da_ptr + off, mask=mask, other=0.0).to(tl.float32)
    av = tl.load(a_ptr + off, mask=mask, other=0.0).to(tl.float32)
    xh = (v - mu[None, :]) * rs[None, :]
    if BF16:
        z, _ = _bf16_chain(v, mu[None, :], rs[None, :], g[None, :],
                           b[None, :], slope)
    else:
        z = xh * g[None, :] + b[None, :]
    pos_side = z >= 0
    dz = tl.where(pos_side, d, d * slope)
    pa = av - m_a[None, :] - xh * m_ax[None, :]
    gdz = grs[None, :] * pa + gg[None, :] * xh + gb[None, :]
    gda = tl.where(pos_side, gdz, gdz * slope)
    tl.store(gda_ptr + off, gda.to(gda_ptr.dtype.element_ty), mask=mask)
    big_g = (-grs[None, :] * (m_dzx[None, :] * av + m_ax[None, :] * dz)
             + gg[None, :] * dz)
    gy = (rs[None, :] * (big_g - mean_g[None, :] - xh * mean_gx[None, :])
          - xh * lr_coef[None, :])
    tl.store(gy_ptr + off, gy.to(gy_ptr.dtype.element_ty), mask=mask)


@functools.lru_cache(maxsize=None)
def _jit() -> SimpleNamespace:
    import triton
    import triton.language

    global tl, _rne_bf16, _bf16_chain
    tl = triton.language
    # the kernels call the helpers by their global names: the jitted
    # functions
    _rne_bf16 = triton.jit(_rne_bf16)
    _bf16_chain = triton.jit(_bf16_chain)
    return SimpleNamespace(
        rne_bf16=_rne_bf16,
        act_bwd_bwd_reduce=triton.jit(_bn_act_bwd_bwd_reduce_kernel),
        act_bwd_bwd_out=triton.jit(_bn_act_bwd_bwd_out_kernel),
    )


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def is_bf16(t) -> bool:
    """Whether ``t`` is bf16: the ``BF16`` constexpr of a launch."""
    return str(t.dtype) == "torch.bfloat16"


def _check_channels(name: str, C: int) -> None:
    if C > BLOCK_C:
        raise NotImplementedError(
            f"{name} takes at most {BLOCK_C} channels, got {C}"
        )


def _chunk(positions: int) -> int:
    """Positions per reduction program: the tenant's positions over SPLITS
    programs, in whole blocks."""
    return _cdiv(_cdiv(positions, SPLITS), BLOCK_P) * BLOCK_P


def launch_act_bwd_bwd(a, ggamma, gbeta, da, y, mean, rstd, gamma, beta,
                       part, g_da, g_y, g_gamma, slope: float) -> None:
    """K5a then K5b, pool-free, on validated contiguous CUDA tensors, all f32
    or all bf16 but the f32 ``part``, ``(T, SPLITS, 5, C)`` scratch (see
    ``conv_block.bn_act_bwd_bwd``)."""
    T, N, H, W, C = y.shape
    _check_channels("bn_act_bwd_bwd", C)
    NHW = N * H * W
    kern = _jit()
    bf16 = is_bf16(y)
    kern.act_bwd_bwd_reduce[(T, SPLITS)](
        a, da, y, mean, rstd, gamma, beta, part, NHW, C, SPLITS, _chunk(NHW),
        slope, BLOCK_P=BLOCK_P, BLOCK_C=BLOCK_C, BF16=bf16,
    )
    kern.act_bwd_bwd_out[(_cdiv(NHW, BLOCK_P), T)](
        a, ggamma, gbeta, da, y, mean, rstd, gamma, beta, part, g_da, g_y,
        g_gamma, NHW, C, SPLITS, 1.0 / NHW, slope, BLOCK_P=BLOCK_P,
        BLOCK_C=BLOCK_C, BF16=bf16,
    )
