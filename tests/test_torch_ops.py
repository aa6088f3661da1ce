"""The port's plain ops and kernel twins (``howtotrainyourmamlpytorch_tpu_torch
.ops.functional``) held to the JAX package's ops on the CPU.

Inputs come from a numpy seed and go through both. Forward and first
gradient (of ``sum(out * cotangent)``), f32, with and without the tenant
axis (the JAX side ``vmap``s over it), both ``bn_stats_impl`` modes.

Tolerances, as ``max |port - jax| <= tol * max |jax|``: values 1e-5 and
first gradients 1e-4 — f32 with sums taken in another order (the JAX CPU
oracle lowers the conv to im2col + one GEMM, as the port does, but XLA and
PyTorch block the GEMM and the reductions differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.ops import functional as JF
from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block
from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

torch.set_num_threads(2)

VALUE_TOL = 1e-5
GRAD_TOL = 1e-4


def _np(a):
    return np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                      np.float64)


def _close(got, want, tol, what="", scale=None):
    """``max |got - want| <= tol * scale``; ``scale`` defaults to
    ``max |want|``. Gradients pass the largest magnitude over all of one
    call's gradients: some are exactly zero in exact arithmetic (a conv
    bias under batch norm) and hold only round-off."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    if scale is None:
        scale = max(np.abs(want).max(), 1e-30) if want.size else 1.0
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} * {scale:.3e}"


def _t(a):
    return torch.from_numpy(np.array(a)).requires_grad_(True)


def _grads(torch_fn, jax_fn, arrays, rng):
    """Forward values and first gradients of both sides, wrt every array."""
    tin = [_t(a) for a in arrays]
    tout = torch_fn(*tin)
    ct = np.asarray(rng.randn(*tout.shape), np.float32)
    tg = torch.autograd.grad((tout * torch.from_numpy(ct)).sum(), tin)
    jout, vjp = jax.vjp(jax_fn, *[jnp.asarray(a) for a in arrays])
    jg = vjp(jnp.asarray(ct))
    return tout, jout, tg, jg


def _check(torch_fn, jax_fn, arrays, rng, what):
    tout, jout, tg, jg = _grads(torch_fn, jax_fn, arrays, rng)
    _close(tout, jout, VALUE_TOL, f"{what} value")
    gscale = max(np.abs(_np(g)).max() for g in jg)
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a, b, GRAD_TOL, f"{what} grad {i}", gscale)


def _conv_inputs(rng, tenants, n=2, h=7, w=6, cin=3, cout=5):
    lead = (tenants,) if tenants else ()
    x = rng.randn(*lead, n, h, w, cin).astype(np.float32)
    wt = (rng.randn(*lead, 3, 3, cin, cout) * 0.3).astype(np.float32)
    b = (rng.randn(*lead, cout) * 0.1).astype(np.float32)
    return x, wt, b


def _tenant_map(fn, tenants):
    return jax.vmap(fn) if tenants else fn


@pytest.mark.parametrize("tenants", [0, 2])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_matches_jax(tenants, stride):
    rng = np.random.RandomState(0)
    arrays = _conv_inputs(rng, tenants)
    _check(
        lambda x, w, b: F.conv2d(x, w, b, stride, 1),
        _tenant_map(lambda x, w, b: JF.conv2d(x, w, b, stride, 1,
                                              impl="im2col"), tenants),
        arrays, rng, "conv2d",
    )


@pytest.mark.parametrize("tenants", [0, 2])
@pytest.mark.parametrize("stats_impl", ["twopass", "fused"])
def test_batch_norm_matches_jax(tenants, stats_impl):
    rng = np.random.RandomState(1)
    lead = (tenants,) if tenants else ()
    x = (rng.randn(*lead, 3, 5, 4, 6) * 2 + 0.5).astype(np.float32)
    gamma = (1 + 0.2 * rng.randn(6)).astype(np.float32)
    beta = (0.1 * rng.randn(6)).astype(np.float32)
    rm = (0.1 * rng.randn(6)).astype(np.float32)
    rv = (1 + 0.1 * rng.rand(6)).astype(np.float32)

    def jax_bn(x, g, b):
        return JF.batch_norm(x, g, b, None, None, stats_impl=stats_impl)[0]

    _check(
        lambda x, g, b: F.batch_norm(x, g, b, None, None,
                                     stats_impl=stats_impl)[0],
        jax.vmap(jax_bn, in_axes=(0, None, None)) if tenants else jax_bn,
        (x, gamma, beta), rng, "batch_norm",
    )
    # the running-stat update (momentum 0.1, unbiased variance)
    _, nm, nv = F.batch_norm(torch.from_numpy(x), torch.from_numpy(gamma),
                             torch.from_numpy(beta), torch.from_numpy(rm),
                             torch.from_numpy(rv), stats_impl=stats_impl)

    def jax_stats(x):
        return JF.batch_norm(x, jnp.asarray(gamma), jnp.asarray(beta),
                             jnp.asarray(rm), jnp.asarray(rv),
                             stats_impl=stats_impl)[1:]

    jm, jv = (jax.vmap(jax_stats) if tenants else jax_stats)(jnp.asarray(x))
    _close(nm, jm, VALUE_TOL, "running mean")
    _close(nv, jv, VALUE_TOL, "running var")


@pytest.mark.parametrize("tenants", [0, 2])
@pytest.mark.parametrize("stats_impl", ["twopass", "fused"])
def test_conv_bn_act_matches_jax(tenants, stats_impl):
    rng = np.random.RandomState(2)
    x, w, b = _conv_inputs(rng, tenants)
    gamma = (1 + 0.2 * rng.randn(5)).astype(np.float32)
    beta = (0.1 * rng.randn(5)).astype(np.float32)

    def jax_block(x, w, b):
        return JF.conv_bn_act(x, w, b, jnp.asarray(gamma), jnp.asarray(beta),
                              None, None, 1, 1, impl="im2col",
                              bn_stats_impl=stats_impl)[0]

    _check(
        lambda x, w, b: F.conv_bn_act(
            x, w, b, torch.from_numpy(gamma), torch.from_numpy(beta), None,
            None, 1, 1, bn_stats_impl=stats_impl)[0],
        _tenant_map(jax_block, tenants), (x, w, b), rng, "conv_bn_act",
    )


@pytest.mark.parametrize("tenants", [0, 2])
@pytest.mark.parametrize("hw", [(8, 6), (7, 9)])
def test_max_pool2d_matches_jax(tenants, hw):
    """VALID 2x2/2 pooling; an odd trailing row/column is dropped."""
    rng = np.random.RandomState(3)
    lead = (tenants,) if tenants else ()
    x = rng.randn(*lead, 2, *hw, 3).astype(np.float32)
    _check(F.max_pool2d,
           _tenant_map(lambda x: JF.max_pool2d(x, impl="reshape"), tenants),
           (x,), rng, "max_pool2d")


def test_leaky_relu_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(4, 5, 6).astype(np.float32)
    _check(F.leaky_relu, JF.leaky_relu, (x,), rng, "leaky_relu")


@pytest.mark.parametrize("tenants", [0, 3])
def test_linear_matches_jax(tenants):
    rng = np.random.RandomState(5)
    lead = (tenants,) if tenants else ()
    x = rng.randn(*lead, 4, 7).astype(np.float32)
    w = rng.randn(*lead, 7, 3).astype(np.float32)
    b = rng.randn(*lead, 3).astype(np.float32)
    _check(F.linear, _tenant_map(JF.linear, tenants), (x, w, b), rng,
           "linear")


@pytest.mark.parametrize("tenants", [0, 3])
def test_cross_entropy_and_accuracy_match_jax(tenants):
    rng = np.random.RandomState(6)
    lead = (tenants,) if tenants else ()
    logits = (rng.randn(*lead, 6, 4) * 2).astype(np.float32)
    labels = rng.randint(0, 4, (*lead, 6)).astype(np.int32)
    y = jnp.asarray(labels)
    if tenants:
        def jax_ce(z):
            return jax.vmap(JF.cross_entropy)(z, y)
    else:
        def jax_ce(z):
            return JF.cross_entropy(z, y)
    _check(lambda z: F.cross_entropy(z, torch.from_numpy(labels)), jax_ce,
           (logits,), rng, "cross_entropy")
    acc = F.accuracy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_array_equal(
        acc.numpy(), np.asarray(JF.accuracy(jnp.asarray(logits),
                                            jnp.asarray(labels))))


# -- the kernels' plain twins against the JAX block ---------------------------


def _block_inputs(rng, hw=(9, 7), t=2, n=3, cin=3, cout=4):
    x, w, b = _conv_inputs(rng, t, n, hw[0], hw[1], cin, cout)
    gamma = (1 + 0.2 * rng.randn(t, cout)).astype(np.float32)
    beta = (0.1 * rng.randn(t, cout)).astype(np.float32)
    return x, w, b, gamma, beta


def _jax_block(x, w, b, g, be):
    """The JAX package's conv_bn_act + max_pool2d for one tenant."""
    out, _, _ = JF.conv_bn_act(x, w, b, g, be, None, None, 1, 1,
                               impl="im2col", bn_stats_impl="twopass")
    return JF.max_pool2d(out, impl="reshape")


@pytest.mark.parametrize("hw", [(8, 8), (9, 7)])
def test_kernel_twins_compose_to_the_jax_block(hw):
    """K1 -> K2 twins forward, K3 -> K4 twins backward, equal the JAX
    block and its VJP (odd sizes exercise the dropped row/column)."""
    rng = np.random.RandomState(7)
    arrays = _block_inputs(rng, hw)
    x, w, b, g, be = (torch.from_numpy(a) for a in arrays)
    y, mean, var, rstd = F.conv3x3_fwd_stats(x, w, b)
    pooled, arg = F.bn_act_pool_fwd(y, mean, rstd, g, be)
    jout, vjp = jax.vjp(jax.vmap(_jax_block),
                        *[jnp.asarray(a) for a in arrays])
    _close(pooled, jout, VALUE_TOL, "pooled")
    ct = rng.randn(*pooled.shape).astype(np.float32)
    jg = vjp(jnp.asarray(ct))
    dy, dgamma, dbeta = F.bn_act_pool_bwd(torch.from_numpy(ct), arg, y, mean,
                                          rstd, g, be)
    dx = F.conv3x3_dgrad(dy, w)
    dw, db = F.conv3x3_wgrad(x, dy)
    gscale = max(np.abs(_np(g)).max() for g in jg)
    for got, want, what in ((dx, jg[0], "dx"), (dw, jg[1], "dw"),
                            (db, jg[2], "db"), (dgamma, jg[3], "dgamma"),
                            (dbeta, jg[4], "dbeta")):
        _close(got, want, GRAD_TOL, what, gscale)


def test_block_function_backward_matches_jax():
    """The block's chain of Functions (``function_block``; its wrappers
    take the twins on the CPU) gives the JAX block's gradients, and leaves
    every launch counter at 0."""
    rng = np.random.RandomState(8)
    arrays = _block_inputs(rng, (11, 11))
    conv_block.reset_launches()
    _check(lambda *a: conv_block.function_block(*a)[0],
           jax.vmap(_jax_block), arrays, rng, "function_block")
    assert conv_block.launches() == {k: 0 for k in conv_block.KERNELS}


def test_wrappers_take_the_plain_path_on_cpu():
    """Each wrapper returns its twin's result for CPU tensors and counts
    no launch."""
    rng = np.random.RandomState(9)
    x, w, b, g, be = (torch.from_numpy(a) for a in _block_inputs(rng))
    conv_block.reset_launches()
    got = conv_block.conv3x3_fwd_stats(x, w, b)
    want = F.conv3x3_fwd_stats(x, w, b)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    y, mean, _, rstd = want
    pooled, arg = conv_block.bn_act_pool_fwd(y, mean, rstd, g, be)
    torch.testing.assert_close(
        pooled, F.bn_act_pool_fwd(y, mean, rstd, g, be)[0], rtol=0, atol=0)
    dp = torch.from_numpy(rng.randn(*pooled.shape).astype(np.float32))
    dy = conv_block.bn_act_pool_bwd(dp, arg, y, mean, rstd, g, be)[0]
    torch.testing.assert_close(
        dy, F.bn_act_pool_bwd(dp, arg, y, mean, rstd, g, be)[0], rtol=0,
        atol=0)
    torch.testing.assert_close(conv_block.conv3x3_dgrad(dy, w),
                               F.conv3x3_dgrad(dy, w), rtol=0, atol=0)
    for a, c in zip(conv_block.conv3x3_wgrad(x, dy), F.conv3x3_wgrad(x, dy)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    out = conv_block.conv_bn_act_pool(x, w, b, g, be)
    for a, c in zip(out, F.conv_bn_act_pool(x, w, b, g, be)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert conv_block.launches() == {k: 0 for k in conv_block.KERNELS}
