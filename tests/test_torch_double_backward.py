"""The block's hand-written derivatives, first and second order, on the CPU.

On CPU tensors every kernel wrapper takes its plain twin, so the
``autograd.Function`` structure of ``kernels/conv_block.py`` (the one the
card runs) is checked here through the twins:

* f64 ``gradcheck`` and ``gradgradcheck`` of the whole Function block and,
  separately, of ``Conv3x3`` (stats-free), ``Dgrad``, ``Wgrad`` and
  ``BnActPoolBwd``, on small ragged shapes (odd H and W: the pool drops a
  row and a column);
* K5's twin (``bn_act_pool_bwd_bwd``, formulas written out) against
  autograd of K3's twin with the statistics computed from y, in f64 at
  atol 1e-10;
* the second derivative of the Function block against autograd of the
  plain block;
* the new wrappers take their twins on the CPU and count no launch, and
  refuse any other device but CUDA.
"""

import numpy as np
import pytest
import torch
from torch.autograd import gradcheck, gradgradcheck

from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

torch.set_num_threads(2)

# T, N, H, W, cin, cout
SHAPE = (2, 2, 7, 5, 2, 3)


def _f64(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.randn(*shape) * scale).requires_grad_(True)


def _block_inputs(seed=0, shape=SHAPE):
    T, N, H, W, cin, cout = shape
    rng = np.random.RandomState(seed)
    return (_f64(rng, T, N, H, W, cin), _f64(rng, T, 3, 3, cin, cout,
                                             scale=0.4),
            _f64(rng, T, cout, scale=0.1),
            torch.from_numpy(1 + 0.2 * rng.randn(T, cout)).requires_grad_(),
            _f64(rng, T, cout, scale=0.1))


def _pooled_of(fn):
    return lambda *a: fn(*a)[0]


def test_function_block_gradcheck_and_gradgradcheck():
    inputs = _block_inputs()
    block = _pooled_of(cb.function_block)
    assert gradcheck(block, inputs)
    assert gradgradcheck(block, inputs)


def test_conv_functions_gradcheck_and_gradgradcheck():
    """The conv closure: stats-free conv, dgrad and wgrad are each other's
    derivatives, to any order."""
    x, w, b, _, _ = _block_inputs(1)
    T, N, H, W, _, cout = SHAPE
    dy = _f64(np.random.RandomState(2), T, N, H, W, cout)
    cases = [
        (lambda x, w, b: cb.Conv3x3.apply(x, w, b, False), (x, w, b)),
        (cb.Dgrad.apply, (dy, w)),
        (lambda x, dy: cb.Wgrad.apply(x, dy), (x, dy)),
    ]
    for fn, args in cases:
        assert gradcheck(fn, args)
        assert gradgradcheck(fn, args)


def _bwd_setup(seed=3):
    """K3's inputs at SHAPE: y, a pooled gradient, gamma, beta, and the
    argmax of the forward at those values."""
    T, N, H, W, _, C = SHAPE
    rng = np.random.RandomState(seed)
    y = _f64(rng, T, N, H, W, C)
    gamma = torch.from_numpy(1 + 0.3 * rng.randn(T, C)).requires_grad_()
    beta = _f64(rng, T, C, scale=0.2)
    mean, _, rstd = F.bn_stats(y.detach())
    pooled, arg = F.bn_act_pool_fwd(y.detach(), mean, rstd, gamma.detach(),
                                    beta.detach())
    dp = _f64(rng, *pooled.shape)
    return dp, arg, y, gamma, beta


def test_bn_act_pool_bwd_gradcheck_and_gradgradcheck():
    """``BnActPoolBwd`` as a function of (dpooled, y, gamma, beta): its
    statistics are recomputed from y at every evaluation (K3 and K5 take
    them as companions whose dependence on y they account for)."""
    dp, arg, y, gamma, beta = _bwd_setup()

    def k3(dp, y, gamma, beta):
        mean, _, rstd = F.bn_stats(y.detach())
        return cb.BnActPoolBwd.apply(dp, arg, y, mean, rstd, gamma, beta)

    assert gradcheck(k3, (dp, y, gamma, beta))
    assert gradgradcheck(k3, (dp, y, gamma, beta))


def test_k5_twin_matches_autograd_of_the_k3_twin():
    dp, arg, y, gamma, beta = _bwd_setup(4)
    mean, _, rstd = F.bn_stats(y)
    outs = F.bn_act_pool_bwd(dp, arg, y, mean, rstd, gamma, beta)
    rng = np.random.RandomState(5)
    cts = [torch.from_numpy(rng.randn(*o.shape)) for o in outs]
    want = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(outs, cts)), [dp, y, gamma, beta],
        allow_unused=True)
    m, _, r = F.bn_stats(y.detach())
    got = F.bn_act_pool_bwd_bwd(*cts, dp.detach(), arg, y.detach(), m, r,
                                gamma.detach(), beta.detach())
    for g, w_, what in zip(got, want, ("dpooled", "y", "gamma")):
        torch.testing.assert_close(g, w_, rtol=0, atol=1e-10, msg=what)
    # beta enters only through the piecewise-constant masks
    assert want[3] is None or float(want[3].abs().max()) == 0.0


def test_block_second_derivative_matches_plain_autograd():
    """A scalar function of the block's first gradients, differentiated
    again: the Function block equals autograd of the plain block."""
    results = []
    for fn in (cb.function_block, F.conv_bn_act_pool):
        x, w, b, gamma, beta = _block_inputs(6, (2, 3, 9, 9, 3, 4))
        pooled, _, _ = fn(x, w, b, gamma, beta)
        ct = torch.from_numpy(
            np.random.RandomState(7).randn(*pooled.shape))
        first = torch.autograd.grad((pooled * ct).sum(), [x, w, b, gamma],
                                    create_graph=True)
        scalar = sum((g * g).sum() for g in first)
        results.append(torch.autograd.grad(scalar, [x, w, b, gamma, beta],
                                           allow_unused=True))
    for got, want, what in zip(*results, ("x", "w", "b", "gamma", "beta")):
        if want is None:
            assert got is None or float(got.abs().max()) == 0.0, what
            continue
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9,
                                   msg=what)


def test_new_wrappers_take_the_twins_on_cpu():
    x, w, b, gamma, beta = (t.detach().float() for t in _block_inputs(8))
    cb.reset_launches()
    torch.testing.assert_close(cb.conv3x3_fwd(x, w, b), F.conv3x3(x, w, b),
                               rtol=0, atol=0)
    torch.testing.assert_close(cb.conv3x3_fwd(x, w), F.conv3x3(x, w),
                               rtol=0, atol=0)
    y, mean, _, rstd = F.conv3x3_fwd_stats(x, w, b)
    pooled, arg = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
    args = (torch.ones_like(y), torch.ones_like(gamma), torch.ones_like(beta),
            torch.ones_like(pooled), arg, y, mean, rstd, gamma, beta)
    for a, c in zip(cb.bn_act_pool_bwd_bwd(*args),
                    F.bn_act_pool_bwd_bwd(*args)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert cb.launches() == {k: 0 for k in cb.KERNELS}


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


def test_new_wrappers_refuse_other_devices():
    y = _meta(1, 2, 6, 6, 4)
    v = _meta(1, 4)
    p = _meta(1, 2, 3, 3, 4)
    cb.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        cb.conv3x3_fwd(_meta(1, 2, 6, 6, 3), _meta(1, 3, 3, 3, 4))
    with pytest.raises(ValueError, match="CUDA"):
        cb.bn_act_pool_bwd_bwd(y, v, v, p, _meta(1, 2, 3, 3, 4,
                                                  dtype=torch.uint8),
                               y, v, v, v, v)
    assert cb.launches() == {k: 0 for k in cb.KERNELS}
