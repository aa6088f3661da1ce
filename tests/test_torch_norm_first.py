"""The norm-first model (``block_order='norm_conv_relu'``: batch norm of the
block input -> conv + bias -> leaky-ReLU -> pool) of the port held to the
JAX package on the CPU, module by module and as a whole:

* the standalone batch-norm twins (``bn_input_stats``, ``batch_norm_fwd``)
  against JAX ``batch_norm`` (``twopass`` and ``fused``, C in {1, 3, 8}),
  the running update at the input's count; ``batch_norm_bwd`` /
  ``batch_norm_bwd_bwd`` (K3/K5 at slope 1) against autograd of plain
  batch norm in f64;
* the leaky-ReLU + max-pool twins (``act_pool_fwd/bwd/gather``,
  ``act_fwd/bwd``) against JAX ``leaky_relu`` + ``max_pool2d`` and
  ``jax.vjp``, odd sizes (a dropped row and column);
* the pool-tie rule: at exact ties the port's plain ``max_pool2d`` routes
  the gradient as JAX ``max_pool2d(impl='reshape')`` (split among the tied
  maxima), and the kernels' twins (``bn_act_pool_fwd/bwd``,
  ``act_pool_fwd/bwd``) as ``impl='reduce_window'`` (all to the first);
* f64 ``gradcheck`` / ``gradgradcheck`` of every new Function and of
  ``norm_function_block`` (pooled, and strided with the global average
  pool), and its second derivative against plain autograd;
* ``vgg.init`` shapes against the JAX ``init`` in both geometries, the
  state round trip, ``vgg.apply`` against JAX ``apply`` (steps 0, 2 and a
  clamped 5, running statistics included) and the tenant axis against
  ``jax.vmap``;
* ``make_serve_step``, second-order ``make_grads_fn`` and one
  ``make_train_step`` against the JAX package;
* the launch formulas ``chip_smoke.py`` holds the card to, by counting
  the twins; a block of one order handed the other config raises;
* ``serve-bench`` and ``train-bench --block_order norm_conv_relu`` on the
  CPU.

Inputs are made from numpy seeds; JAX runs on the CPU as its own tests
run it. Tolerances (those of ``test_torch_strided.py``): logits ``1e-5``
of their scale; a meta-gradient leaf within ``1e-6 + 1e-4 * max|jax
leaf|``; the loss within rtol ``1e-4``; the twins' forward values ``1e-5``
and their gradients ``1e-4`` of their scale (f32, sums in another order).
"""

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import gradcheck, gradgradcheck

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.core import maml as jax_maml
from howtotrainyourmamlpytorch_tpu.core import partition as jax_partition
from howtotrainyourmamlpytorch_tpu.models import vgg as jax_vgg
from howtotrainyourmamlpytorch_tpu.ops import functional as JF
from howtotrainyourmamlpytorch_tpu_torch import bench
from howtotrainyourmamlpytorch_tpu_torch import state as state_lib
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.core import maml
from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
from howtotrainyourmamlpytorch_tpu_torch.models import vgg
from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F
from howtotrainyourmamlpytorch_tpu_torch.serving import bench as serve_bench
from test_torch_train import _chip_smoke, _count_function_path, _formula_cfg

torch.set_num_threads(2)

VALUE_TOL = 1e-5
GRAD_TOL = 1e-4
GRAD_ATOL = 1e-6
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-4
WEIGHTS = np.asarray([0.4, 0.6], np.float32)
FLAGSHIP = ("experiment_config/"
            "mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json")
OMNIGLOT = "experiment_config/omniglot_maml++-omniglot_1_20_8_0.1_64_0.json"
NORM_FIRST = dict(block_order="norm_conv_relu")


def _close(got, want, tol, what, scale=None):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max() if scale is None else scale
    err = np.abs(got - want).max()
    assert err <= tol * max(scale, 1e-30), f"{what}: {err:.3e} vs {scale:.3e}"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfgs(stats_impl="twopass", max_pooling=True, hw=11, **extra):
    """A small norm-first model: 11x11x3 (pooled 11 -> 5 -> 2, dropping a
    row and a column; strided 11 -> 6 -> 3), 3-way 2-shot, 2 targets, 2
    stages of 6 filters, MAML++ on."""
    kw = dict(
        dataset_name="omniglot_dataset", image_height=hw, image_width=hw,
        image_channels=3, num_classes_per_set=3, num_samples_per_class=2,
        num_target_samples=2, batch_size=2, cnn_num_filters=6, num_stages=2,
        max_pooling=max_pooling, conv_padding=True,
        per_step_bn_statistics=True,
        learnable_per_layer_per_step_inner_loop_learning_rate=True,
        use_multi_step_loss_optimization=True, second_order=True,
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2, use_remat=False,
        task_learning_rate=0.1, bn_stats_impl=stats_impl,
        serving_bucket_ladder=[1, 2, 4], serving_max_tenants_per_dispatch=4,
        **NORM_FIRST,
    )
    kw.update(extra)
    return JaxConfig(**kw), MAMLConfig(**kw)


# -- the standalone batch norm (B5b) --------------------------------------------


@pytest.mark.parametrize("stats_impl", ["twopass", "fused"])
@pytest.mark.parametrize("C", [1, 3, 8])
def test_batch_norm_twins_match_jax(C, stats_impl):
    """``bn_input_stats`` + ``batch_norm_fwd`` against JAX ``batch_norm`` of
    each tenant (pixels in [0, 1], as the images at stage 0), the plain
    block's statistics in the config's mode, and the running update at the
    input's count N*H*W."""
    rng = np.random.RandomState(C)
    T, N, H, W = 2, 3, 5, 7
    x = rng.rand(T, N, H, W, C).astype(np.float32)
    gamma = (1 + 0.3 * rng.randn(T, C)).astype(np.float32)
    beta = (0.2 * rng.randn(T, C)).astype(np.float32)
    rm = (0.1 * rng.randn(T, C)).astype(np.float32)
    rv = (1 + 0.1 * rng.rand(T, C)).astype(np.float32)

    def one(xi, gi, bi, mi, vi):
        return JF.batch_norm(xi, gi, bi, mi, vi, stats_impl=stats_impl)

    jy, jm, jv = jax.vmap(one)(*(jnp.asarray(a) for a in
                                 (x, gamma, beta, rm, rv)))
    mean, var, rstd = F.bn_input_stats(_t(x))
    xn = x.astype(np.float64)
    _close(mean, xn.mean((1, 2, 3)), VALUE_TOL, "mean")
    _close(var, xn.var((1, 2, 3)), VALUE_TOL, "var")
    _close(rstd, 1 / np.sqrt(xn.var((1, 2, 3)) + F.BN_EPS), VALUE_TOL,
           "rstd")
    _close(F.batch_norm_fwd(_t(x), mean, rstd, _t(gamma), _t(beta)), jy,
           VALUE_TOL, "batch_norm_fwd")
    bmean, bvar = F.batch_stats(_t(x), stats_impl)
    nm, nv = F.running_update(_t(rm), _t(rv), bmean, bvar, N * H * W)
    _close(nm, jm, VALUE_TOL, "running mean")
    _close(nv, jv, VALUE_TOL, "running var")
    # the wrappers take these twins on the CPU and count no launch
    cb.reset_launches()
    _close(cb.bn_input_stats(_t(x))[1], xn.var((1, 2, 3)), VALUE_TOL,
           "wrapper var")
    assert set(cb.launches().values()) == {0}


def test_batch_norm_bwd_twins_match_autograd_in_f64():
    """K3 and K5 at slope 1 are batch norm's backward and double backward:
    ``batch_norm_bwd`` against autograd of plain batch norm, and
    ``batch_norm_bwd_bwd`` against autograd of ``batch_norm_bwd``, f64."""
    rng = np.random.RandomState(3)
    T, N, H, W, C = 2, 3, 4, 5, 3
    x = torch.from_numpy(rng.randn(T, N, H, W, C)).requires_grad_(True)
    gamma = torch.from_numpy(1 + 0.3 * rng.randn(T, C)).requires_grad_(True)
    beta = torch.from_numpy(0.2 * rng.randn(T, C)).requires_grad_(True)
    dz = torch.from_numpy(rng.randn(T, N, H, W, C))

    def plain(x, gamma, beta):
        mean, var = F.batch_stats(x)
        xhat = (x - mean[:, None, None, None]) / torch.sqrt(
            var[:, None, None, None] + F.BN_EPS)
        return xhat * gamma[:, None, None, None] + beta[:, None, None, None]

    want = torch.autograd.grad(plain(x, gamma, beta), [x, gamma, beta], dz)
    mean, _, rstd = F.bn_input_stats(x.detach())
    got = F.batch_norm_bwd(dz, x.detach(), mean, rstd, gamma.detach(),
                           beta.detach())
    for g, w_, what in zip(got, want, ("dx", "dgamma", "dbeta")):
        torch.testing.assert_close(g, w_, rtol=0, atol=1e-10, msg=what)

    dz.requires_grad_(True)
    m, _, r = F.bn_stats(x)
    outs = F.batch_norm_bwd(dz, x, m, r, gamma, beta)
    cts = [torch.from_numpy(rng.randn(*o.shape)) for o in outs]
    want = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(outs, cts)), [dz, x, gamma, beta],
        allow_unused=True)
    got = F.batch_norm_bwd_bwd(*cts, dz.detach(), x.detach(), mean, rstd,
                               gamma.detach(), beta.detach())
    for g, w_, what in zip(got, want, ("dz", "x", "gamma")):
        torch.testing.assert_close(g, w_, rtol=0, atol=1e-10, msg=what)
    assert want[3] is None or float(want[3].abs().max()) == 0.0


# -- the standalone leaky-ReLU + max pool (B2) --------------------------------------


def _jax_act_pool(y, impl="reduce_window"):
    """JAX leaky_relu + max_pool2d of one tenant."""
    return JF.max_pool2d(JF.leaky_relu(y), impl=impl)


@pytest.mark.parametrize("hw", [(6, 8), (7, 5)], ids=["even", "odd"])
def test_act_pool_twins_match_jax(hw):
    """Forward, its vjp (``act_pool_bwd``) and the vjp's transpose in the
    cotangent (``act_pool_gather``), at even and odd sizes (7 -> 3 drops
    the last row, 5 -> 2 the last column)."""
    rng = np.random.RandomState(sum(hw))
    T, N, C = 2, 3, 4
    y = rng.randn(T, N, *hw, C).astype(np.float32)
    jy = jnp.asarray(y)
    jout, vjp = jax.vjp(jax.vmap(_jax_act_pool), jy)
    dp = rng.randn(*jout.shape).astype(np.float32)
    g_dy = rng.randn(*y.shape).astype(np.float32)
    (jdy,) = vjp(jnp.asarray(dp))
    _, vjp2 = jax.vjp(lambda d: vjp(d)[0], jnp.asarray(dp))
    (jg,) = vjp2(jnp.asarray(g_dy))

    pooled, arg = F.act_pool_fwd(_t(y))
    assert arg.dtype == torch.uint8
    _close(pooled, jout, VALUE_TOL, "act_pool_fwd")
    dy = F.act_pool_bwd(_t(dp), arg, _t(y))
    _close(dy, jdy, VALUE_TOL, "act_pool_bwd")
    _close(F.act_pool_gather(_t(g_dy), arg, _t(y)), jg, VALUE_TOL,
           "act_pool_gather")
    h, w = hw
    assert not dy[:, :, 2 * (h // 2):].any()
    assert not dy[:, :, :, 2 * (w // 2):].any()
    # pool-free: the leaky-ReLU and its vjp
    jact, vjp_act = jax.vjp(JF.leaky_relu, jy)
    _close(F.act_fwd(_t(y)), jact, VALUE_TOL, "act_fwd")
    _close(F.act_bwd(_t(g_dy), _t(y)), vjp_act(jnp.asarray(g_dy))[0],
           VALUE_TOL, "act_bwd")
    cb.reset_launches()
    _close(cb.act_pool_fwd(_t(y))[0], jout, VALUE_TOL, "wrapper")
    assert set(cb.launches().values()) == {0}


def _tied(rng, shape):
    """Values on a grid of 0.5 in [-1, 1]: most 2x2 windows hold exact
    ties, of positive and of negative maxima."""
    return (rng.randint(-2, 3, size=shape) * 0.5).astype(np.float32)


def test_pool_ties_follow_the_documented_rule():
    """At exact ties the plain ``max_pool2d`` (the model's CPU path) splits
    the gradient among the tied maxima, as JAX ``impl='reshape'`` (the
    JAX package's CPU default); the kernels' twins route all of it to the
    first maximum in ``2 * dh + dw`` order, as JAX ``impl='reduce_window'``
    (its accelerator default). The two rules differ on this input."""
    rng = np.random.RandomState(0)
    T, N, H, W, C = 2, 3, 7, 6, 4
    y = _tied(rng, (T, N, H, W, C))
    dp = rng.randn(T, N, H // 2, W // 2, C).astype(np.float32)
    routes = {}
    for impl in ("reshape", "reduce_window"):
        _, vjp = jax.vjp(jax.vmap(lambda v: JF.max_pool2d(v, impl=impl)),
                         jnp.asarray(y))
        routes[impl] = np.asarray(vjp(jnp.asarray(dp))[0])
    assert np.abs(routes["reshape"] - routes["reduce_window"]).max() > 0.1

    yt = _t(y).requires_grad_(True)
    (plain,) = torch.autograd.grad(F.max_pool2d(yt), yt, _t(dp))
    _close(plain, routes["reshape"], VALUE_TOL, "plain max_pool2d")

    # act_pool twins: leaky-ReLU + pool
    _, vjp = jax.vjp(jax.vmap(_jax_act_pool), jnp.asarray(y))
    want = np.asarray(vjp(jnp.asarray(dp))[0])
    _, arg = F.act_pool_fwd(_t(y))
    _close(F.act_pool_bwd(_t(dp), arg, _t(y)), want, VALUE_TOL,
           "act_pool twins")

    # K2/K3 twins: batch norm + leaky-ReLU + pool; equal inputs give equal
    # normalized values, so the ties survive the normalization
    gamma = (1 + 0.3 * rng.rand(T, C)).astype(np.float32)
    beta = (0.2 * rng.randn(T, C)).astype(np.float32)

    def jax_bn_act_pool(v, g, b):
        out, _, _ = JF.batch_norm(v, g, b, None, None)
        return _jax_act_pool(out)

    _, vjp = jax.vjp(jax.vmap(jax_bn_act_pool), *(jnp.asarray(a) for a in
                                                   (y, gamma, beta)))
    jdy, jdg, jdb = vjp(jnp.asarray(dp))
    mean, _, rstd = F.bn_stats(_t(y))
    args = (_t(y), mean, rstd, _t(gamma), _t(beta))
    _, arg = F.bn_act_pool_fwd(*args)
    dy, dg, db = F.bn_act_pool_bwd(_t(dp), arg, *args)
    _close(dy, jdy, GRAD_TOL, "bn_act_pool twins dy")
    _close(dg, jdg, GRAD_TOL, "bn_act_pool twins dgamma")
    _close(db, jdb, GRAD_TOL, "bn_act_pool twins dbeta")


# -- the Functions, f64 --------------------------------------------------------------


def _f64(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.randn(*shape) * scale).requires_grad_(True)


def test_batch_norm_functions_gradcheck_and_gradgradcheck():
    """``BatchNorm`` (statistics, normalize) and ``BatchNormBwd`` (its
    backward, whose own backward is ``batch_norm_bwd_bwd``), f64."""
    rng = np.random.RandomState(1)
    T, N, H, W, C = 2, 2, 3, 4, 3
    x = _f64(rng, T, N, H, W, C)
    gamma = torch.from_numpy(1 + 0.3 * rng.randn(T, C)).requires_grad_()
    beta = _f64(rng, T, C, scale=0.2)
    dz = _f64(rng, T, N, H, W, C)

    def bn(x, gamma, beta):
        return cb.BatchNorm.apply(x, gamma, beta)[0]

    def bn_bwd(dz, x, gamma, beta):
        mean, _, rstd = F.bn_stats(x.detach())
        return cb.BatchNormBwd.apply(dz, x, mean, rstd, gamma, beta)

    assert gradcheck(bn, (x, gamma, beta))
    assert gradgradcheck(bn, (x, gamma, beta))
    assert gradcheck(bn_bwd, (dz, x, gamma, beta))
    assert gradgradcheck(bn_bwd, (dz, x, gamma, beta))


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "pool_free"])
def test_act_pool_functions_gradcheck_and_gradgradcheck(pool):
    """``ActPool`` -> ``ActPoolBwd`` -> ``ActPoolGather`` (pool-free:
    ``ActPoolBwd`` again) -> ``ActPoolBwd``, f64, at an odd size."""
    rng = np.random.RandomState(2)
    T, N, H, W, C = 2, 2, 5, 4, 3
    y = _f64(rng, T, N, H, W, C)
    out_shape = (T, N, H // 2, W // 2, C) if pool else (T, N, H, W, C)
    dout = _f64(rng, *out_shape)
    g_dy = _f64(rng, T, N, H, W, C)
    arg = F.act_pool_fwd(y.detach())[1] if pool else None

    def act(y):
        out = cb.ActPool.apply(y, pool)
        return out[0] if pool else out

    def bwd(dout, y):
        return cb.ActPoolBwd.apply(dout, arg, y)

    assert gradcheck(act, (y,))
    assert gradgradcheck(act, (y,))
    assert gradcheck(bwd, (dout, y))
    assert gradgradcheck(bwd, (dout, y))
    if pool:
        def gather(g, y):
            return cb.ActPoolGather.apply(g, arg, y)

        assert gradcheck(gather, (g_dy, y))
        assert gradgradcheck(gather, (g_dy, y))


def _block_inputs(seed=0, shape=(2, 2, 7, 6, 3, 4)):
    T, N, H, W, cin, cout = shape
    rng = np.random.RandomState(seed)
    return (_f64(rng, T, N, H, W, cin),
            _f64(rng, T, 3, 3, cin, cout, scale=0.4),
            _f64(rng, T, cout, scale=0.1),
            torch.from_numpy(1 + 0.2 * rng.randn(T, cin)).requires_grad_(),
            _f64(rng, T, cin, scale=0.1))


BLOCK_CASES = [dict(), dict(stride=2, pool=False, gap=True)]


@pytest.mark.parametrize("kw", BLOCK_CASES, ids=["pooled", "strided_gap"])
def test_norm_function_block_gradcheck_and_gradgradcheck(kw):
    inputs = _block_inputs()

    def block(*a):
        return cb.norm_function_block(*a, **kw)[0]

    assert gradcheck(block, inputs)
    assert gradgradcheck(block, inputs)


@pytest.mark.parametrize("kw", BLOCK_CASES, ids=["pooled", "strided_gap"])
def test_norm_block_second_derivative_matches_plain_autograd(kw):
    """A scalar function of the block's first gradients, differentiated
    again: the Function block equals autograd of the plain block, and both
    return the input's batch statistics."""
    results = []
    for fn in (cb.norm_function_block, F.norm_conv_act_pool):
        x, w, b, gamma, beta = _block_inputs(6, (2, 3, 9, 8, 3, 4))
        out, mean, var = fn(x, w, b, gamma, beta, **kw)
        xd = x.detach().numpy()
        _close(mean, xd.mean((1, 2, 3)), 1e-12, "mean")
        _close(var, xd.var((1, 2, 3)), 1e-12, "var")
        ct = torch.from_numpy(np.random.RandomState(7).randn(*out.shape))
        first = torch.autograd.grad((out * ct).sum(), [x, w, b, gamma, beta],
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


def test_third_derivative_of_the_norm_block_raises():
    """``batch_norm_bwd_bwd``'s own derivative is not written: on the card
    its graph node raises rather than treating its outputs as constants."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 2, 4, 4, 3).astype(np.float32))
    x.requires_grad_(True)
    g, be = torch.ones(1, 3), torch.zeros(1, 3)
    mean, _, rstd = F.bn_stats(x.detach())
    outs = cb.BatchNormBwdBwd.apply(torch.ones_like(x), g, be,
                                    torch.ones_like(x), x, mean, rstd, g, be)
    with pytest.raises(NotImplementedError, match="third derivative"):
        outs[1].sum().backward()


# -- the model ---------------------------------------------------------------------


def _state(jcfg, seed=0):
    host = jax.device_get(jax_maml.init_state(jcfg, seed=seed))
    rng = np.random.RandomState(seed + 10)
    net = {k: np.array(v) for k, v in host.net.items()}
    bn = {k: np.array(v) for k, v in host.bn.items()}
    for k in net:
        if ".norm." in k:
            net[k] = (net[k] + 0.1 * rng.randn(*net[k].shape)).astype(
                np.float32)
    for k in bn:
        bn[k] = (bn[k] + 0.1 * rng.rand(*bn[k].shape)).astype(np.float32)
    return net, bn


@pytest.mark.parametrize("max_pooling", [True, False],
                         ids=["pooled", "strided"])
def test_norm_first_init_matches_jax_and_round_trips(max_pooling):
    """The norm leaves sized to each block's INPUT (``conv0.norm.gamma``
    (steps, 3)), in both geometries, at the mini-ImageNet width too; the
    JAX state crosses leaf by leaf and back."""
    for jcfg, cfg in (_cfgs(max_pooling=max_pooling),
                      (JaxConfig.from_json_file(FLAGSHIP, max_pooling=max_pooling,
                                                **NORM_FIRST),
                       MAMLConfig.from_json_file(FLAGSHIP,
                                                 max_pooling=max_pooling,
                                                 **NORM_FIRST))):
        params, bn = vgg.init(cfg, torch.Generator().manual_seed(0))
        jparams, jbn = jax_vgg.init(jcfg, jax.random.PRNGKey(0))
        assert {k: tuple(v.shape) for k, v in params.items()} == {
            k: tuple(v.shape) for k, v in jparams.items()}
        assert {k: tuple(v.shape) for k, v in bn.items()} == {
            k: tuple(v.shape) for k, v in jbn.items()}
        steps, c_in = cfg.bn_num_steps, cfg.image_channels
        assert tuple(params["conv0.norm.gamma"].shape) == (steps, c_in)
        assert tuple(bn["conv0.norm.var"].shape) == (steps, c_in)
    host = jax.device_get(jax_maml.init_state(jcfg, seed=0))
    back = state_lib.to_numpy(state_lib.from_numpy(host, device="cpu"))
    for name in ("net", "lslr", "bn"):
        for key, v in getattr(host, name).items():
            np.testing.assert_array_equal(getattr(back, name)[key], v)


@pytest.mark.parametrize("block", ["plain", "functions"])
@pytest.mark.parametrize("max_pooling", [True, False],
                         ids=["pooled", "strided"])
@pytest.mark.parametrize("step", [0, 2, 5])
def test_norm_first_apply_matches_jax(step, max_pooling, block):
    """Logits, the new BN state (the running update at each block input's
    count) and d(logits . ct)/dparams at steps 0, 2 and 5 (clamped to the
    last of 3), on the plain block and on the Function block."""
    jcfg, cfg = _cfgs(max_pooling=max_pooling,
                      number_of_training_steps_per_iter=3)
    net, bn = _state(jcfg)
    rng = np.random.RandomState(step)
    x = rng.rand(5, 11, 11, 3).astype(np.float32)
    ct = rng.randn(5, 3).astype(np.float32)

    def jax_fn(params):
        logits, new_bn = jax_vgg.apply(
            jcfg, params, {k: jnp.asarray(v) for k, v in bn.items()},
            jnp.asarray(x), step)
        return jnp.sum(logits * ct), (logits, new_bn)

    jgrad, (jlogits, jbn) = jax.grad(jax_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in net.items()})
    tparams = {k: _t(v).requires_grad_(True) for k, v in net.items()}
    logits, new_bn = vgg.apply(
        cfg, tparams, {k: _t(v) for k, v in bn.items()}, _t(x), step,
        block=cb.norm_function_block if block == "functions" else None)
    tgrad = torch.autograd.grad((logits * _t(ct)).sum(),
                                list(tparams.values()), allow_unused=True)
    _close(logits, jlogits, VALUE_TOL, "logits")
    assert sorted(new_bn) == sorted(jbn)
    for k in jbn:
        _close(new_bn[k], jbn[k], VALUE_TOL, k)
    gscale = max(np.abs(np.asarray(g)).max() for g in jgrad.values())
    for k, g in zip(tparams, tgrad):
        g = torch.zeros_like(tparams[k]) if g is None else g
        _close(g, jgrad[k], GRAD_TOL, f"grad {k}", gscale)


def test_norm_first_apply_tenant_axis_matches_jax_vmap():
    jcfg, cfg = _cfgs(max_pooling=False)
    net, bn = _state(jcfg, seed=1)
    rng = np.random.RandomState(7)
    T = 3
    adapted = {k for k in net if jax_partition.is_inner_adapted(jcfg, k)}
    tnet = {k: (v[None] + 0.05 * rng.randn(T, *v.shape)).astype(np.float32)
            if k in adapted else v for k, v in net.items()}
    x = rng.rand(T, 4, 11, 11, 3).astype(np.float32)

    def one(params_adapted, xi):
        frozen = {k: jnp.asarray(v) for k, v in tnet.items()
                  if k not in adapted}
        return jax_vgg.apply(jcfg, {**frozen, **params_adapted},
                             {k: jnp.asarray(v) for k, v in bn.items()},
                             xi, 1)

    jlogits, jbn = jax.vmap(one)(
        {k: jnp.asarray(tnet[k]) for k in adapted}, jnp.asarray(x))
    logits, new_bn = vgg.apply(cfg, {k: _t(v) for k, v in tnet.items()},
                               {k: _t(v) for k, v in bn.items()}, _t(x), 1)
    _close(logits, jlogits, VALUE_TOL, "logits")
    for k in jbn:
        _close(new_bn[k], jbn[k], VALUE_TOL, k)


def test_a_block_of_the_other_order_raises():
    """Stage 1 onwards has c_in = cout, so a conv-first block would take
    the norm-first gamma/beta shapes and silently compute another model:
    ``vgg.apply`` refuses a block whose order is not the config's, either
    way round, and a block that names none."""
    _, cfg = _cfgs(cnn_num_filters=3)
    _, conv_first = _cfgs(cnn_num_filters=3, block_order="conv_norm_relu")
    x = torch.zeros(2, 11, 11, 3)
    for c, wrong in ((cfg, cb.conv_bn_act_pool), (cfg, F.conv_bn_act_pool),
                     (cfg, cb.function_block),
                     (conv_first, cb.norm_conv_act_pool),
                     (conv_first, F.norm_conv_act_pool),
                     (conv_first, cb.norm_function_block),
                     (cfg, lambda *a, **k: None)):
        params, bn = vgg.init(c, torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="block_order"):
            vgg.apply(c, params, bn, x, 0, block=wrong)
    assert vgg.blocks_for(cfg) == (cb.norm_conv_act_pool,
                                   F.norm_conv_act_pool)
    assert vgg.blocks_for(conv_first) == (cb.conv_bn_act_pool,
                                          F.conv_bn_act_pool)


@pytest.mark.parametrize("change", [
    dict(conv_padding=False, max_pooling=False), dict(conv_padding=False)])
def test_the_rest_of_the_norm_first_models_still_raise(change):
    """The unpadded norm-first models, which raised before the port took
    them (11 -> 5 -> 2 strided, 11 -> 9/4 -> 2/1 pooled): ``vgg.init``
    shapes and ``vgg.apply`` logits and BN state against the JAX
    package."""
    jcfg, cfg = _cfgs(**change)
    params, bn = vgg.init(cfg, torch.Generator().manual_seed(0))
    jparams, jbn = jax_vgg.init(jcfg, jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in jparams.items()}
    assert {k: tuple(v.shape) for k, v in bn.items()} == {
        k: tuple(v.shape) for k, v in jbn.items()}
    host = jax.device_get(jax_maml.init_state(jcfg, seed=0))
    x = np.random.RandomState(2).rand(3, *cfg.im_shape).astype(np.float32)
    jlogits, jnew = jax_vgg.apply(
        jcfg, {k: jnp.asarray(v) for k, v in host.net.items()},
        {k: jnp.asarray(v) for k, v in host.bn.items()}, jnp.asarray(x), 1)
    logits, new = vgg.apply(
        cfg, {k: _t(np.asarray(v)) for k, v in host.net.items()},
        {k: _t(np.asarray(v)) for k, v in host.bn.items()}, _t(x), 1)
    _close(logits, jlogits, VALUE_TOL, "logits")
    for k, v in jnew.items():
        _close(new[k], v, VALUE_TOL, k)


# -- the steps -------------------------------------------------------------------------


def _batch(cfg, b, shots, seed, pad=0):
    """``b`` tasks of pixels in [0, 1] with class-dependent means, and
    ``pad`` all-zero pad tenants; ``valid`` masks the pads."""
    rng = np.random.RandomState(seed)
    n, t = cfg.num_classes_per_set, cfg.num_target_samples
    h, w, c = cfg.im_shape
    means = rng.rand(b, n, 1, 1, 1, 1).astype(np.float32)
    x_s = np.zeros((b + pad, n, shots, h, w, c), np.float32)
    x_t = np.zeros((b + pad, n, t, h, w, c), np.float32)
    x_s[:b] = np.clip(rng.rand(b, n, shots, h, w, c) * 0.5 + means * 0.5,
                      0, 1)
    x_t[:b] = np.clip(rng.rand(b, n, t, h, w, c) * 0.5 + means * 0.5, 0, 1)
    y_s = np.tile(np.arange(n, dtype=np.int32)[None, :, None],
                  (b + pad, 1, shots))
    y_t = np.tile(np.arange(n, dtype=np.int32)[None, :, None],
                  (b + pad, 1, t))
    valid = (np.arange(b + pad) < b).astype(np.float32)
    return x_s, y_s, x_t, y_t, valid


@pytest.mark.parametrize("stats_impl", ["twopass", "fused"])
def test_norm_first_serve_step_matches_jax(stats_impl):
    jcfg, cfg = _cfgs(stats_impl)
    jstate = jax_maml.init_state(jcfg, seed=4)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    batch = _batch(cfg, 2, 2, 3, pad=1)
    _, jout = jax.jit(jax_maml.make_serve_step(jcfg))(
        jstate, *[jnp.asarray(a) for a in batch])
    _, out = maml.make_serve_step(cfg)(state, *[_t(a) for a in batch])
    real = slice(0, 2)
    np.testing.assert_allclose(out["preds"][real].numpy(),
                               np.asarray(jout["preds"])[real], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out["loss"][real], jout["loss"][real],
                               rtol=LOSS_RTOL)
    assert torch.isfinite(out["preds"]).all()


def _assert_grads(got, want):
    for group in ("net", "lslr"):
        assert sorted(got[group]) == sorted(want[group]), group
        for key, w in want[group].items():
            g, w = got[group][key].detach().numpy(), np.asarray(w)
            assert g.shape == w.shape, key
            err = float(np.abs(g - w).max())
            assert err <= GRAD_ATOL + GRAD_RTOL * float(np.abs(w).max()), (
                group, key, err)


@pytest.mark.parametrize("block", ["plain", "functions"])
@pytest.mark.parametrize("max_pooling", [True, False],
                         ids=["pooled", "strided"])
def test_norm_first_second_order_meta_grads_match_jax(max_pooling, block):
    """Second order with MSL weights, on the plain block and on the
    Function block (the card's structure, through the twins here); the
    norm parameters' meta-gradients included."""
    jcfg, cfg = _cfgs(max_pooling=max_pooling)
    jstate = jax_maml.init_state(jcfg, seed=4)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    batch = _batch(cfg, 2, 2, 1)[:4]
    jloss, jgrads = jax.jit(jax_maml.make_grads_fn(jcfg, True))(
        jstate, *[jnp.asarray(a) for a in batch], jnp.asarray(WEIGHTS))
    loss, grads = maml.make_grads_fn(
        cfg, True,
        block=cb.norm_function_block if block == "functions" else None
    )(state, *[_t(a) for a in batch], WEIGHTS)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_grads(grads, jax.device_get(jgrads))
    assert float(grads["net"]["conv0.norm.gamma"].abs().max()) > 0


def test_norm_first_train_step_matches_jax():
    """One second-order MSL train step: loss, accuracy and the merged BN
    statistics (sized to each block's input) against the JAX step; Adam
    moved every trainable leaf."""
    jcfg, cfg = _cfgs()
    jstate = jax_maml.init_state(jcfg, seed=13)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    batch = _batch(cfg, 2, 2, 14)[:4]
    jnew, jmetrics = jax.jit(jax_maml.make_train_step(jcfg, True))(
        jstate, *[jnp.asarray(a) for a in batch], jnp.asarray(WEIGHTS),
        1e-3)
    new, metrics = maml.make_train_step(cfg, True)(
        state, *[_t(a) for a in batch], WEIGHTS, 1e-3)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["accuracy"]),
                               float(jmetrics["accuracy"]), atol=1e-6)
    jbn = jax.device_get(jnew.bn)
    assert sorted(new.bn) == sorted(jbn)
    for key, v in jbn.items():
        np.testing.assert_allclose(new.bn[key].numpy(), v, rtol=0,
                                   atol=1e-5)
    for key, v in new.net.items():
        assert float((v - state.net[key]).abs().max()) > 0, key


# -- the launch formulas ------------------------------------------------------------


@pytest.mark.parametrize("max_pooling", [True, False],
                         ids=["pooled", "strided"])
@pytest.mark.parametrize("second_order,stages,steps,accum", [
    (True, 2, 2, 1), (True, 3, 3, 2), (False, 3, 2, 1), (False, 2, 3, 2)])
def test_chip_smoke_launch_formula_counts_the_norm_first_path(
        monkeypatch, second_order, stages, steps, accum, max_pooling):
    """Every kernel call of a norm-first train step on the Function path,
    counted at the twins, equals the per-step formula ``chip_smoke.py``
    holds the card's counters to; the conv-first kernels run 0 times."""
    cfg = _formula_cfg(stages, steps, accum, max_pooling, "norm_conv_relu")
    want = _chip_smoke().expected_train_launches(cfg, second_order)
    assert want["bn_input_stats"] > 0
    assert want["conv3x3_fwd_stats"] == want["bn_act_pool_fwd"] == 0
    assert _count_function_path(monkeypatch, cfg, second_order) == want


@pytest.mark.parametrize("max_pooling", [True, False],
                         ids=["pooled", "strided"])
def test_chip_smoke_serve_launch_formula_counts_the_norm_first_path(
        monkeypatch, max_pooling):
    cfg = _formula_cfg(3, 2, 1, max_pooling, "norm_conv_relu")
    want = _chip_smoke().expected_launches(cfg)
    assert _count_function_path(monkeypatch, cfg, False, serve=True) == want


# -- the benches ------------------------------------------------------------------------


def test_benches_take_block_order_norm_conv_relu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve = serve_bench.run(["--fast", "--device", "cpu", "--requests",
                                 "3", "--block_order", "norm_conv_relu",
                                 "--ingest", "index"])
        train = bench.run(["--fast", "--device", "cpu", "--warmup", "0",
                           "--steps", "2", "--block_order",
                           "norm_conv_relu", "--max_pooling", "false"])
    assert serve["block_order"] == train["block_order"] == "norm_conv_relu"
    assert train["max_pooling"] is False
    assert serve["tenants"] == 3 and all(np.isfinite(train["loss"]))
    assert {v for d in serve["kernel_launches_per_dispatch"]
            for v in d.values()} == {0}
    assert {v for step in train["kernel_launches_per_step"]
            for v in step.values()} == {0}
    with pytest.raises(SystemExit):
        bench._parser().parse_args(["--block_order", "conv_relu_norm"])
