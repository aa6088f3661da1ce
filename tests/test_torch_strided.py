"""The strided model (``max_pooling=False``: stride-2 convs, no pool, a
global average pool into the head) of the port held to the JAX package on
the CPU, module by module and as a whole:

* ``global_avg_pool2d`` and its gradient against ``jnp.mean`` /
  ``jax.vjp``;
* the stride-2 conv twins (forward with statistics, dgrad, wgrad) against
  JAX ``_conv2d_raw(stride=2, padding=1)`` and its ``jax.vjp``, at even
  and odd sizes (8 -> 4, 7 -> 4, 5 -> 3), cin 1 and 4;
* the pool-free BN/act twins (K2, K3, K5 without the pool) against
  autograd of JAX ``batch_norm`` + ``leaky_relu``;
* f64 ``gradcheck`` / ``gradgradcheck`` of the Functions at stride 2 and
  pool-free (``Conv3x3``, ``Dgrad``, ``Wgrad``, the block, ``Gap`` /
  ``GapBwd``), run on the twins as ``test_torch_double_backward.py`` does;
* ``vgg.apply`` at the geometry of the JAX suite's ``tiny_cfg`` (14x14x1,
  2 stages, 6 filters), plain and with the tenant axis;
* ``make_serve_step`` and a second-order MSL ``make_grads_fn`` /
  ``make_train_step`` against the JAX package at that geometry, with the
  weights carried by ``state.from_numpy``; the strided model's state
  (with its Adam moments) round-trips at Omniglot's full width;
* ``serve-bench`` and ``train-bench --max_pooling false`` on the CPU.

Inputs are made from numpy seeds; JAX runs on the CPU as its own tests
run it. Tolerances (those of ``test_torch_train.py``): logits ``1e-5`` of
their scale; a meta-gradient leaf within ``1e-6 + 1e-4 * max|jax leaf|``;
the loss within rtol ``1e-4``; the twins' forward values ``1e-5`` and
their gradients ``1e-4`` of their scale (f32, sums in another order).
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

torch.set_num_threads(2)

VALUE_TOL = 1e-5
GRAD_TOL = 1e-4
GRAD_ATOL = 1e-6
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-4
WEIGHTS = np.asarray([0.4, 0.6], np.float32)
OMNIGLOT = "experiment_config/omniglot_maml++-omniglot_1_20_8_0.1_64_0.json"


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


def _cfgs(stats_impl="twopass", **extra):
    """``tiny_cfg``'s geometry (the JAX suite's conftest): 14x14x1, 4-way
    1-shot, 2 targets, 2 stages of 6 filters, strided, MAML++ on."""
    kw = dict(
        dataset_name="omniglot_dataset", image_height=14, image_width=14,
        image_channels=1, num_classes_per_set=4, num_samples_per_class=1,
        num_target_samples=2, batch_size=2, cnn_num_filters=6, num_stages=2,
        max_pooling=False, conv_padding=True, per_step_bn_statistics=True,
        learnable_per_layer_per_step_inner_loop_learning_rate=True,
        use_multi_step_loss_optimization=True, second_order=True,
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2, use_remat=False,
        task_learning_rate=0.1, bn_stats_impl=stats_impl,
        serving_bucket_ladder=[1, 2, 4], serving_max_tenants_per_dispatch=4,
    )
    kw.update(extra)
    return JaxConfig(**kw), MAMLConfig(**kw)


# -- global average pool --------------------------------------------------------


@pytest.mark.parametrize("hw", [(2, 2), (3, 5)])
def test_global_avg_pool2d_and_its_gradient_match_jax(hw):
    rng = np.random.RandomState(sum(hw))
    T, N, C = 2, 3, 5
    x = rng.randn(T, N, *hw, C).astype(np.float32)
    ct = rng.randn(T, N, C).astype(np.float32)

    def jfn(xi):  # one tenant, as vgg.apply reshapes it
        out = JF.global_avg_pool2d(xi)
        return out.reshape(out.shape[0], -1)

    jout, vjp = jax.vjp(jax.vmap(jfn), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(ct))
    xt = _t(x).requires_grad_(True)
    out = F.global_avg_pool2d(xt)
    _close(out, jout, VALUE_TOL, "gap")
    (dx,) = torch.autograd.grad(out, xt, _t(ct))
    _close(dx, jdx, VALUE_TOL, "gap grad")
    _close(F.global_avg_pool2d_bwd(_t(ct), *hw), jdx, VALUE_TOL, "gap twin")
    # the wrappers take the twins on the CPU and count no launch
    cb.reset_launches()
    _close(cb.global_avg_pool2d_fwd(_t(x)), jout, VALUE_TOL, "gap wrapper")
    _close(cb.global_avg_pool2d_bwd(_t(ct), *hw), jdx, VALUE_TOL,
           "gap bwd wrapper")
    assert set(cb.launches().values()) == {0}


# -- stride-2 conv twins ----------------------------------------------------------


@pytest.mark.parametrize("cin", [1, 4])
@pytest.mark.parametrize("hw", [8, 7, 5])
def test_stride2_conv_twins_match_jax(hw, cin):
    """K1 (with statistics, and stats-free), dgrad and wgrad at stride 2:
    8 -> 4 (the top pad row read, the bottom one never), 7 -> 4 (the last
    output row's bottom tap reads the pad row below the image), 5 -> 3."""
    rng = np.random.RandomState(hw * 10 + cin)
    T, N, cout = 2, 3, 5
    x = rng.randn(T, N, hw, hw, cin).astype(np.float32)
    w = (rng.randn(T, 3, 3, cin, cout) * 0.3).astype(np.float32)
    b = (rng.randn(T, cout) * 0.1).astype(np.float32)

    def conv(xi, wi, bi):
        return JF._conv2d_raw(xi, wi, bi, 2, 1, "lax", "off")

    jy, vjp = jax.vjp(jax.vmap(conv), *(jnp.asarray(a) for a in (x, w, b)))
    ho = (hw - 1) // 2 + 1
    assert jy.shape == (T, N, ho, ho, cout)
    dy = rng.randn(*jy.shape).astype(np.float32)
    jdx, jdw, jdb = vjp(jnp.asarray(dy))
    y, mean, var, rstd = F.conv3x3_fwd_stats(_t(x), _t(w), _t(b), stride=2)
    _close(y, jy, VALUE_TOL, "y")
    _close(F.conv3x3(_t(x), _t(w), _t(b), stride=2), jy, VALUE_TOL,
           "stats-free y")
    jyn = np.asarray(jy, np.float64)
    _close(mean, jyn.mean((1, 2, 3)), VALUE_TOL, "mean")
    _close(var, jyn.var((1, 2, 3)), VALUE_TOL, "var")
    _close(rstd, 1 / np.sqrt(jyn.var((1, 2, 3)) + F.BN_EPS), VALUE_TOL,
           "rstd")
    dx = F.conv3x3_dgrad(_t(dy), _t(w), stride=2, in_hw=(hw, hw))
    _close(dx, jdx, GRAD_TOL, "dgrad")
    dw, db = F.conv3x3_wgrad(_t(x), _t(dy), stride=2)
    _close(dw, jdw, GRAD_TOL, "wgrad dw")
    _close(db, jdb, GRAD_TOL, "wgrad db")
    # the wrappers take these twins on the CPU
    cb.reset_launches()
    _close(cb.conv3x3_dgrad(_t(dy), _t(w), 2, (hw, hw)), jdx, GRAD_TOL,
           "dgrad wrapper")
    assert set(cb.launches().values()) == {0}


def test_stride2_dgrad_needs_the_input_size():
    dy = torch.zeros(1, 1, 4, 4, 2)
    w = torch.zeros(1, 3, 3, 3, 2)
    with pytest.raises(ValueError, match="not the stride-2 output"):
        F.conv3x3_dgrad(dy, w, stride=2, in_hw=(9, 9))
    assert F.conv3x3_dgrad(dy, w, 2, (7, 7)).shape == (1, 1, 7, 7, 3)
    assert F.conv3x3_dgrad(dy, w, 2, (8, 8)).shape == (1, 1, 8, 8, 3)


# -- pool-free BN + leaky-ReLU twins ---------------------------------------------


def _bn_inputs(seed, shape=(2, 3, 4, 3, 5)):
    rng = np.random.RandomState(seed)
    T, C = shape[0], shape[-1]
    return (rng.randn(*shape).astype(np.float32),
            (1 + 0.3 * rng.randn(T, C)).astype(np.float32),
            (0.2 * rng.randn(T, C)).astype(np.float32), rng)


def _jax_bn_act(y, gamma, beta):
    """JAX batch_norm (batch statistics) + leaky_relu of one tenant."""
    out, _, _ = JF.batch_norm(y, gamma, beta, None, None)
    return JF.leaky_relu(out)


def test_pool_free_bn_act_twins_match_jax():
    """K2, K3 and K5 without the pool against JAX: the forward, its vjp
    (dy, dgamma, dbeta from da) and the vjp of that vjp (g_da, g_y,
    g_gamma from the cotangents of dy, dgamma, dbeta)."""
    y, gamma, beta, rng = _bn_inputs(0)
    da = rng.randn(*y.shape).astype(np.float32)
    a = rng.randn(*y.shape).astype(np.float32)
    gg, gb = (rng.randn(*gamma.shape).astype(np.float32) for _ in range(2))

    def first(y, gamma, beta, da):
        out, vjp = jax.vjp(jax.vmap(_jax_bn_act), y, gamma, beta)
        return out, vjp(da)

    jout, (jdy, jdg, jdb) = first(*(jnp.asarray(v) for v in
                                    (y, gamma, beta, da)))
    _, vjp2 = jax.vjp(lambda y, g, d: first(y, g, jnp.asarray(beta), d)[1],
                      *(jnp.asarray(v) for v in (y, gamma, da)))
    jg_y, jg_gamma, jg_da = vjp2(tuple(jnp.asarray(v) for v in (a, gg, gb)))

    mean, _, rstd = F.bn_stats(_t(y))
    args = (_t(y), mean, rstd, _t(gamma), _t(beta))
    _close(F.bn_act_fwd(*args), jout, VALUE_TOL, "bn_act_fwd")
    dy, dg, db = F.bn_act_bwd(_t(da), *args)
    for got, want, what in ((dy, jdy, "dy"), (dg, jdg, "dgamma"),
                            (db, jdb, "dbeta")):
        _close(got, want, GRAD_TOL, what)
    g_da, g_y, g_gamma = F.bn_act_bwd_bwd(_t(a), _t(gg), _t(gb), _t(da),
                                          *args)
    for got, want, what in ((g_da, jg_da, "g_da"), (g_y, jg_y, "g_y"),
                            (g_gamma, jg_gamma, "g_gamma")):
        _close(got, want, GRAD_TOL, what)


def test_pool_free_k5_twin_matches_autograd_of_the_k3_twin():
    y, gamma, beta, rng = _bn_inputs(1)
    y, gamma, beta = (_t(v).double().requires_grad_(True)
                      for v in (y, gamma, beta))
    da = torch.from_numpy(rng.randn(*y.shape)).requires_grad_(True)
    mean, _, rstd = F.bn_stats(y)
    outs = F.bn_act_bwd(da, y, mean, rstd, gamma, beta)
    cts = [torch.from_numpy(rng.randn(*o.shape)) for o in outs]
    want = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(outs, cts)), [da, y, gamma, beta],
        allow_unused=True)
    m, _, r = F.bn_stats(y.detach())
    got = F.bn_act_bwd_bwd(*cts, da.detach(), y.detach(), m, r,
                           gamma.detach(), beta.detach())
    for g, w_, what in zip(got, want, ("da", "y", "gamma")):
        torch.testing.assert_close(g, w_, rtol=0, atol=1e-10, msg=what)
    assert want[3] is None or float(want[3].abs().max()) == 0.0


# -- the Functions at stride 2, pool-free, f64 -------------------------------------

# T, N, H, W, cin, cout: odd H (7 -> 4) and even W (6 -> 3)
SHAPE = (2, 2, 7, 6, 2, 3)


def _f64(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.randn(*shape) * scale).requires_grad_(True)


def _block_inputs(seed=0, shape=SHAPE):
    T, N, H, W, cin, cout = shape
    rng = np.random.RandomState(seed)
    return (_f64(rng, T, N, H, W, cin),
            _f64(rng, T, 3, 3, cin, cout, scale=0.4),
            _f64(rng, T, cout, scale=0.1),
            torch.from_numpy(1 + 0.2 * rng.randn(T, cout)).requires_grad_(),
            _f64(rng, T, cout, scale=0.1))


@pytest.mark.parametrize("gap", [False, True], ids=["no_gap", "gap"])
def test_strided_function_block_gradcheck_and_gradgradcheck(gap):
    inputs = _block_inputs()

    def block(*a):
        return cb.function_block(*a, stride=2, pool=False, gap=gap)[0]

    assert gradcheck(block, inputs)
    assert gradgradcheck(block, inputs)


def test_stride2_conv_functions_gradcheck_and_gradgradcheck():
    """The conv closure at stride 2: stats-free conv, dgrad and wgrad are
    each other's derivatives, to any order."""
    x, w, b, _, _ = _block_inputs(1)
    T, N, H, W, _, cout = SHAPE
    ho, wo = F.conv_out_hw(H, W, 2)
    dy = _f64(np.random.RandomState(2), T, N, ho, wo, cout)
    cases = [
        (lambda x, w, b: cb.Conv3x3.apply(x, w, b, False, 2), (x, w, b)),
        (lambda dy, w: cb.Dgrad.apply(dy, w, 2, (H, W)), (dy, w)),
        (lambda x, dy: cb.Wgrad.apply(x, dy, 2), (x, dy)),
    ]
    for fn, args in cases:
        assert gradcheck(fn, args)
        assert gradgradcheck(fn, args)


def test_pool_free_bn_act_bwd_gradcheck_and_gradgradcheck():
    """``BnActPoolBwd`` in the pool-free mode (no argmax) as a function of
    (da, y, gamma, beta), its statistics recomputed from y."""
    rng = np.random.RandomState(3)
    T, N, H, W, C = 2, 2, 3, 4, 3
    y = _f64(rng, T, N, H, W, C)
    gamma = torch.from_numpy(1 + 0.3 * rng.randn(T, C)).requires_grad_()
    beta = _f64(rng, T, C, scale=0.2)
    da = _f64(rng, T, N, H, W, C)

    def k3(da, y, gamma, beta):
        mean, _, rstd = F.bn_stats(y.detach())
        return cb.BnActPoolBwd.apply(da, None, y, mean, rstd, gamma, beta)

    assert gradcheck(k3, (da, y, gamma, beta))
    assert gradgradcheck(k3, (da, y, gamma, beta))


def test_gap_functions_gradcheck_and_gradgradcheck():
    rng = np.random.RandomState(4)
    x = _f64(rng, 2, 3, 2, 3, 4)
    g = _f64(rng, 2, 3, 4)
    assert gradcheck(cb.Gap.apply, (x,))
    assert gradgradcheck(cb.Gap.apply, (x,))
    assert gradcheck(lambda g: cb.GapBwd.apply(g, 2, 3), (g,))
    assert gradgradcheck(lambda g: cb.GapBwd.apply(g, 2, 3), (g,))


def test_strided_block_second_derivative_matches_plain_autograd():
    """A scalar function of the strided block's first gradients (global
    average pool included), differentiated again: the Function block
    equals autograd of the plain block."""
    results = []
    for fn in (cb.function_block, F.conv_bn_act_pool):
        x, w, b, gamma, beta = _block_inputs(6, (2, 3, 9, 8, 3, 4))
        out, _, _ = fn(x, w, b, gamma, beta, stride=2, pool=False, gap=True)
        ct = torch.from_numpy(np.random.RandomState(7).randn(*out.shape))
        first = torch.autograd.grad((out * ct).sum(), [x, w, b, gamma],
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


# -- the model -----------------------------------------------------------------------


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


@pytest.mark.parametrize("block", ["plain", "functions"])
@pytest.mark.parametrize("step", [0, 1, 3])
def test_strided_apply_matches_jax(step, block):
    """Logits, the new BN state and d(logits . ct)/dparams at every step
    index (3 clamps to the last), on the plain block and on the Function
    block (its wrappers take the twins on the CPU)."""
    jcfg, cfg = _cfgs()
    net, bn = _state(jcfg)
    rng = np.random.RandomState(step)
    x = rng.randn(5, 14, 14, 1).astype(np.float32)
    ct = rng.randn(5, 4).astype(np.float32)

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
        block=cb.function_block if block == "functions" else None)
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


def test_strided_apply_tenant_axis_matches_jax_vmap():
    jcfg, cfg = _cfgs()
    net, bn = _state(jcfg, seed=1)
    rng = np.random.RandomState(7)
    T = 3
    adapted = {k for k in net if jax_partition.is_inner_adapted(jcfg, k)}
    tnet = {k: (v[None] + 0.05 * rng.randn(T, *v.shape)).astype(np.float32)
            if k in adapted else v for k, v in net.items()}
    x = rng.randn(T, 4, 14, 14, 1).astype(np.float32)

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


# -- the steps -------------------------------------------------------------------------


def _batch(cfg, b, shots, seed, pad=0):
    """``b`` tasks (class-dependent means, so adaptation matters) and
    ``pad`` all-zero pad tenants; ``valid`` masks the pads."""
    rng = np.random.RandomState(seed)
    n, t = cfg.num_classes_per_set, cfg.num_target_samples
    h, w, c = cfg.im_shape
    means = rng.randn(b, n, 1, 1, 1, 1).astype(np.float32)
    x_s = np.zeros((b + pad, n, shots, h, w, c), np.float32)
    x_t = np.zeros((b + pad, n, t, h, w, c), np.float32)
    x_s[:b] = rng.randn(b, n, shots, h, w, c) * 0.5 + means
    x_t[:b] = rng.randn(b, n, t, h, w, c) * 0.5 + means
    y_s = np.tile(np.arange(n, dtype=np.int32)[None, :, None],
                  (b + pad, 1, shots))
    y_t = np.tile(np.arange(n, dtype=np.int32)[None, :, None],
                  (b + pad, 1, t))
    valid = (np.arange(b + pad) < b).astype(np.float32)
    return x_s, y_s, x_t, y_t, valid


@pytest.mark.parametrize("stats_impl", ["twopass", "fused"])
def test_strided_serve_step_matches_jax(stats_impl):
    jcfg, cfg = _cfgs(stats_impl)
    jstate = jax_maml.init_state(jcfg, seed=4)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    batch = _batch(cfg, 2, 1, 3, pad=1)
    _, jout = jax.jit(jax_maml.make_serve_step(jcfg))(
        jstate, *[jnp.asarray(a) for a in batch])
    _, out = maml.make_serve_step(cfg)(state, *[_t(a) for a in batch])
    real = slice(0, 2)
    np.testing.assert_allclose(out["preds"][real].numpy(),
                               np.asarray(jout["preds"])[real], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out["loss"][real], jout["loss"][real],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(out["metrics"]["loss"]),
                               float(jout["metrics"]["loss"]),
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
def test_strided_second_order_meta_grads_match_jax(block):
    """Second order with MSL weights, on the plain block and on the
    Function block (the card's structure, through the twins here)."""
    jcfg, cfg = _cfgs()
    jstate = jax_maml.init_state(jcfg, seed=4)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    batch = _batch(cfg, 2, 1, 1)[:4]
    jloss, jgrads = jax.jit(jax_maml.make_grads_fn(jcfg, True))(
        jstate, *[jnp.asarray(a) for a in batch], jnp.asarray(WEIGHTS))
    loss, grads = maml.make_grads_fn(
        cfg, True, block=cb.function_block if block == "functions" else None
    )(state, *[_t(a) for a in batch], WEIGHTS)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_grads(grads, jax.device_get(jgrads))


def test_strided_train_step_matches_jax():
    """One second-order MSL train step: loss, accuracy and the merged BN
    statistics against the JAX step; Adam moved every trainable leaf."""
    jcfg, cfg = _cfgs()
    jstate = jax_maml.init_state(jcfg, seed=13)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    batch = _batch(cfg, 2, 1, 14)[:4]
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


def test_strided_state_round_trips_at_omniglot_width():
    """The strided Omniglot 20-way model's state, Adam moments included,
    crosses from the JAX package leaf by leaf: ``linear.weight`` (64, 20)
    (the pooled features), per-step BN (5, 64)."""
    jcfg = JaxConfig.from_json_file(OMNIGLOT, max_pooling=False)
    host = jax.device_get(jax_maml.init_state(jcfg, seed=0))
    state = state_lib.from_numpy(host, device="cpu")
    assert tuple(state.net["linear.weight"].shape) == (64, 20)
    assert tuple(state.net["conv3.norm.gamma"].shape) == (5, 64)
    assert tuple(state.bn["conv3.norm.mean"].shape) == (5, 64)
    cfg = MAMLConfig.from_json_file(OMNIGLOT, max_pooling=False)
    assert vgg.feature_dim(cfg) == jax_vgg.feature_dim(jcfg) == 64
    assert list(vgg._stage_dims(cfg)) == list(jax_vgg._stage_dims(jcfg))
    back = state_lib.to_numpy(state)
    for name in ("net", "lslr", "bn"):
        for key, v in getattr(host, name).items():
            np.testing.assert_array_equal(getattr(back, name)[key], v)
    jadam = state_lib._adam_of(host.opt)
    assert int(state.opt.count) == int(jadam.count)
    for name in ("mu", "nu"):
        for group, part in getattr(jadam, name).items():
            for key, v in part.items():
                if hasattr(v, "shape"):
                    np.testing.assert_array_equal(
                        getattr(back.opt, name)[group][key], v)


# -- the benches ------------------------------------------------------------------------


def test_benches_take_max_pooling_false():
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve = serve_bench.run(["--fast", "--device", "cpu", "--requests",
                                 "3", "--max_pooling", "false", "--ingest",
                                 "index"])
        train = bench.run(["--fast", "--device", "cpu", "--warmup", "0",
                           "--steps", "2", "--max_pooling", "False"])
    assert serve["max_pooling"] is False and train["max_pooling"] is False
    assert serve["tenants"] == 3 and serve["store_rows"] > 0
    assert all(np.isfinite(train["loss"]))
    assert {v for d in serve["kernel_launches_per_dispatch"]
            for v in d.values()} == {0}
    assert {v for step in train["kernel_launches_per_step"]
            for v in step.values()} == {0}
    with pytest.raises(SystemExit):
        bench._parser().parse_args(["--max_pooling", "maybe"])
