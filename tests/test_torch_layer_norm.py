"""The layer-norm model (``norm_layer='layer_norm'``: a layer norm over each
image's (H, W, C) in place of the batch norm, in both block orders) of the
port held to the JAX package on the CPU, module by module and as a whole:

* the twins: ``F.layer_norm`` and ``layer_norm_stats`` +
  ``layer_norm_fwd`` against JAX ``layer_norm`` at odd sizes with random
  gamma and beta; ``layer_norm_bwd`` against ``jax.vjp`` of it (dx,
  dgamma, dbeta); ``layer_norm_bwd_bwd`` against autograd of plain layer
  norm in f64;
* f64 ``gradcheck`` / ``gradgradcheck`` of ``LayerNorm``,
  ``LayerNormBwd`` and both layer-norm Function blocks (pooled, and
  strided with the global average pool), their second derivative against
  plain autograd, and the third derivative raising;
* ``vgg.init`` shapes against the JAX ``init`` in both orders and both
  geometries (``(H, W, C)`` leaves, an empty BN state), the state round
  trip, ``vgg.apply`` against JAX ``apply`` at steps 0, 2 and a clamped 5
  with ``per_step_bn_statistics=True`` (the per-step BN indexing must not
  touch a layer norm's leaves), and the tenant axis against ``jax.vmap``
  with ``enable_inner_loop_optimizable_bn_params=True`` (beta adapted,
  carrying T);
* ``make_serve_step``, second-order ``make_grads_fn`` (every leaf, the
  frozen gamma and the trained beta included) and one ``make_train_step``
  against the JAX package;
* the launch formulas ``chip_smoke.py`` holds the card to, by counting
  the twins; a block of the other norm layer raises;
* ``serve-bench`` and ``train-bench --norm_layer layer_norm`` on the CPU.

Inputs are made from numpy seeds; JAX runs on the CPU as its own tests
run it. Tolerances (those of ``test_torch_norm_first.py``): values
``1e-5`` of their scale, gradients ``1e-4``; a meta-gradient leaf within
``1e-6 + 1e-4 * max|jax leaf|``; the loss within rtol ``1e-4`` (f32, sums
in another order).
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
LAYER_NORM = dict(norm_layer="layer_norm")
ORDERS = ["conv_norm_relu", "norm_conv_relu"]
FUNCTION_BLOCKS = {"conv_norm_relu": cb.conv_ln_function_block,
                   "norm_conv_relu": cb.ln_conv_function_block}


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


def _cfgs(block_order="conv_norm_relu", max_pooling=True, hw=11, **extra):
    """A small layer-norm model: 11x11x3 (pooled 11 -> 5 -> 2, dropping a
    row and a column; strided 11 -> 6 -> 3), 3-way 2-shot, 2 targets, 2
    stages of 6 filters, MAML++ on with per-step BN statistics (which a
    layer norm does not keep)."""
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
        task_learning_rate=0.1, block_order=block_order,
        serving_bucket_ladder=[1, 2, 4], serving_max_tenants_per_dispatch=4,
        **LAYER_NORM,
    )
    kw.update(extra)
    return JaxConfig(**kw), MAMLConfig(**kw)


# -- the twins ------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 5, 7, 4), (2, 1, 1, 6), (4, 9, 6, 1)],
                         ids=str)
def test_layer_norm_twins_match_jax(shape):
    """``F.layer_norm`` of (N, H, W, C) with shared (H, W, C) gamma and
    beta, and of (T, N, H, W, C) with per-tenant ones against ``jax.vmap``;
    ``layer_norm_stats`` (each image's mean, population variance and rstd)
    and ``layer_norm_fwd`` against the same. Pixels offset from 0, so a
    sum-of-squares variance would cancel."""
    rng = np.random.RandomState(sum(shape))
    T = 2
    x = (2.0 + rng.rand(T, *shape)).astype(np.float32)
    gamma = (1 + 0.3 * rng.randn(T, *shape[1:])).astype(np.float32)
    beta = (0.2 * rng.randn(T, *shape[1:])).astype(np.float32)
    want = np.asarray(JF.layer_norm(jnp.asarray(x[0]), jnp.asarray(gamma[0]),
                                    jnp.asarray(beta[0])))
    _close(F.layer_norm(_t(x[0]), _t(gamma[0]), _t(beta[0])), want,
           VALUE_TOL, "layer_norm 4-D")
    jy = jax.vmap(JF.layer_norm)(*(jnp.asarray(a) for a in (x, gamma, beta)))
    _close(F.layer_norm(_t(x), _t(gamma), _t(beta)), jy, VALUE_TOL,
           "layer_norm per tenant")
    mean, var, rstd = F.layer_norm_stats(_t(x))
    xn = x.astype(np.float64)
    _close(mean, xn.mean((2, 3, 4)), VALUE_TOL, "mean")
    _close(var, xn.var((2, 3, 4)), VALUE_TOL, "var")
    _close(rstd, 1 / np.sqrt(xn.var((2, 3, 4)) + F.LN_EPS), VALUE_TOL,
           "rstd")
    _close(F.layer_norm_fwd(_t(x), mean, rstd, _t(gamma), _t(beta)), jy,
           VALUE_TOL, "layer_norm_fwd")
    # the wrappers take these twins on the CPU and count no launch
    cb.reset_launches()
    _close(cb.layer_norm_fwd(_t(x), *cb.layer_norm_stats(_t(x))[::2],
                             _t(gamma), _t(beta)), jy, VALUE_TOL, "wrappers")
    assert set(cb.launches().values()) == {0}


def test_layer_norm_bwd_twin_matches_jax_vjp():
    """``layer_norm_bwd`` against ``jax.vjp`` of JAX ``layer_norm`` per
    tenant: dx through the statistics, and dgamma / dbeta summed over the
    tenant's images."""
    rng = np.random.RandomState(4)
    T, N, H, W, C = 2, 3, 5, 3, 4
    x = rng.randn(T, N, H, W, C).astype(np.float32)
    gamma = (1 + 0.3 * rng.randn(T, H, W, C)).astype(np.float32)
    beta = (0.2 * rng.randn(T, H, W, C)).astype(np.float32)
    dz = rng.randn(T, N, H, W, C).astype(np.float32)
    _, vjp = jax.vjp(jax.vmap(JF.layer_norm),
                     *(jnp.asarray(a) for a in (x, gamma, beta)))
    want = vjp(jnp.asarray(dz))
    mean, _, rstd = F.layer_norm_stats(_t(x))
    got = F.layer_norm_bwd(_t(dz), _t(x), mean, rstd, _t(gamma))
    for g, w_, what in zip(got, want, ("dx", "dgamma", "dbeta")):
        _close(g, w_, GRAD_TOL, what)


def test_layer_norm_bwd_bwd_twin_matches_autograd_in_f64():
    """``layer_norm_bwd`` is autograd's backward of plain layer norm, and
    ``layer_norm_bwd_bwd`` autograd's backward of that, in dz, x and
    gamma (f64)."""
    rng = np.random.RandomState(3)
    T, N, H, W, C = 2, 3, 4, 5, 3
    x = torch.from_numpy(rng.randn(T, N, H, W, C)).requires_grad_(True)
    gamma = torch.from_numpy(1 + 0.3 * rng.randn(T, H, W, C))
    gamma.requires_grad_(True)
    beta = torch.from_numpy(0.2 * rng.randn(T, H, W, C)).requires_grad_(True)
    dz = torch.from_numpy(rng.randn(T, N, H, W, C)).requires_grad_(True)
    want = torch.autograd.grad(F.layer_norm(x, gamma, beta),
                               [x, gamma, beta], dz, create_graph=True)
    mean, _, rstd = F.layer_norm_stats(x.detach())
    got = F.layer_norm_bwd(dz.detach(), x.detach(), mean, rstd,
                           gamma.detach())
    for g, w_, what in zip(got, want, ("dx", "dgamma", "dbeta")):
        torch.testing.assert_close(g, w_.detach(), rtol=0, atol=1e-10,
                                   msg=what)
    cts = [torch.from_numpy(rng.randn(*o.shape)) for o in want]
    want2 = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(want, cts)), [dz, x, gamma])
    got2 = F.layer_norm_bwd_bwd(*cts, dz.detach(), x.detach(), mean, rstd,
                                gamma.detach())
    for g, w_, what in zip(got2, want2, ("g_dz", "g_x", "g_gamma")):
        torch.testing.assert_close(g, w_, rtol=0, atol=1e-10, msg=what)


# -- the Functions, f64 ----------------------------------------------------------


def _f64(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.randn(*shape) * scale).requires_grad_(True)


def test_layer_norm_functions_gradcheck_and_gradgradcheck():
    """``LayerNorm`` (statistics, normalize) and ``LayerNormBwd`` (its
    backward, whose own backward is ``layer_norm_bwd_bwd``), f64."""
    rng = np.random.RandomState(1)
    T, N, H, W, C = 2, 2, 3, 2, 3
    x = _f64(rng, T, N, H, W, C)
    gamma = torch.from_numpy(1 + 0.3 * rng.randn(T, H, W, C))
    gamma.requires_grad_(True)
    beta = _f64(rng, T, H, W, C, scale=0.2)
    dz = _f64(rng, T, N, H, W, C)

    def ln(x, gamma, beta):
        return cb.LayerNorm.apply(x, gamma, beta)

    def ln_bwd(dz, x, gamma):
        mean, _, rstd = F.layer_norm_stats(x.detach())
        return cb.LayerNormBwd.apply(dz, x, mean, rstd, gamma)

    assert gradcheck(ln, (x, gamma, beta))
    assert gradgradcheck(ln, (x, gamma, beta))
    assert gradcheck(ln_bwd, (dz, x, gamma))
    assert gradgradcheck(ln_bwd, (dz, x, gamma))


def _block_inputs(order, kw, seed=0, shape=(2, 2, 7, 6, 3, 4)):
    """x, w, b, a shared (H, W, C) gamma and a per-tenant beta, sized to
    the normalized tensor (the conv output, or the block input)."""
    T, N, H, W, cin, cout = shape
    if order == "conv_norm_relu":
        hw = F.conv_out_hw(H, W, kw.get("stride", 1))
        c = cout
    else:
        hw, c = (H, W), cin
    rng = np.random.RandomState(seed)
    return (_f64(rng, T, N, H, W, cin),
            _f64(rng, T, 3, 3, cin, cout, scale=0.4),
            _f64(rng, T, cout, scale=0.1),
            torch.from_numpy(1 + 0.2 * rng.randn(*hw, c)).requires_grad_(),
            _f64(rng, T, *hw, c, scale=0.1))


BLOCK_CASES = [dict(), dict(stride=2, pool=False, gap=True)]


@pytest.mark.parametrize("kw", BLOCK_CASES, ids=["pooled", "strided_gap"])
@pytest.mark.parametrize("order", ORDERS)
def test_layer_norm_function_blocks_gradcheck_and_gradgradcheck(order, kw):
    inputs = _block_inputs(order, kw)

    def block(*a):
        return FUNCTION_BLOCKS[order](*a, **kw)[0]

    assert gradcheck(block, inputs)
    assert gradgradcheck(block, inputs)


@pytest.mark.parametrize("kw", BLOCK_CASES, ids=["pooled", "strided_gap"])
@pytest.mark.parametrize("order", ORDERS)
def test_layer_norm_block_second_derivative_matches_plain_autograd(order,
                                                                  kw):
    """A scalar function of the block's first gradients, differentiated
    again: the Function block equals autograd of the plain block; both
    return no running statistics."""
    plain = (F.conv_ln_act_pool if order == "conv_norm_relu"
             else F.ln_conv_act_pool)
    results = []
    for fn in (FUNCTION_BLOCKS[order], plain):
        leaves = _block_inputs(order, kw, 6, (2, 3, 9, 8, 3, 4))
        out, mean, var = fn(*leaves, **kw)
        assert mean is None and var is None
        ct = torch.from_numpy(np.random.RandomState(7).randn(*out.shape))
        first = torch.autograd.grad((out * ct).sum(), leaves,
                                    create_graph=True)
        scalar = sum((g * g).sum() for g in first)
        results.append(torch.autograd.grad(scalar, leaves,
                                           allow_unused=True))
    for got, want, what in zip(*results, ("x", "w", "b", "gamma", "beta")):
        if want is None:
            assert got is None or float(got.abs().max()) == 0.0, what
            continue
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9,
                                   msg=what)


def test_third_derivative_of_the_layer_norm_block_raises():
    """``layer_norm_bwd_bwd``'s own derivative is not written: on the card
    its graph node raises rather than treating its outputs as
    constants."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 2, 4, 4, 3).astype(np.float32))
    x.requires_grad_(True)
    g, be = torch.ones(1, 4, 4, 3), torch.zeros(1, 4, 4, 3)
    mean, _, rstd = F.layer_norm_stats(x.detach())
    outs = cb.LayerNormBwdBwd.apply(torch.ones_like(x), g, be,
                                    torch.ones_like(x), x, mean, rstd, g)
    with pytest.raises(NotImplementedError, match="third derivative"):
        outs[1].sum().backward()


# -- the model ---------------------------------------------------------------------


def _state(jcfg, seed=0):
    """The JAX package's initial state with the norm leaves moved off 1
    and 0, so that a wrong gamma or beta shows."""
    host = jax.device_get(jax_maml.init_state(jcfg, seed=seed))
    rng = np.random.RandomState(seed + 10)
    net = {k: np.array(v) for k, v in host.net.items()}
    for k in net:
        if ".norm." in k:
            net[k] = (net[k] + 0.1 * rng.randn(*net[k].shape)).astype(
                np.float32)
    return net


@pytest.mark.parametrize("max_pooling", [True, False],
                         ids=["pooled", "strided"])
@pytest.mark.parametrize("order", ORDERS)
def test_layer_norm_init_matches_jax_and_round_trips(order, max_pooling):
    """The norm leaves take the (H, W, C) of the normalized tensor (the
    conv output conv-first, the block input norm-first), in both
    geometries, at the mini-ImageNet and Omniglot widths too; no BN state;
    the JAX state crosses leaf by leaf and back."""
    pairs = [_cfgs(order, max_pooling)]
    for path in (FLAGSHIP, OMNIGLOT):
        extra = dict(max_pooling=max_pooling, block_order=order,
                     **LAYER_NORM)
        pairs.append((JaxConfig.from_json_file(path, **extra),
                      MAMLConfig.from_json_file(path, **extra)))
    for jcfg, cfg in pairs:
        params, bn = vgg.init(cfg, torch.Generator().manual_seed(0))
        jparams, jbn = jax_vgg.init(jcfg, jax.random.PRNGKey(0))
        assert {k: tuple(v.shape) for k, v in params.items()} == {
            k: tuple(v.shape) for k, v in jparams.items()}
        assert bn == {} and jbn == {}
        h, w, c = cfg.im_shape
        if order == "norm_conv_relu":
            want = (h, w, c)
        else:
            want = (*F.conv_out_hw(h, w, 1 if max_pooling else 2),
                    cfg.cnn_num_filters)
        assert tuple(params["conv0.norm.gamma"].shape) == want
        assert float(params["conv0.norm.gamma"].min()) == 1.0
    jcfg = pairs[0][0]
    host = jax.device_get(jax_maml.init_state(jcfg, seed=0))
    assert host.bn == {}
    back = state_lib.to_numpy(state_lib.from_numpy(host, device="cpu"))
    for name in ("net", "lslr"):
        for key, v in getattr(host, name).items():
            np.testing.assert_array_equal(getattr(back, name)[key], v)
    assert back.bn == {}


@pytest.mark.parametrize("block", ["plain", "functions"])
@pytest.mark.parametrize("max_pooling", [True, False],
                         ids=["pooled", "strided"])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("step", [0, 2, 5])
def test_layer_norm_apply_matches_jax(step, order, max_pooling, block):
    """Logits, the (empty) new BN state and d(logits . ct)/dparams at steps
    0, 2 and 5 (clamped to the last of 3), on the plain block and on the
    Function block. ``per_step_bn_statistics`` is on, as in the
    mini-ImageNet JSON: a layer norm's (H, W, C) gamma must not be indexed
    by the step (row ``step`` of an (H, W, C) leaf would broadcast)."""
    jcfg, cfg = _cfgs(order, max_pooling,
                      number_of_training_steps_per_iter=3)
    net = _state(jcfg)
    rng = np.random.RandomState(step)
    x = rng.rand(5, 11, 11, 3).astype(np.float32)
    ct = rng.randn(5, 3).astype(np.float32)

    def jax_fn(params):
        logits, new_bn = jax_vgg.apply(jcfg, params, {}, jnp.asarray(x),
                                       step)
        return jnp.sum(logits * ct), (logits, new_bn)

    jgrad, (jlogits, jbn) = jax.grad(jax_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in net.items()})
    tparams = {k: _t(v).requires_grad_(True) for k, v in net.items()}
    logits, new_bn = vgg.apply(
        cfg, tparams, {}, _t(x), step,
        block=FUNCTION_BLOCKS[order] if block == "functions" else None)
    tgrad = torch.autograd.grad((logits * _t(ct)).sum(),
                                list(tparams.values()), allow_unused=True)
    _close(logits, jlogits, VALUE_TOL, "logits")
    assert new_bn == {} and jbn == {}
    gscale = max(np.abs(np.asarray(g)).max() for g in jgrad.values())
    for k, g in zip(tparams, tgrad):
        g = torch.zeros_like(tparams[k]) if g is None else g
        _close(g, jgrad[k], GRAD_TOL, f"grad {k}", gscale)


@pytest.mark.parametrize("order", ORDERS)
def test_layer_norm_apply_tenant_axis_matches_jax_vmap(order):
    """With ``enable_inner_loop_optimizable_bn_params`` the inner loop
    adapts beta (it carries the tenant axis, ``(T, H, W, C)``) while the
    frozen gamma stays shared ``(H, W, C)``."""
    jcfg, cfg = _cfgs(order, False,
                      enable_inner_loop_optimizable_bn_params=True)
    net = _state(jcfg, seed=1)
    rng = np.random.RandomState(7)
    T = 3
    adapted = {k for k in net if jax_partition.is_inner_adapted(jcfg, k)}
    assert "conv0.norm.beta" in adapted
    assert "conv0.norm.gamma" not in adapted
    tnet = {k: (v[None] + 0.05 * rng.randn(T, *v.shape)).astype(np.float32)
            if k in adapted else v for k, v in net.items()}
    x = rng.rand(T, 4, 11, 11, 3).astype(np.float32)

    def one(params_adapted, xi):
        frozen = {k: jnp.asarray(v) for k, v in tnet.items()
                  if k not in adapted}
        return jax_vgg.apply(jcfg, {**frozen, **params_adapted}, {}, xi, 1)

    jlogits, _ = jax.vmap(one)(
        {k: jnp.asarray(tnet[k]) for k in adapted}, jnp.asarray(x))
    for block in (None, FUNCTION_BLOCKS[order]):
        logits, new_bn = vgg.apply(cfg, {k: _t(v) for k, v in tnet.items()},
                                   {}, _t(x), 1, block=block)
        _close(logits, jlogits, VALUE_TOL, "logits")
        assert new_bn == {}


def test_a_block_of_the_other_norm_layer_raises():
    """A batch-norm block handed a layer-norm config (or the reverse)
    would index the norm leaves as another shape: ``vgg.apply`` refuses a
    block whose norm layer is not the config's, and ``blocks_for`` picks
    by (block order, norm layer)."""
    x = torch.zeros(2, 11, 11, 3)
    for order in ORDERS:
        _, ln = _cfgs(order, cnn_num_filters=3)
        _, bn = _cfgs(order, cnn_num_filters=3, norm_layer="batch_norm")
        for c, other in ((ln, bn), (bn, ln)):
            params, state = vgg.init(c, torch.Generator().manual_seed(0))
            for wrong in vgg.blocks_for(other):
                with pytest.raises(ValueError, match="norm_layer"):
                    vgg.apply(c, params, state, x, 0, block=wrong)
    _, conv_first = _cfgs("conv_norm_relu")
    _, norm_first = _cfgs("norm_conv_relu")
    assert vgg.blocks_for(conv_first) == (cb.conv_ln_act_pool,
                                          F.conv_ln_act_pool)
    assert vgg.blocks_for(norm_first) == (cb.ln_conv_act_pool,
                                          F.ln_conv_act_pool)
    for fn in (*vgg.blocks_for(conv_first), *vgg.blocks_for(norm_first),
               *FUNCTION_BLOCKS.values()):
        assert fn.norm_layer == "layer_norm"


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


@pytest.mark.parametrize("order", ORDERS)
def test_layer_norm_serve_step_matches_jax(order):
    """Adapt-then-predict with a pad tenant: the real tenants' preds and
    losses against the JAX serve step."""
    jcfg, cfg = _cfgs(order)
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
@pytest.mark.parametrize("order", ORDERS)
def test_layer_norm_second_order_meta_grads_match_jax(order, max_pooling,
                                                      block):
    """Second order with MSL weights, on the plain block and on the
    Function block (the card's structure, through the twins here): every
    leaf, the frozen gamma's meta-gradient (which the outer optimizer then
    drops) and the trained beta's included."""
    jcfg, cfg = _cfgs(order, max_pooling)
    jstate = jax_maml.init_state(jcfg, seed=4)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    batch = _batch(cfg, 2, 2, 1)[:4]
    jloss, jgrads = jax.jit(jax_maml.make_grads_fn(jcfg, True))(
        jstate, *[jnp.asarray(a) for a in batch], jnp.asarray(WEIGHTS))
    loss, grads = maml.make_grads_fn(
        cfg, True,
        block=FUNCTION_BLOCKS[order] if block == "functions" else None
    )(state, *[_t(a) for a in batch], WEIGHTS)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_grads(grads, jax.device_get(jgrads))
    for leaf in ("conv0.norm.gamma", "conv0.norm.beta"):
        assert float(grads["net"][leaf].abs().max()) > 0, leaf


@pytest.mark.parametrize("order", ORDERS)
def test_layer_norm_train_step_matches_jax(order):
    """One second-order MSL train step: loss and accuracy against the JAX
    step, an empty merged BN state, Adam moved every trainable leaf and
    left the frozen gamma where it was."""
    jcfg, cfg = _cfgs(order)
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
    assert new.bn == {} and jax.device_get(jnew.bn) == {}
    jnet = jax.device_get(jnew.net)
    for key, v in new.net.items():
        moved = float((v - state.net[key]).abs().max())
        if key.endswith(".norm.gamma"):
            assert moved == 0.0, key
            np.testing.assert_array_equal(v.numpy(), jnet[key])
        else:
            assert moved > 0, key


# -- the launch formulas ------------------------------------------------------------


@pytest.mark.parametrize("max_pooling", [True, False],
                         ids=["pooled", "strided"])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("second_order,stages,steps,accum", [
    (True, 2, 2, 1), (True, 3, 3, 2), (False, 3, 2, 1), (False, 2, 3, 2)])
def test_chip_smoke_launch_formula_counts_the_layer_norm_path(
        monkeypatch, second_order, stages, steps, accum, order,
        max_pooling):
    """Every kernel call of a layer-norm train step on the Function path,
    counted at the twins, equals the per-step formula ``chip_smoke.py``
    holds the card's counters to; no batch-norm kernel runs."""
    cfg = _formula_cfg(stages, steps, accum, max_pooling, order,
                       "layer_norm")
    want = _chip_smoke().expected_train_launches(cfg, second_order)
    assert want["layer_norm_stats"] > 0 and want["layer_norm_bwd"] > 0
    assert (want["layer_norm_bwd_bwd"] > 0) == second_order
    for bn_kernel in ("conv3x3_fwd_stats", "bn_act_pool_fwd", "bn_act_fwd",
                      "bn_input_stats", "batch_norm_fwd"):
        assert want[bn_kernel] == 0, bn_kernel
    assert _count_function_path(monkeypatch, cfg, second_order) == want


@pytest.mark.parametrize("max_pooling", [True, False],
                         ids=["pooled", "strided"])
@pytest.mark.parametrize("order", ORDERS)
def test_chip_smoke_serve_launch_formula_counts_the_layer_norm_path(
        monkeypatch, order, max_pooling):
    cfg = _formula_cfg(3, 2, 1, max_pooling, order, "layer_norm")
    want = _chip_smoke().expected_launches(cfg)
    assert want["layer_norm_fwd"] > 0
    assert _count_function_path(monkeypatch, cfg, False, serve=True) == want


# -- the benches ------------------------------------------------------------------------


def test_benches_take_norm_layer_layer_norm():
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve = serve_bench.run(["--fast", "--device", "cpu", "--requests",
                                 "3", "--norm_layer", "layer_norm",
                                 "--ingest", "index"])
        nf_serve = serve_bench.run(["--fast", "--device", "cpu",
                                    "--requests", "2", "--norm_layer",
                                    "layer_norm", "--block_order",
                                    "norm_conv_relu", "--max_pooling",
                                    "false"])
        train = bench.run(["--fast", "--device", "cpu", "--warmup", "0",
                           "--steps", "2", "--norm_layer", "layer_norm"])
    assert serve["norm_layer"] == train["norm_layer"] == "layer_norm"
    assert nf_serve["norm_layer"] == "layer_norm"
    assert nf_serve["block_order"] == "norm_conv_relu"
    assert serve["tenants"] == 3 and nf_serve["tenants"] == 2
    assert all(np.isfinite(train["loss"])) and train["second_order"]
    assert {v for line in (serve, nf_serve)
            for d in line["kernel_launches_per_dispatch"]
            for v in d.values()} == {0}
    assert {v for step in train["kernel_launches_per_step"]
            for v in step.values()} == {0}
    with pytest.raises(SystemExit):
        bench._parser().parse_args(["--norm_layer", "group_norm"])
