"""The unpadded models (``conv_padding=False``: every 3x3 conv a valid
window, 84 -> 82 at mini-ImageNet's stage 0) of the port held to the JAX
package on the CPU, module by module and as a whole:

* the twins: ``conv3x3_fwd_stats``, ``conv3x3``, ``conv3x3_dgrad`` and
  ``conv3x3_wgrad`` at pad 0, stride 1 and 2, against JAX
  ``_conv2d_raw(..., padding=0)`` and its ``jax.vjp``, at odd and even
  sizes (an even input at stride 2 has a last row that no output reads:
  its gradient is 0);
* f64 ``gradcheck`` / ``gradgradcheck`` of ``Conv3x3``, ``Dgrad`` and
  ``Wgrad`` at pad 0, and of the unpadded Function blocks (conv-first
  batch norm pooled and strided with the global average pool, norm
  first, both layer-norm orders), their second derivative against plain
  autograd;
* ``vgg.init`` shapes against the JAX ``init`` (pooled and strided, both
  orders, both norms; the mini-ImageNet widths: a (432, 5) head, a
  layer norm over (82, 82, 48)), the state round trip, ``vgg.apply``
  against JAX ``apply`` at steps 0, 2 and a clamped 5 (the running
  statistics too: their count is the pad-0 conv output's pixels), the
  tenant axis against ``jax.vmap``, and the unpadded strided Omniglot
  geometry, which the port refuses with ``ValueError`` and JAX cannot
  trace;
* ``make_serve_step``, second-order ``make_grads_fn`` (every leaf) and one
  ``make_train_step`` (with ``state.bn`` after it) against the JAX
  package; the same serve step and meta-gradients for a tiny geometry of
  the MAML (not ++) mini-ImageNet JSON (shared batch-norm parameters, no
  running statistics, no MSL, a fixed inner learning rate);
* the launch formulas ``chip_smoke.py`` holds the card to, counted on the
  twins under the ``conv3x3_p0_*`` / ``conv3x3_s2_p0_*`` names;
* ``serve-bench`` and ``train-bench --conv_padding false`` on the CPU.

Inputs are made from numpy seeds; JAX runs on the CPU as its own tests
run it, its steps eagerly (op by op): compiled with ``jax.jit``, XLA on
the CPU (jax 0.9.0) computes the second-order meta-gradients of some of
these geometries (the 14x14 unpadded pooled batch-norm model among them)
up to 10% off the same function run eagerly, which the port's f32 and
f64 steps both match. Tolerances (those of
``test_torch_layer_norm.py``): values ``1e-5`` of their scale,
gradients ``1e-4``; a meta-gradient leaf within ``1e-6 + 1e-4 *
max|jax leaf|``; the loss within rtol ``1e-4`` (f32, sums in another
order).
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
MAML = ("experiment_config/"
        "mini-imagenet_maml-mini-imagenet_5_5_2_0.01_48_0.json")
OMNIGLOT = "experiment_config/omniglot_maml++-omniglot_1_20_8_0.1_64_0.json"
UNPADDED = dict(conv_padding=False)
# (block_order, norm_layer) -> the Function block (the card's structure)
FUNCTION_BLOCKS = {
    ("conv_norm_relu", "batch_norm"): cb.function_block,
    ("norm_conv_relu", "batch_norm"): cb.norm_function_block,
    ("conv_norm_relu", "layer_norm"): cb.conv_ln_function_block,
    ("norm_conv_relu", "layer_norm"): cb.ln_conv_function_block,
}
MODELS = list(FUNCTION_BLOCKS)
MODEL_IDS = ["conv_bn", "norm_first", "conv_ln", "ln_conv"]


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


def _cfgs(max_pooling=True, block_order="conv_norm_relu",
          norm_layer="batch_norm", **extra):
    """A small unpadded model: 14x14x3 pooled over 2 stages (14 -> 12/6 ->
    4/2), or 15x15x3 strided over 3 (15 -> 7 -> 3 -> 1, then the global
    average pool); 3-way 2-shot, 2 targets, 6 filters, MAML++ with
    per-step BN statistics."""
    hw, stages = (14, 2) if max_pooling else (15, 3)
    kw = dict(
        dataset_name="omniglot_dataset", image_height=hw, image_width=hw,
        image_channels=3, num_classes_per_set=3, num_samples_per_class=2,
        num_target_samples=2, batch_size=2, cnn_num_filters=6,
        num_stages=stages, max_pooling=max_pooling,
        per_step_bn_statistics=True,
        learnable_per_layer_per_step_inner_loop_learning_rate=True,
        use_multi_step_loss_optimization=True, second_order=True,
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2, use_remat=False,
        task_learning_rate=0.1, block_order=block_order,
        norm_layer=norm_layer, bn_stats_impl="twopass",
        serving_bucket_ladder=[1, 2, 4], serving_max_tenants_per_dispatch=4,
        **UNPADDED,
    )
    kw.update(extra)
    return JaxConfig(**kw), MAMLConfig(**kw)


# -- the twins ----------------------------------------------------------------


def _jax_conv(stride):
    """JAX ``_conv2d_raw`` at pad 0, per tenant (``vmap``)."""
    return jax.vmap(lambda x, w, b: JF._conv2d_raw(x, w, b, stride, 0,
                                                   "im2col", "off"))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(3, 3), (7, 8), (9, 9), (10, 6)], ids=str)
def test_unpadded_conv_twins_match_jax(hw, stride):
    """K1's twins (with statistics and stats-free, with and without bias)
    against JAX ``_conv2d_raw(padding=0)``; dgrad and wgrad against its
    ``jax.vjp``. At stride 2 an even input's last row and column are read
    by no output (8 -> 3 reads rows 0-6): their gradient is exactly 0.
    The wrappers take the twins on the CPU and count no launch."""
    H, W = hw
    T, N, cin, cout = 2, 3, 4, 5
    rng = np.random.RandomState(H * 10 + W + stride)
    x = rng.randn(T, N, H, W, cin).astype(np.float32)
    w = (0.3 * rng.randn(T, 3, 3, cin, cout)).astype(np.float32)
    b = (0.1 * rng.randn(T, cout)).astype(np.float32)
    jy, vjp = jax.vjp(_jax_conv(stride), *(jnp.asarray(a) for a in (x, w, b)))
    Ho, Wo = F.conv_out_hw(H, W, stride, 0)
    assert jy.shape == (T, N, Ho, Wo, cout)
    kw = dict(stride=stride, padding=0)
    y, mean, var, rstd = F.conv3x3_fwd_stats(_t(x), _t(w), _t(b), **kw)
    _close(y, jy, VALUE_TOL, "fwd_stats y")
    yn = np.asarray(jy, np.float64)
    _close(mean, yn.mean((1, 2, 3)), VALUE_TOL, "mean")
    _close(var, yn.var((1, 2, 3)), VALUE_TOL, "var")
    _close(rstd, 1 / np.sqrt(yn.var((1, 2, 3)) + F.BN_EPS), VALUE_TOL,
           "rstd")
    _close(F.conv3x3(_t(x), _t(w), _t(b), **kw), jy, VALUE_TOL, "fwd")
    _close(F.conv3x3(_t(x), _t(w), **kw), jy - b[:, None, None, None],
           VALUE_TOL, "fwd (no bias)")
    dy = rng.randn(*jy.shape).astype(np.float32)
    jdx, jdw, jdb = vjp(jnp.asarray(dy))
    dx = F.conv3x3_dgrad(_t(dy), _t(w), stride, (H, W), 0)
    _close(dx, jdx, GRAD_TOL, "dgrad")
    dw, db = F.conv3x3_wgrad(_t(x), _t(dy), **kw)
    _close(dw, jdw, GRAD_TOL, "wgrad dw")
    _close(db, jdb, GRAD_TOL, "wgrad db")
    if stride == 2 and H % 2 == 0:
        assert not dx[:, :, -1].any() and not np.asarray(jdx)[:, :, -1].any()
    cb.reset_launches()
    _close(cb.conv3x3_fwd_stats(_t(x), _t(w), _t(b), **kw)[0], jy,
           VALUE_TOL, "wrapper fwd_stats")
    _close(cb.conv3x3_fwd(_t(x), _t(w), _t(b), stride, 0), jy, VALUE_TOL,
           "wrapper fwd")
    _close(cb.conv3x3_dgrad(_t(dy), _t(w), stride, (H, W), 0), jdx,
           GRAD_TOL, "wrapper dgrad")
    _close(cb.conv3x3_wgrad(_t(x), _t(dy), stride, 0)[0], jdw, GRAD_TOL,
           "wrapper wgrad")
    assert set(cb.launches().values()) == {0}


def test_unpadded_dgrad_needs_the_input_size():
    """At pad 0 dy does not give the input's size as its own (82 -> 84 at
    stride 1): dgrad requires ``in_hw``, and refuses one that does not give
    dy; pad 1 at stride 1 still infers it."""
    dy = torch.zeros(1, 2, 4, 4, 3)
    w = torch.zeros(1, 3, 3, 2, 3)
    for stride in (1, 2):
        with pytest.raises(ValueError, match="in_hw is required"):
            cb.conv3x3_dgrad(dy, w, stride, None, 0)
    with pytest.raises(ValueError, match="not the stride-1 output"):
        cb.conv3x3_dgrad(dy, w, 1, (4, 4), 0)
    assert cb.conv3x3_dgrad(dy, w, 1, (6, 6), 0).shape == (1, 2, 6, 6, 2)
    assert cb.conv3x3_dgrad(dy, w, 2, (10, 9), 0).shape == (1, 2, 10, 9, 2)
    assert cb.conv3x3_dgrad(dy, w).shape == (1, 2, 4, 4, 2)
    with pytest.raises(ValueError, match="pad 1 or 0"):
        cb._conv_name("conv3x3_fwd", 1, 2)
    assert [cb._conv_name("conv3x3_wgrad", s, p) for s, p in
            ((1, 1), (2, 1), (1, 0), (2, 0))] == [
        "conv3x3_wgrad", "conv3x3_s2_wgrad", "conv3x3_p0_wgrad",
        "conv3x3_s2_p0_wgrad"]


# -- the Functions and blocks, f64 --------------------------------------------


def _f64(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.randn(*shape) * scale).requires_grad_(True)


@pytest.mark.parametrize("stride", [1, 2])
def test_unpadded_conv_functions_gradcheck_and_gradgradcheck(stride):
    """``Conv3x3`` (stats-free with bias, and the conv output of the mode
    with statistics), ``Dgrad`` and ``Wgrad`` at pad 0, f64: each carries
    its stride and pad into the Functions of its backward."""
    rng = np.random.RandomState(stride)
    T, N, H, W, cin, cout = 2, 2, 6, 5, 2, 3
    x = _f64(rng, T, N, H, W, cin)
    w = _f64(rng, T, 3, 3, cin, cout, scale=0.4)
    b = _f64(rng, T, cout, scale=0.1)
    dy = _f64(rng, T, N, *F.conv_out_hw(H, W, stride, 0), cout)

    def conv(x, w, b):
        return cb.Conv3x3.apply(x, w, b, False, stride, 0)

    def conv_stats(x, w, b):
        return cb.Conv3x3.apply(x, w, b, True, stride, 0)[0]

    def dgrad(dy, w):
        return cb.Dgrad.apply(dy, w, stride, (H, W), 0)

    def wgrad(x, dy):
        return cb.Wgrad.apply(x, dy, stride, 0)

    for fn, args in ((conv, (x, w, b)), (conv_stats, (x, w, b)),
                     (dgrad, (dy, w)), (wgrad, (x, dy))):
        assert gradcheck(fn, args)
        assert gradgradcheck(fn, args)


BLOCK_CASES = {
    "conv_bn": (MODELS[0], dict()),
    "conv_bn_strided_gap": (MODELS[0], dict(stride=2, pool=False, gap=True)),
    "norm_first": (MODELS[1], dict()),
    "conv_ln": (MODELS[2], dict()),
    "ln_conv_strided_gap": (MODELS[3], dict(stride=2, pool=False, gap=True)),
}


def _block_inputs(model, kw, seed=0, shape=(2, 2, 8, 7, 3, 4)):
    """x, w, b, gamma and beta of the block: per channel for a batch norm
    (the conv output's or the block input's), a shared (H, W, C) gamma and
    a per-tenant beta for a layer norm."""
    order, norm = model
    T, N, H, W, cin, cout = shape
    rng = np.random.RandomState(seed)
    conv_first = order == "conv_norm_relu"
    c = cout if conv_first else cin
    if norm == "layer_norm":
        hw = (F.conv_out_hw(H, W, kw.get("stride", 1), 0) if conv_first
              else (H, W))
        gshape, bshape = (*hw, c), (T, *hw, c)
    else:
        gshape, bshape = (c,), (c,)
    return (_f64(rng, T, N, H, W, cin),
            _f64(rng, T, 3, 3, cin, cout, scale=0.4),
            _f64(rng, T, cout, scale=0.1),
            torch.from_numpy(1 + 0.2 * rng.randn(*gshape)).requires_grad_(),
            _f64(rng, *bshape, scale=0.1))


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_unpadded_function_blocks_gradcheck_and_gradgradcheck(case):
    model, kw = BLOCK_CASES[case]
    inputs = _block_inputs(model, kw)

    def block(*a):
        return FUNCTION_BLOCKS[model](*a, padding=0, **kw)[0]

    assert gradcheck(block, inputs)
    assert gradgradcheck(block, inputs)


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_unpadded_block_second_derivative_matches_plain_autograd(case):
    """A scalar function of the block's first gradients, differentiated
    again: the Function block equals autograd of the plain block, and so
    do the batch statistics it returns (the pad-0 conv output's)."""
    model, kw = BLOCK_CASES[case]
    plain = vgg._BLOCKS[model][1]
    results, stats = [], []
    for fn in (FUNCTION_BLOCKS[model], plain):
        leaves = _block_inputs(model, kw, 6, (2, 3, 10, 9, 3, 4))
        out, mean, var = fn(*leaves, padding=0, **kw)
        stats.append((mean, var))
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
    for got, want in zip(*stats):
        if want is None:
            assert got is None
        else:
            torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-12)


# -- the model ----------------------------------------------------------------


def _state(jcfg, seed=0):
    """The JAX package's initial parameters with the norm leaves moved off
    1 and 0, so that a wrong gamma or beta shows."""
    host = jax.device_get(jax_maml.init_state(jcfg, seed=seed))
    rng = np.random.RandomState(seed + 10)
    net = {k: np.array(v) for k, v in host.net.items()}
    for k in net:
        if ".norm." in k:
            net[k] = (net[k] + 0.1 * rng.randn(*net[k].shape)).astype(
                np.float32)
    return net, {k: np.array(v) for k, v in host.bn.items()}


@pytest.mark.parametrize("max_pooling", [True, False],
                         ids=["pooled", "strided"])
@pytest.mark.parametrize("model", MODELS, ids=MODEL_IDS)
def test_unpadded_init_matches_jax_and_round_trips(model, max_pooling):
    """Every leaf's shape against the JAX ``init``, at the small
    configuration and at the mini-ImageNet widths (84 -> 82/41 -> 39/19 ->
    17/8 -> 6/3 pooled: a (432, 5) head and a layer norm over (82, 82, 48)
    conv first; 84 -> 41 -> 20 -> 9 -> 4 strided: a (48, 5) head); the JAX
    state crosses leaf by leaf and back."""
    order, norm = model
    extra = dict(max_pooling=max_pooling, block_order=order, norm_layer=norm,
                 **UNPADDED)
    flagship = (JaxConfig.from_json_file(FLAGSHIP, **extra),
                MAMLConfig.from_json_file(FLAGSHIP, **extra))
    for jcfg, cfg in (_cfgs(max_pooling, order, norm), flagship):
        params, bn = vgg.init(cfg, torch.Generator().manual_seed(0))
        jparams, jbn = jax_vgg.init(jcfg, jax.random.PRNGKey(0))
        assert {k: tuple(v.shape) for k, v in params.items()} == {
            k: tuple(v.shape) for k, v in jparams.items()}
        assert {k: tuple(v.shape) for k, v in bn.items()} == {
            k: tuple(v.shape) for k, v in jbn.items()}
        assert list(vgg._stage_dims(cfg)) == list(jax_vgg._stage_dims(jcfg))
    params, _ = vgg.init(flagship[1], torch.Generator().manual_seed(0))
    assert tuple(params["linear.weight"].shape) == (
        (432, 5) if max_pooling else (48, 5))
    if norm == "layer_norm" and order == "conv_norm_relu":
        assert tuple(params["conv0.norm.gamma"].shape) == (
            (82, 82, 48) if max_pooling else (41, 41, 48))
    host = jax.device_get(jax_maml.init_state(flagship[0], seed=0))
    back = state_lib.to_numpy(state_lib.from_numpy(host, device="cpu"))
    for name in ("net", "lslr", "bn"):
        assert sorted(getattr(back, name)) == sorted(getattr(host, name))
        for key, v in getattr(host, name).items():
            np.testing.assert_array_equal(getattr(back, name)[key], v)


@pytest.mark.parametrize("block", ["plain", "functions"])
@pytest.mark.parametrize("max_pooling", [True, False],
                         ids=["pooled", "strided"])
@pytest.mark.parametrize("step", [0, 2, 5])
def test_unpadded_apply_matches_jax(step, max_pooling, block):
    """Logits, the new running statistics (their unbiased variance counts
    the pad-0 conv output's pixels, 12x12 of a 14x14 input) and
    d(logits . ct)/dparams at steps 0, 2 and 5 (clamped to the last of 3),
    on the plain block and on the Function block."""
    jcfg, cfg = _cfgs(max_pooling, number_of_training_steps_per_iter=3)
    net, bn = _state(jcfg)
    rng = np.random.RandomState(step)
    x = rng.rand(5, *cfg.im_shape).astype(np.float32)
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
        block=FUNCTION_BLOCKS[MODELS[0]] if block == "functions" else None)
    tgrad = torch.autograd.grad((logits * _t(ct)).sum(),
                                list(tparams.values()), allow_unused=True)
    _close(logits, jlogits, VALUE_TOL, "logits")
    assert sorted(new_bn) == sorted(jbn) and new_bn
    for k, v in jbn.items():
        _close(new_bn[k], v, VALUE_TOL, k)
    gscale = max(np.abs(np.asarray(g)).max() for g in jgrad.values())
    for k, g in zip(tparams, tgrad):
        g = torch.zeros_like(tparams[k]) if g is None else g
        _close(g, jgrad[k], GRAD_TOL, f"grad {k}", gscale)


@pytest.mark.parametrize("model", MODELS, ids=MODEL_IDS)
def test_unpadded_apply_tenant_axis_matches_jax_vmap(model):
    """With ``enable_inner_loop_optimizable_bn_params`` the inner loop
    adapts the norm parameters too: every adapted leaf carries the tenant
    axis, the frozen ones stay shared; strided, both orders and norms."""
    order, norm = model
    jcfg, cfg = _cfgs(False, order, norm,
                      enable_inner_loop_optimizable_bn_params=True)
    net, bn = _state(jcfg, seed=1)
    rng = np.random.RandomState(7)
    T = 3
    adapted = {k for k in net if jax_partition.is_inner_adapted(jcfg, k)}
    tnet = {k: (v[None] + 0.05 * rng.randn(T, *v.shape)).astype(np.float32)
            if k in adapted else v for k, v in net.items()}
    x = rng.rand(T, 4, *cfg.im_shape).astype(np.float32)

    def one(params_adapted, xi):
        frozen = {k: jnp.asarray(v) for k, v in tnet.items()
                  if k not in adapted}
        return jax_vgg.apply(jcfg, {**frozen, **params_adapted},
                             {k: jnp.asarray(v) for k, v in bn.items()},
                             xi, 1)

    jlogits, _ = jax.vmap(one)(
        {k: jnp.asarray(tnet[k]) for k in adapted}, jnp.asarray(x))
    for block in (None, FUNCTION_BLOCKS[model]):
        logits, _ = vgg.apply(cfg, {k: _t(v) for k, v in tnet.items()},
                              {k: _t(v) for k, v in bn.items()}, _t(x), 1,
                              block=block)
        _close(logits, jlogits, VALUE_TOL, "logits")


def test_unpadded_strided_omniglot_geometry_raises():
    """Omniglot's 28x28 strided and unpadded vanishes (28 -> 13 -> 6 -> 2
    -> 0): the port refuses it with ``ValueError`` naming the stage, in
    ``init``, ``apply`` and the serving engine, before any kernel; the JAX
    package's config accepts it and its ``apply`` fails at trace time."""
    extra = dict(max_pooling=False, **UNPADDED)
    jcfg = JaxConfig.from_json_file(OMNIGLOT, **extra)
    cfg = MAMLConfig.from_json_file(OMNIGLOT, **extra)
    with pytest.raises(ValueError, match="vanishes at stage 3"):
        vgg.init(cfg, torch.Generator().manual_seed(0))
    small = MAMLConfig.from_json_file(OMNIGLOT, max_pooling=False)
    params, bn = vgg.init(small, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="vanishes at stage 3"):
        vgg.apply(cfg, params, bn, torch.zeros(1, 28, 28, 1), 0)
    jparams, jbn = jax_vgg.init(jcfg, jax.random.PRNGKey(0))
    with pytest.raises(TypeError, match="nonnegative"):
        jax_vgg.apply(jcfg, jparams, jbn, jnp.zeros((2, 28, 28, 1)), 0)


# -- the steps ----------------------------------------------------------------


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


def _maml_cfgs():
    """The MAML (not ++) mini-ImageNet JSON at a tiny geometry: 14x14x3,
    2 stages of 6 filters, 3-way 2-shot, 2 inner steps; its own fields
    otherwise (shared batch-norm gamma and beta, no running statistics,
    no MSL, a fixed inner learning rate, second order), padded."""
    extra = dict(image_height=14, image_width=14, cnn_num_filters=6,
                 num_stages=2, num_classes_per_set=3,
                 num_samples_per_class=2, num_target_samples=2,
                 number_of_training_steps_per_iter=2,
                 number_of_evaluation_steps_per_iter=2,
                 bn_stats_impl="twopass", use_remat=False,
                 serving_bucket_ladder=[1, 2, 4],
                 serving_max_tenants_per_dispatch=4)
    jcfg = JaxConfig.from_json_file(MAML, **extra)
    cfg = MAMLConfig.from_json_file(MAML, **extra)
    assert not cfg.per_step_bn_statistics and cfg.conv_padding
    assert not cfg.use_multi_step_loss_optimization
    assert not cfg.learnable_per_layer_per_step_inner_loop_learning_rate
    return jcfg, cfg


STEP_MODELS = {"pooled": lambda: _cfgs(True),
               "strided": lambda: _cfgs(False),
               "norm_first": lambda: _cfgs(True, "norm_conv_relu"),
               "layer_norm": lambda: _cfgs(True, norm_layer="layer_norm"),
               "maml_json": _maml_cfgs}


@pytest.mark.parametrize("which", list(STEP_MODELS))
def test_unpadded_serve_step_matches_jax(which):
    """Adapt-then-predict with a pad tenant: the real tenants' preds and
    losses against the JAX serve step."""
    jcfg, cfg = STEP_MODELS[which]()
    jstate = jax_maml.init_state(jcfg, seed=4)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    batch = _batch(cfg, 2, 2, 3, pad=1)
    _, jout = jax_maml.make_serve_step(jcfg)(
        jstate, *[jnp.asarray(a) for a in batch])
    _, out = maml.make_serve_step(cfg)(state, *[_t(a) for a in batch])
    real = slice(0, 2)
    np.testing.assert_allclose(out["preds"][real].numpy(),
                               np.asarray(jout["preds"])[real], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out["loss"][real], jout["loss"][real],
                               rtol=LOSS_RTOL)
    assert torch.isfinite(out["preds"]).all()


def _assert_grads(got, want, cfg):
    """Every leaf within ``GRAD_ATOL + GRAD_RTOL * max|jax leaf|``. The
    conv biases of a conv-first batch-norm model are the exception: batch
    norm subtracts them, so their exact meta-gradient is 0 and both sides
    hold f32 round-off of the tree's terms (~1e-6): they are held to the
    tree's largest entry instead, as ``chip_smoke.py`` holds them."""
    tree = max(float(np.abs(np.asarray(w)).max())
               for part in want.values() for w in part.values())
    zero_bias = (cfg.block_order == "conv_norm_relu"
                 and cfg.norm_layer == "batch_norm")
    for group in ("net", "lslr"):
        assert sorted(got[group]) == sorted(want[group]), group
        for key, w in want[group].items():
            g, w = got[group][key].detach().numpy(), np.asarray(w)
            assert g.shape == w.shape, key
            err = float(np.abs(g - w).max())
            scale = (tree if zero_bias and key.endswith(".conv.bias")
                     else float(np.abs(w).max()))
            assert err <= GRAD_ATOL + GRAD_RTOL * scale, (group, key, err)


@pytest.mark.parametrize("block", ["plain", "functions"])
@pytest.mark.parametrize("which", list(STEP_MODELS))
def test_unpadded_second_order_meta_grads_match_jax(which, block):
    """Second order, on the plain block and on the Function block (the
    card's structure, through the twins here): the loss and every leaf of
    the meta-gradient against the JAX package."""
    jcfg, cfg = STEP_MODELS[which]()
    jstate = jax_maml.init_state(jcfg, seed=4)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    batch = _batch(cfg, 2, 2, 1)[:4]
    # the MAML JSON has no MSL: the last step's loss alone
    weights = maml.epoch_schedule(cfg, 0)[1] if which == "maml_json" \
        else WEIGHTS
    jloss, jgrads = jax_maml.make_grads_fn(jcfg, True)(
        jstate, *[jnp.asarray(a) for a in batch], jnp.asarray(weights))
    fn_block = FUNCTION_BLOCKS[(cfg.block_order, cfg.norm_layer)]
    loss, grads = maml.make_grads_fn(
        cfg, True, block=fn_block if block == "functions" else None
    )(state, *[_t(a) for a in batch], np.asarray(weights, np.float32))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_grads(grads, jax.device_get(jgrads), cfg)


@pytest.mark.parametrize("max_pooling", [True, False],
                         ids=["pooled", "strided"])
def test_unpadded_train_step_matches_jax(max_pooling):
    """One second-order MSL train step: loss and accuracy against the JAX
    step, and the merged running statistics ``state.bn`` after it: their
    unbiased variance takes the pad-0 conv output's pixel count."""
    jcfg, cfg = _cfgs(max_pooling)
    jstate = jax_maml.init_state(jcfg, seed=13)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    batch = _batch(cfg, 2, 2, 14)[:4]
    jnew, jmetrics = jax_maml.make_train_step(jcfg, True)(
        jstate, *[jnp.asarray(a) for a in batch], jnp.asarray(WEIGHTS),
        1e-3)
    new, metrics = maml.make_train_step(cfg, True)(
        state, *[_t(a) for a in batch], WEIGHTS, 1e-3)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["accuracy"]),
                               float(jmetrics["accuracy"]), atol=1e-6)
    jbn = jax.device_get(jnew.bn)
    assert sorted(new.bn) == sorted(jbn) and new.bn
    for key, v in jbn.items():
        assert float((new.bn[key] - state.bn[key]).abs().max()) > 0, key
        _close(new.bn[key], v, VALUE_TOL, key)


# -- the launch formulas ------------------------------------------------------


def _unpadded_formula_cfg(stages, steps, accum, max_pooling, model):
    """``_formula_cfg`` unpadded, at 30x30 (3 stages: 30 -> 28/14 -> 12/6
    -> 4/2 pooled, 30 -> 14 -> 6 -> 2 strided; its 12x12 vanishes)."""
    return _formula_cfg(stages, steps, accum, max_pooling, *model).replace(
        image_height=30, image_width=30, **UNPADDED)


@pytest.mark.parametrize("max_pooling", [True, False],
                         ids=["pooled", "strided"])
@pytest.mark.parametrize("model", MODELS, ids=MODEL_IDS)
@pytest.mark.parametrize("second_order,stages,steps,accum", [
    (True, 2, 2, 1), (False, 2, 3, 2)])
def test_chip_smoke_launch_formula_counts_the_unpadded_path(
        monkeypatch, second_order, stages, steps, accum, model,
        max_pooling):
    """Every kernel call of an unpadded train step on the Function path,
    counted at the twins, equals the per-step formula ``chip_smoke.py``
    holds the card's counters to: the conv kernels under the pad-0 names,
    none under the pad-1 ones."""
    cfg = _unpadded_formula_cfg(stages, steps, accum, max_pooling, model)
    want = _chip_smoke().expected_train_launches(cfg, second_order)
    tag = "s2_p0" if not max_pooling else "p0"
    assert want[f"conv3x3_{tag}_wgrad"] > 0
    assert not any(v for k, v in want.items() if k.startswith("conv3x3")
                   and f"_{tag}_" not in k)
    assert _count_function_path(monkeypatch, cfg, second_order) == want


@pytest.mark.parametrize("max_pooling", [True, False],
                         ids=["pooled", "strided"])
@pytest.mark.parametrize("model", MODELS, ids=MODEL_IDS)
def test_chip_smoke_serve_launch_formula_counts_the_unpadded_path(
        monkeypatch, model, max_pooling):
    cfg = _unpadded_formula_cfg(3, 2, 1, max_pooling, model)
    want = _chip_smoke().expected_launches(cfg)
    tag = "s2_p0" if not max_pooling else "p0"
    assert want[f"conv3x3_{tag}_wgrad"] > 0
    assert _count_function_path(monkeypatch, cfg, False, serve=True) == want


# -- the benches --------------------------------------------------------------


def test_benches_take_conv_padding_false():
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve = serve_bench.run(["--fast", "--device", "cpu", "--requests",
                                 "3", "--conv_padding", "false",
                                 "--ingest", "index"])
        strided = serve_bench.run(["--fast", "--device", "cpu",
                                   "--requests", "2", "--conv_padding",
                                   "false", "--block_order",
                                   "norm_conv_relu"])
        train = bench.run(["--fast", "--device", "cpu", "--warmup", "0",
                           "--steps", "2", "--conv_padding", "false"])
        padded = bench.run(["--fast", "--device", "cpu", "--warmup", "0",
                            "--steps", "1"])
    assert serve["conv_padding"] is False and train["conv_padding"] is False
    assert strided["block_order"] == "norm_conv_relu"
    assert serve["tenants"] == 3 and strided["tenants"] == 2
    assert all(np.isfinite(train["loss"])) and train["second_order"]
    # the valid conv's outputs are smaller: fewer FLOPs per task
    assert 0 < train["model_flops_per_task"] < padded["model_flops_per_task"]
    assert {v for line in (serve, strided)
            for d in line["kernel_launches_per_dispatch"]
            for v in d.values()} == {0}
    assert {v for step in train["kernel_launches_per_step"]
            for v in step.values()} == {0}
    with pytest.raises(SystemExit):
        bench._parser().parse_args(["--conv_padding", "maybe"])
