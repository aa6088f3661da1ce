"""The strided model (``max_pooling=False``) and the norm-first model
(``block_order='norm_conv_relu'``) in bf16 (``compute_dtype='bfloat16'``),
held to the JAX package's bf16 on the CPU, and the pieces the card runs
them on: the bf16 twins of the kernels only these models take (the global
average pool, the leaky-ReLU + max pool and its pool-free mode, the
norm-first block's standalone batch norm), the Function blocks on those
twins, one full train step of each model, the launch formulas of
``chip_smoke.py`` on the ``*_bf16`` names, and both benches.

Bounds:

* the twins equal the JAX package's bf16 ops bit for bit (the JAX side
  run eagerly): ``global_avg_pool2d`` (``bf16(f32 sum / HW)``) and its
  transpose (``bf16(f32(g) / HW)``); ``leaky_relu`` +
  ``max_pool2d(impl='reduce_window')`` (the first maximum of a window
  takes its gradient) and ``leaky_relu`` alone, their ``vjp`` and the
  ``vjp`` of that ``vjp`` (the pool's gather); ``batch_norm`` with
  ``stats_impl='twopass'``, its mean, variance, rstd and output. Inputs on
  a coarse grid, so that exact ties fill the pool windows;
* the Function blocks (``function_block`` strided, ``norm_function_block``
  pooled and strided) on the twins give the plain bf16 second-order loss
  and meta-gradients within 2x the plain path's own bf16-vs-f32 distance
  per leaf, the bound of ``test_torch_bf16_train.py``'s conv-first case,
  that distance taken as at least one bf16 ulp of the leaf's largest
  entry. The floor was added after the first reading: the strided
  models' head bias came out of the plain bf16 path within a sixth of a
  bf16 ulp of its f32 value (1.5e-5 of a leaf of 3.7e-2), an accidental
  agreement that no other rounding order of the same function keeps;
* one full bf16 ``make_train_step`` of each model against the JAX
  package's, each Adam first moment within 1x the JAX package's own
  bf16-vs-f32 distance (the cancelled conv biases of the strided
  conv-first model against the tree, as in
  ``test_bf16_train_step_matches_jax``). Not 0.5x, the conv-first bound:
  second order, the two autodiff engines add a bf16 value's gradient
  contributions in their own orders (``test_torch_bf16_train.py``), which
  in these models reaches every leaf, and ``xla_cpu_sums`` adds a shared
  norm parameter's gradient over all tasks in one bf16 accumulator where
  the JAX package sums each task in bf16 and the tasks in f32 (with one
  task the norm-first model's first-order meta-gradients equal JAX's bit
  for bit, with two its norm gamma and beta do not). On the first reading
  the norm-first model's stage-0 beta reached 0.655x.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.core import maml as jax_maml
from howtotrainyourmamlpytorch_tpu.ops import functional as JF
from howtotrainyourmamlpytorch_tpu_torch import bench
from howtotrainyourmamlpytorch_tpu_torch import state as state_lib
from howtotrainyourmamlpytorch_tpu_torch.core import maml
from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F
from howtotrainyourmamlpytorch_tpu_torch.serving import bench as serve_bench
from test_torch_bf16 import _from_jax, xla_cpu_sums  # noqa: F401
from test_torch_bf16_train import (
    _cancelled,
    _chip_smoke,
    _count_bf16_function_path,
    _np,
    _tree_spread,
)
from test_torch_train import (
    FUNCTION_BLOCKS,
    WEIGHTS,
    _batch,
    _cfgs,
    _formula_cfg,
    _jax,
    _torch,
)

torch.set_num_threads(2)

BF16 = torch.bfloat16

#: the two models, and the strided norm-first one: config changes
MODELS = {
    "strided": dict(max_pooling=False),
    "norm-first": dict(block_order="norm_conv_relu"),
    "strided norm-first": dict(max_pooling=False,
                               block_order="norm_conv_relu"),
}


def _grid(rng, *shape, step=0.25, span=3):
    """bf16 values on a grid of ``step`` in [-span * step, span * step):
    exact ties in most pool windows, both signs."""
    v = rng.randint(-span, span, size=shape).astype(np.float32) * step
    return jnp.asarray(v).astype(jnp.bfloat16)


def _ulp(v):
    """bf16's spacing at |v| (8 significant bits)."""
    return 2.0 ** (np.frexp(abs(v))[1] - 8) if v else 0.0


def _bf16(rng, *shape, scale=1.0, shift=0.0):
    return jnp.asarray((rng.randn(*shape) * scale + shift).astype(
        np.float32)).astype(jnp.bfloat16)


# -- the twins against JAX's bf16 ---------------------------------------------


@pytest.mark.parametrize("hw", [(2, 2), (4, 4), (3, 5)], ids=str)
def test_gap_bf16_twins_equal_jax(hw):
    """The global average pool's twins in bf16: the forward equals
    ``global_avg_pool2d`` (the f32 sum over a true division by H*W, rounded
    once) and the backward its transpose (``bf16(f32(g) / HW)`` at every
    pixel) bit for bit, at the Omniglot strided model's 2x2, the unpadded
    strided model's 4x4 and an H*W (15) that is no power of two; the
    wrappers take the twins on the CPU."""
    rng = np.random.RandomState(0)
    h, w = hw
    xj = _bf16(rng, 6, h, w, 5, scale=1.7, shift=0.3)
    gj = _bf16(rng, 6, 1, 1, 5)
    with jax.disable_jit():
        out, vjp = jax.vjp(JF.global_avg_pool2d, xj)
        (dxj,) = vjp(gj)
    x, g = _from_jax(xj).unsqueeze(0), _from_jax(gj).reshape(1, 6, 5)
    got = F.global_avg_pool2d(x)
    assert got.dtype == BF16
    assert torch.equal(got, _from_jax(out).reshape(1, 6, 5))
    assert torch.equal(cb.global_avg_pool2d_fwd(x), got)
    dx = F.global_avg_pool2d_bwd(g, h, w)
    assert dx.dtype == BF16
    assert torch.equal(dx[0], _from_jax(dxj))
    assert torch.equal(cb.global_avg_pool2d_bwd(g, h, w), dx)


@pytest.mark.parametrize("hw", [(6, 6), (7, 9)], ids=str)
def test_act_pool_bf16_twins_equal_jax(hw):
    """``act_pool_fwd`` / ``act_pool_bwd`` / ``act_pool_gather`` in bf16
    against ``leaky_relu`` + ``max_pool2d(impl='reduce_window')``, its
    ``vjp`` and the ``vjp`` of that (linear) ``vjp``, bit for bit, on
    inputs with exact ties in most windows (an odd map drops its last row
    or column): the slope rounded to bf16 before its one product, the
    whole window gradient at the first maximum."""
    rng = np.random.RandomState(1)
    h, w = hw
    yj = _grid(rng, 3, h, w, 4)

    def f(y):
        return JF.max_pool2d(JF.leaky_relu(y), impl="reduce_window")

    with jax.disable_jit():
        pooled_j, vjp = jax.vjp(f, yj)
        dpj = _bf16(rng, *pooled_j.shape)
        (dyj,) = vjp(dpj)
        gdyj = _bf16(rng, *yj.shape)
        (gatherj,) = jax.vjp(lambda d: vjp(d)[0], dpj)[1](gdyj)
    y = _from_jax(yj).unsqueeze(0)
    pooled, arg = F.act_pool_fwd(y)
    assert pooled.dtype == BF16
    assert torch.equal(pooled[0], _from_jax(pooled_j))
    win = F._windows(F.act_fwd(y))
    ties = (win == win.amax(-1, keepdim=True)).sum(-1) > 1
    assert ties.float().mean() > 0.2
    dp = _from_jax(dpj).unsqueeze(0)
    dy = F.act_pool_bwd(dp, arg, y)
    assert dy.dtype == BF16 and torch.equal(dy[0], _from_jax(dyj))
    gather = F.act_pool_gather(_from_jax(gdyj).unsqueeze(0), arg, y)
    assert torch.equal(gather[0], _from_jax(gatherj))
    for got, want in zip(cb.act_pool_fwd(y), (pooled, arg)):
        assert torch.equal(got, want)


def test_act_bf16_twins_equal_jax():
    """The pool-free ``act_fwd`` / ``act_bwd`` in bf16 against
    ``leaky_relu`` and its ``vjp`` (``select(y >= 0, g, bf16(bf16(0.01) *
    g))``), bit for bit; ``act_bwd`` is its own adjoint, as the ``vjp`` of
    the ``vjp`` shows."""
    rng = np.random.RandomState(2)
    yj = _bf16(rng, 2, 5, 7, 3, scale=2.0)
    gj = _bf16(rng, *yj.shape)
    with jax.disable_jit():
        out_j, vjp = jax.vjp(JF.leaky_relu, yj)
        (dyj,) = vjp(gj)
        (ggj,) = jax.vjp(lambda d: vjp(d)[0], gj)[1](gj)
    y, g = _from_jax(yj).unsqueeze(0), _from_jax(gj).unsqueeze(0)
    assert torch.equal(F.act_fwd(y)[0], _from_jax(out_j))
    dy = F.act_bwd(g, y)
    assert dy.dtype == BF16 and torch.equal(dy[0], _from_jax(dyj))
    assert torch.equal(F.act_bwd(g, y)[0], _from_jax(ggj))
    assert torch.equal(cb.act_fwd(y), F.act_fwd(y))
    assert torch.equal(cb.act_bwd(g, y), dy)


@pytest.mark.usefixtures("xla_cpu_sums")
@pytest.mark.parametrize("what", ["image C=3", "image C=1", "activation"])
def test_standalone_batch_norm_bf16_twins_equal_jax(what):
    """``bn_input_stats`` + ``batch_norm_fwd`` in bf16 (the norm-first
    block's batch norm of its input) against ``batch_norm`` with
    ``stats_impl='twopass'`` in bf16, bit for bit: the mean and variance
    (``jnp.mean`` / ``jnp.var``: f32 about the f32 mean, each rounded
    once), rstd (``lax.rsqrt`` of ``bf16(var + bf16(eps))``) and the
    normalized output (every op rounded), on pixels in [0, 1] (the image
    at stage 0, 3 or 1 channels) and on a 48-channel activation."""
    rng = np.random.RandomState(3)
    if what.startswith("image"):
        c = int(what[-1])
        xj = jnp.asarray(rng.rand(5, 9, 9, c).astype(np.float32)).astype(
            jnp.bfloat16)
    else:
        c = 48
        xj = _bf16(rng, 5, 6, 6, c, scale=1.3, shift=0.4)
    gamma = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    beta = (0.1 * rng.randn(c)).astype(np.float32)
    with jax.disable_jit():
        zj, _, _ = JF.batch_norm(xj, jnp.asarray(gamma), jnp.asarray(beta),
                                 None, None, stats_impl="twopass")
        axes = (0, 1, 2)
        meanj, varj = jnp.mean(xj, axis=axes), jnp.var(xj, axis=axes)
        rstdj = jax.lax.rsqrt(varj + 1e-5)
    x = _from_jax(xj).unsqueeze(0)
    mean, var, rstd = F.bn_input_stats(x)
    assert mean.dtype == var.dtype == rstd.dtype == BF16
    for got, want in ((mean, meanj), (var, varj), (rstd, rstdj)):
        assert torch.equal(got[0], _from_jax(want))
    g, b = (torch.from_numpy(v)[None].to(BF16) for v in (gamma, beta))
    z = F.batch_norm_fwd(x, mean, rstd, g, b)
    assert z.dtype == BF16 and torch.equal(z[0], _from_jax(zj))
    for got, want in zip(cb.bn_input_stats(x), (mean, var, rstd)):
        assert torch.equal(got, want)
    assert torch.equal(cb.batch_norm_fwd(x, mean, rstd, g, b), z)


# -- the Function blocks on the twins -----------------------------------------


@pytest.mark.parametrize("model", list(MODELS))
def test_bf16_function_blocks_give_the_plain_meta_grads(model):
    """The learner on the model's hand-written Function block in bf16 (the
    card's structure, on the twins here: ``function_block`` strided with
    the pool-free K2/K3/K5 and the GAP, ``norm_function_block`` pooled and
    strided with ``bn_input_stats``, ``batch_norm_*`` and the act-pool
    kernels) against the plain bf16 block, second order: the loss and each
    leaf within 2x the plain path's own bf16-vs-f32 distance (at least one
    bf16 ulp of the leaf), the cancelled conv biases within 2x the tree's
    largest (the conv-first bound of
    ``test_bf16_function_block_gives_the_plain_meta_grads``)."""
    _, cfg = _cfgs(**MODELS[model])
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    block = FUNCTION_BLOCKS[(cfg.block_order, cfg.norm_layer)]
    state = state_lib.init_state(cfg, seed=2, device="cpu")
    batch = _torch(_batch(cfg, 2))
    loss32, plain32 = maml.make_grads_fn(cfg, True)(state, *batch, WEIGHTS)
    loss, plain = maml.make_grads_fn(cfg16, True)(state, *batch, WEIGHTS)
    floss, fgrads = maml.make_grads_fn(cfg16, True, block=block)(
        state, *batch, WEIGHTS)
    assert abs(float(floss) - float(loss)) \
        <= 2 * abs(float(loss) - float(loss32))
    spread = _tree_spread(plain, plain32)
    err = _tree_spread(fgrads, plain)
    tree = max(v for part in spread.values() for v in part.values())
    for g in spread:
        for k, s in spread[g].items():
            assert fgrads[g][k].dtype == torch.float32
            s = max(s, _ulp(float(plain32[g][k].abs().max())))
            limit = 2 * (tree if _cancelled(cfg, k) else s)
            assert err[g][k] <= limit, (g, k, err[g][k], limit)


# -- one train step against JAX -----------------------------------------------


@pytest.mark.usefixtures("xla_cpu_sums")
@pytest.mark.parametrize("model", ["strided", "norm-first"])
def test_bf16_train_step_of_the_model_matches_jax(model):
    """One full bf16 ``make_train_step`` (second order, Adam from a fresh
    state) of the strided and the norm-first model against the JAX
    package's: the loss, and the Adam first moments within 1x the JAX
    package's own bf16-vs-f32 distance (the module docstring says why not
    0.5x); master parameters and Adam moments stay f32 (the sibling of
    ``test_bf16_train_step_matches_jax``)."""
    jcfg, cfg = _cfgs(**MODELS[model])
    jstate = jax_maml.init_state(jcfg, seed=13)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    batch = _batch(cfg, 14)
    moments, losses = {}, {}
    for dtype in ("float32", "bfloat16"):
        with jax.disable_jit():
            jnew, jmetrics = jax_maml.make_train_step(
                jcfg.replace(compute_dtype=dtype), True)(
                    jstate, *_jax(batch), jnp.asarray(WEIGHTS), 1e-3)
        moments[dtype] = state_lib.from_numpy(
            jax.device_get(jnew), device="cpu").opt.mu
        losses[dtype] = float(jmetrics["loss"])
    new, metrics = maml.make_train_step(
        cfg.replace(compute_dtype="bfloat16"), True)(
            state, *_torch(batch), WEIGHTS, 1e-3)
    np.testing.assert_allclose(float(metrics["loss"]), losses["bfloat16"],
                               rtol=1e-6)
    assert int(new.opt.count) == 1
    for part in (new.net, new.lslr, new.opt.mu["net"], new.opt.nu["net"],
                 new.opt.mu["lslr"], new.opt.nu["lslr"]):
        assert {v.dtype for v in part.values()} == {torch.float32}
    spreads = {(g, k): np.abs(_np(moments["bfloat16"][g][k])
                              - _np(moments["float32"][g][k])).max()
               for g in moments["bfloat16"] for k in moments["bfloat16"][g]}
    tree = max(spreads.values())
    for (g, k), spread in spreads.items():
        err = np.abs(_np(new.opt.mu[g][k])
                     - _np(moments["bfloat16"][g][k])).max()
        limit = tree if _cancelled(cfg, k) else spread
        assert err <= limit, f"{g}/{k}: {err:.3e} > {limit:.3e}"


# -- the launch formulas ------------------------------------------------------


FORMULA_MODELS = {
    "strided": (False, "conv_norm_relu", True),
    "strided pad 0": (False, "conv_norm_relu", False),
    "norm-first": (True, "norm_conv_relu", True),
    "strided norm-first": (False, "norm_conv_relu", True),
}


@pytest.mark.parametrize("serve", [False, True], ids=["train", "serve"])
@pytest.mark.parametrize("model", list(FORMULA_MODELS))
def test_chip_smoke_launch_formulas_count_the_bf16_paths(monkeypatch, model,
                                                         serve):
    """Every kernel call of a bf16 second-order train step (or a serve
    dispatch) of the strided, the unpadded strided, the norm-first and the
    strided norm-first model on the Function path, counted at the twins,
    equals ``expected_train_launches`` (``expected_launches``): the f32
    formula on the ``*_bf16`` names, the GAP's included, every f32 kernel
    at 0."""
    max_pooling, order, padding = FORMULA_MODELS[model]
    cfg = _formula_cfg(2, 2, 1, max_pooling, order).replace(
        compute_dtype="bfloat16", conv_padding=padding,
        image_height=14, image_width=14)
    smoke = _chip_smoke()
    want = (smoke.expected_launches(cfg) if serve
            else smoke.expected_train_launches(cfg, True))
    assert not any(v for k, v in want.items() if not k.endswith("_bf16"))
    if not max_pooling:
        assert want["global_avg_pool2d_fwd_bf16"] > 0
        conv = "conv3x3_s2_" if padding else "conv3x3_s2_p0_"
        assert want[conv + ("fwd" if order == "norm_conv_relu"
                            else "fwd_stats") + "_bf16"] > 0
    if order == "norm_conv_relu":
        assert want["bn_input_stats_bf16"] > 0
    assert _count_bf16_function_path(monkeypatch, cfg, serve) == want


# -- the benches --------------------------------------------------------------


@pytest.mark.parametrize("entry", ["serve", "train"])
@pytest.mark.parametrize("model", ["strided", "norm-first"])
def test_benches_run_the_bf16_models_on_the_cpu(model, entry):
    """``serve-bench`` and ``train-bench`` with ``--compute_dtype bfloat16
    --max_pooling false`` and with ``--block_order norm_conv_relu`` on the
    CPU (the plain ops): one line each, the model and the dtype reported,
    finite losses, no kernel launched."""
    flags = (["--max_pooling", "false"] if model == "strided"
             else ["--block_order", "norm_conv_relu"])
    common = ["--fast", "--device", "cpu", "--compute_dtype", "bfloat16"]
    if entry == "serve":
        line = serve_bench.run(common + ["--requests", "3"] + flags)
        assert np.isfinite(line["adaptation_latency_ms_p50"])
        launches = line["kernel_launches_per_dispatch"]
    else:
        line = bench.run(common + ["--warmup", "0", "--steps", "2"] + flags)
        assert line["second_order"] is True
        assert len(line["loss"]) == 2 and all(np.isfinite(line["loss"]))
        launches = line["kernel_launches_per_step"]
    assert line["dtype"] == "bfloat16"
    assert line["max_pooling"] is (model != "strided")
    assert line["block_order"] == ("norm_conv_relu" if model == "norm-first"
                                   else "conv_norm_relu")
    assert {v for d in launches for v in d.values()} == {0}
