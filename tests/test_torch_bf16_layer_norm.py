"""The layer-norm models (``norm_layer='layer_norm'``) in bf16
(``compute_dtype='bfloat16'``), held to the JAX package's bf16 on the CPU,
and the pieces the card runs them on: the bf16 twins of the layer norm's
four kernels (``layer_norm_stats``, ``layer_norm_fwd``, ``layer_norm_bwd``,
``layer_norm_bwd_bwd``), the Function blocks on those twins, one full
train step of each block order, the launch formulas of ``chip_smoke.py``
on the ``*_bf16`` names, and both benches.

Bounds, fixed before the first run:

* the statistics and the forward equal the JAX package's bf16
  ``layer_norm`` bit for bit (the JAX side run eagerly): ``jnp.mean`` and
  ``jnp.var`` (f32 sums about the f32 mean, each rounded once),
  ``lax.rsqrt`` of ``bf16(var + bf16(eps))`` and the output, each op of
  ``(x - mean) * rstd * gamma + beta`` rounded;
* ``layer_norm_bwd`` and ``layer_norm_bwd_bwd`` in bf16 (f32 formulas on
  the bf16 inputs, each output rounded once) within 2x the plain bf16
  layer norm's own bf16-vs-f32 distance from autograd of it, that
  distance taken as at least one bf16 ulp of the output's largest f32
  entry (the floor of ``test_torch_bf16_models.py``); in f64 they equal
  the f64 derivatives to round-off;
* the Function blocks on the twins give the plain bf16 second-order loss
  and meta-gradients: first written as the rule of
  ``test_torch_bf16_models.py``, each leaf within 2x the plain path's own
  bf16-vs-f32 distance (at least one bf16 ulp). That rule failed on its
  first reading for the pooled models (conv first: lslr/conv0.conv.weight
  at 1.15x the limit; norm first: lslr/conv1.conv.bias at 1.99x), and
  over the data seeds 2-9 a leaf reached 44.9x its own distance, where
  the plain bf16 and f32 paths happen to agree on one leaf. The twins are
  no cast-point fault: op by op they sit 0.29-1.11x as far from f64 as
  the plain bf16 layer norm (the derivative test below), and the
  meta-gradients of this tiny geometry in bf16 are noise-dominated (the
  plain path's worst leaf is off f32 by up to 5.2x the leaf's largest
  entry). The bound is therefore taken over the tree: each leaf's
  distance from the plain bf16 path, over the leaf's largest f32 entry,
  within 2x the plain path's largest such relative bf16-vs-f32 distance
  (over seeds 2-9 the Function blocks reach 2.09x at worst, at seed 2
  1.00x), and the loss within 2x the plain path's bf16-vs-f32 distance or
  one bf16 ulp of the loss;
* one full bf16 ``make_train_step`` against the JAX package's: each Adam
  first moment within 1x the JAX package's own bf16-vs-f32 distance, the
  bound of the strided and norm-first models' train-step test (the
  autodiff engines add a bf16 value's gradient contributions in their own
  orders; ``xla_cpu_sums`` sums a shared norm parameter over all tasks in
  one bf16 accumulator).
"""

import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from howtotrainyourmamlpytorch_tpu.core import maml as jax_maml
from howtotrainyourmamlpytorch_tpu.ops import functional as JF
from howtotrainyourmamlpytorch_tpu_torch import bench
from howtotrainyourmamlpytorch_tpu_torch import state as state_lib
from howtotrainyourmamlpytorch_tpu_torch.core import maml
from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F
from howtotrainyourmamlpytorch_tpu_torch.serving import bench as serve_bench
from test_torch_bf16 import _from_jax, xla_cpu_sums  # noqa: F401
from test_torch_bf16_models import _bf16, _ulp
from test_torch_bf16_train import _chip_smoke, _count_bf16_function_path, _np
from test_torch_bf16_train import _tree_spread
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
LN = dict(norm_layer="layer_norm")
NORM_FIRST = dict(block_order="norm_conv_relu")

#: the normalized tensors, (H, W, C) and how they are drawn: the
#: conv-first block's conv output (an activation), the norm-first block's
#: stage-0 input (pixels in [0, 1], 3 channels) and the strided Omniglot
#: model's last map (2x2x64)
SHAPES = {
    "conv-first activation": ((6, 6, 48), "randn"),
    "norm-first image": ((9, 9, 3), "pixels"),
    "strided 2x2x64": ((2, 2, 64), "randn"),
}


def _x(rng, n, shape, kind):
    if kind == "pixels":
        return jnp.asarray(rng.rand(n, *shape).astype(np.float32)).astype(
            jnp.bfloat16)
    return _bf16(rng, n, *shape, scale=1.3, shift=0.4)


# -- the twins against JAX's bf16 ---------------------------------------------


@pytest.mark.parametrize("what", list(SHAPES))
def test_layer_norm_bf16_stats_and_forward_equal_jax(what):
    """``layer_norm_stats`` + ``layer_norm_fwd`` in bf16 against the JAX
    package's ``layer_norm`` in bf16, bit for bit: the per-image mean,
    variance and rstd, and the output with gamma and beta cast to bf16;
    the wrappers take the twins on the CPU."""
    shape, kind = SHAPES[what]
    rng = np.random.RandomState(5)
    xj = _x(rng, 5, shape, kind)
    gamma = (1 + 0.1 * rng.randn(*shape)).astype(np.float32)
    beta = (0.1 * rng.randn(*shape)).astype(np.float32)
    with jax.disable_jit():
        zj = JF.layer_norm(xj, jnp.asarray(gamma), jnp.asarray(beta))
        axes = (1, 2, 3)
        meanj, varj = jnp.mean(xj, axis=axes), jnp.var(xj, axis=axes)
        rstdj = lax.rsqrt(varj + 1e-5)
    x = _from_jax(xj).unsqueeze(0)
    stats = F.layer_norm_stats(x)
    assert all(v.dtype == BF16 and v.shape == (1, 5) for v in stats)
    for got, want in zip(stats, (meanj, varj, rstdj)):
        assert torch.equal(got[0], _from_jax(want))
    mean, _, rstd = stats
    g, b = (torch.from_numpy(v)[None].to(BF16) for v in (gamma, beta))
    z = F.layer_norm_fwd(x, mean, rstd, g, b)
    assert z.dtype == BF16 and torch.equal(z[0], _from_jax(zj))
    for got, want in zip(cb.layer_norm_stats(x), stats):
        assert torch.equal(got, want)
    assert torch.equal(cb.layer_norm_fwd(x, mean, rstd, g, b), z)


def _plain_derivatives(x, gamma, beta, dz, cts):
    """Autograd of the plain layer norm (``F.layer_norm``, per-tenant
    gamma and beta) in x's dtype: ``(dx, dgamma, dbeta)`` against ``dz``,
    then the gradients of ``<cts, (dx, dgamma, dbeta)>`` with respect to
    dz, x and gamma."""
    x, gamma, beta, dz = (t.clone().requires_grad_(True)
                          for t in (x, gamma, beta, dz))
    z = F.layer_norm(x, gamma.unsqueeze(1), beta.unsqueeze(1))
    first = torch.autograd.grad(z, (x, gamma, beta), dz, create_graph=True)
    second = torch.autograd.grad(first, (dz, x, gamma), cts)
    return [g.detach() for g in first], [g.detach() for g in second]


@pytest.mark.parametrize("what", list(SHAPES))
def test_layer_norm_bf16_derivative_twins_follow_the_plain_layer_norm(what):
    """``layer_norm_bwd`` and ``layer_norm_bwd_bwd`` in bf16 against
    autograd of the plain bf16 layer norm, within 2x that layer norm's own
    distance from f32 (at least one bf16 ulp of the f32 output's largest
    entry); both dtypes bf16 out. In f64 the twins equal the f64
    derivatives to round-off."""
    shape, kind = SHAPES[what]
    rng = np.random.RandomState(6)
    T, N = 2, 3

    def r(*s, scale=1.0):
        return torch.from_numpy((rng.randn(*s) * scale).astype(np.float32))

    x = _from_jax(_x(rng, T * N, shape, kind)).reshape(T, N, *shape).float()
    gamma, beta = 1 + r(T, *shape, scale=0.1), r(T, *shape, scale=0.1)
    dz = r(T, N, *shape)
    cts = (r(T, N, *shape), r(T, *shape), r(T, *shape))
    results = {}
    for dtype in (BF16, torch.float32, torch.float64):
        xd, gd, bd, dzd = (t.to(dtype) for t in (x, gamma, beta, dz))
        ctd = tuple(t.to(dtype) for t in cts)
        mean, _, rstd = F.layer_norm_stats(xd)
        twins = (F.layer_norm_bwd(dzd, xd, mean, rstd, gd),
                 F.layer_norm_bwd_bwd(*ctd, dzd, xd, mean, rstd, gd))
        results[dtype] = (twins, _plain_derivatives(xd, gd, bd, dzd, ctd))
    for order in (0, 1):
        twins16, plain16 = (results[BF16][i][order] for i in (0, 1))
        plain32 = results[torch.float32][1][order]
        for i, (got, want, want32) in enumerate(zip(twins16, plain16,
                                                    plain32)):
            assert got.dtype == BF16
            spread = (want.double() - want32.double()).abs().max().item()
            floor = _ulp(want32.abs().max().item())
            err = (got.double() - want.double()).abs().max().item()
            assert err <= 2 * max(spread, floor), (order, i, err, spread)
        for got, want in zip(*(results[torch.float64][i][order]
                               for i in (0, 1))):
            torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


# -- the Function blocks on the twins -----------------------------------------


BLOCK_MODELS = {
    "conv-first pooled": dict(LN),
    "conv-first pooled pad 0": dict(LN, conv_padding=False),
    "conv-first strided": dict(LN, max_pooling=False),
    "norm-first pooled": dict(LN, **NORM_FIRST),
    "norm-first strided": dict(LN, max_pooling=False, **NORM_FIRST),
}


@pytest.mark.parametrize("model", list(BLOCK_MODELS))
def test_bf16_layer_norm_function_blocks_give_the_plain_meta_grads(model):
    """The learner on ``conv_ln_function_block`` / ``ln_conv_function_block``
    in bf16 (the card's structure, on the twins here) against the plain
    bf16 block, second order, within the tree-wide bound of the module
    docstring; the master gradients stay f32."""
    _, cfg = _cfgs(**BLOCK_MODELS[model])
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    block = FUNCTION_BLOCKS[(cfg.block_order, cfg.norm_layer)]
    state = state_lib.init_state(cfg, seed=2, device="cpu")
    batch = _torch(_batch(cfg, 2))
    loss32, plain32 = maml.make_grads_fn(cfg, True)(state, *batch, WEIGHTS)
    loss, plain = maml.make_grads_fn(cfg16, True)(state, *batch, WEIGHTS)
    floss, fgrads = maml.make_grads_fn(cfg16, True, block=block)(
        state, *batch, WEIGHTS)
    assert abs(float(floss) - float(loss)) <= 2 * max(
        abs(float(loss) - float(loss32)), _ulp(float(loss32)))
    spread = _tree_spread(plain, plain32)
    err = _tree_spread(fgrads, plain)
    scale = {g: {k: float(v.abs().max()) for k, v in plain32[g].items()}
             for g in plain32}
    tree = max(s / scale[g][k] for g in spread for k, s in spread[g].items())
    for g in spread:
        for k, e in err[g].items():
            assert fgrads[g][k].dtype == torch.float32
            assert e <= 2 * tree * scale[g][k], (g, k, e / scale[g][k], tree)


# -- one train step against JAX -----------------------------------------------


@pytest.mark.usefixtures("xla_cpu_sums")
@pytest.mark.parametrize("order", ["conv-first", "norm-first"])
def test_bf16_train_step_of_the_layer_norm_model_matches_jax(order):
    """One full bf16 ``make_train_step`` (second order, Adam from a fresh
    state) of the layer-norm model against the JAX package's: the loss,
    and each Adam first moment within 1x the JAX package's own
    bf16-vs-f32 distance; master parameters and Adam moments stay f32
    (the sibling of ``test_bf16_train_step_of_the_model_matches_jax``)."""
    jcfg, cfg = _cfgs(**LN, **(NORM_FIRST if order == "norm-first" else {}))
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
    for g in moments["bfloat16"]:
        for k, want in moments["bfloat16"][g].items():
            spread = np.abs(_np(want) - _np(moments["float32"][g][k])).max()
            err = np.abs(_np(new.opt.mu[g][k]) - _np(want)).max()
            assert err <= spread, f"{g}/{k}: {err:.3e} > {spread:.3e}"


# -- the launch formulas ------------------------------------------------------


FORMULA_MODELS = {
    "conv-first pooled": (True, "conv_norm_relu", True),
    "conv-first strided": (False, "conv_norm_relu", True),
    "norm-first pooled pad 0": (True, "norm_conv_relu", False),
    "norm-first strided": (False, "norm_conv_relu", True),
}


@pytest.mark.parametrize("serve", [False, True], ids=["train", "serve"])
@pytest.mark.parametrize("model", list(FORMULA_MODELS))
def test_chip_smoke_launch_formulas_count_the_bf16_layer_norm_paths(
        monkeypatch, model, serve):
    """Every kernel call of a bf16 second-order train step (or a serve
    dispatch) of the layer-norm models on the Function path, counted at
    the twins, equals ``expected_train_launches`` (``expected_launches``):
    the f32 formula on the ``*_bf16`` names, the layer norm's kernels
    among them, every f32 kernel at 0."""
    max_pooling, order, padding = FORMULA_MODELS[model]
    cfg = _formula_cfg(2, 2, 1, max_pooling, order, "layer_norm").replace(
        compute_dtype="bfloat16", conv_padding=padding,
        image_height=14, image_width=14)
    smoke = _chip_smoke()
    want = (smoke.expected_launches(cfg) if serve
            else smoke.expected_train_launches(cfg, True))
    assert not any(v for k, v in want.items() if not k.endswith("_bf16"))
    for k in ("layer_norm_stats", "layer_norm_fwd", "layer_norm_bwd"):
        assert want[f"{k}_bf16"] > 0, k
    assert (want["layer_norm_bwd_bwd_bf16"] > 0) == (not serve)
    assert _count_bf16_function_path(monkeypatch, cfg, serve) == want


# -- the benches --------------------------------------------------------------


@pytest.mark.parametrize("entry", ["serve", "train"])
@pytest.mark.parametrize("order", ["conv_norm_relu", "norm_conv_relu"])
def test_benches_run_the_bf16_layer_norm_models_on_the_cpu(order, entry):
    """``serve-bench`` and ``train-bench`` with ``--norm_layer layer_norm
    --compute_dtype bfloat16`` in either block order on the CPU (the plain
    ops): one line each, the model and the dtype reported, finite losses,
    no kernel launched."""
    common = ["--fast", "--device", "cpu", "--compute_dtype", "bfloat16",
              "--norm_layer", "layer_norm", "--block_order", order]
    buf = io.StringIO()
    with redirect_stdout(buf):
        if entry == "serve":
            line = serve_bench.run(common + ["--requests", "3"])
            launches = line["kernel_launches_per_dispatch"]
        else:
            line = bench.run(common + ["--warmup", "0", "--steps", "2"])
            launches = line["kernel_launches_per_step"]
    if entry == "serve":
        assert np.isfinite(line["adaptation_latency_ms_p50"])
        assert line["tenants"] == 3
    else:
        assert line["second_order"] is True
        assert len(line["loss"]) == 2 and all(np.isfinite(line["loss"]))
    assert line["dtype"] == "bfloat16"
    assert line["norm_layer"] == "layer_norm"
    assert line["block_order"] == order
    assert {v for d in launches for v in d.values()} == {0}
