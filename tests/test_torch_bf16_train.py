"""Second-order bf16 training (``compute_dtype='bfloat16'``) of the port held
to the JAX package's bf16 on the CPU, and the pieces the card runs it on.

Parity (the plain ops, against the JAX package run eagerly, with XLA:CPU's
bf16 gradient sums swapped in at ``functional.bcast`` as in
``test_torch_bf16.py``):

* the derivative of ``lax.rsqrt``'s derivative: ``_Bf16Rsqrt``'s backward
  divides ``r / v``, and second order differentiates that quotient. PyTorch
  differentiates a division by its own rule, ``-g * ((x / y) / y)``; JAX's
  is the transpose of ``(-g * x) * integer_pow(y, -2)``, ``-((g * (1 / (y
  * y))) * x)``, each op rounded to bf16. A cast-point fault of the port,
  repaired in ``ops/functional.py`` (``_Bf16Div``): the second derivative
  of the rsqrt, of batch norm's normalize and of batch norm along each
  outer cotangent now equals JAX's bit for bit (before the repair 2.4% of
  the rsqrt's and 1.5% of batch norm's y derivative differed);
* second-order ``make_grads_fn`` meta-gradients, every leaf, for the
  conv-first batch-norm model (pad 1 and pad 0, both ``bn_stats_impl``),
  the norm-first, layer-norm and strided models; and one full bf16
  ``make_train_step`` (its Adam first moments, 0.1x the meta-gradients
  after one step from a fresh state), which keeps f32 master parameters
  and f32 Adam moments.

Bound: as ``test_torch_bf16.py``, each leaf at most 0.5x the JAX package's
own bf16-vs-f32 distance on the same inputs (max |port - jax_bf16| <= 0.5
* max |jax_bf16 - jax_f32|). One class of leaves is judged otherwise: the
conv biases (``net`` and ``lslr``) of the models whose conv feeds a batch
norm (conv first). Their meta-gradient is zero in exact arithmetic: the
batch norm subtracts each channel's batch mean, which cancels a bias. In
bf16 both the port and JAX compute a rounding residue of a sum that
cancels, and that residue depends on the order in which each autodiff
engine adds a bf16 value's gradient contributions, each add rounded: the
PyTorch autograd engine adds them in its order, JAX's transpose in
``add_any``'s. That order is no cast point and the ``bcast`` seam cannot
reach it: JAX's own bf16 second derivative of batch norm's normalize
changes with the order in which its forward computes the mean and the
variance (``test_bf16_second_derivative_follows_the_order_of_the_forward``).
Those leaves are held
to 0.5x the largest bf16-vs-f32 distance of the whole gradient tree
instead: their noise against the tree's bf16 noise. This rule and its
reason were written down before the models' test was run.

The pieces the card runs (the kernels' twins on the CPU):

* K1's stats-free mode in bf16 (``functional.conv3x3``) equals JAX
  ``_conv2d_raw`` in bf16 bit for bit, with and without the bias add, at
  pad 1 and 0;
* K5 in bf16 (``functional.bn_act_pool_bwd_bwd``) equals the f32 formulas
  on the bf16 inputs with the masks of K2's bf16 chain, each output
  rounded once;
* the bf16 Function block (``conv_block.function_block`` on the twins)
  gives the plain bf16 second-order loss and meta-gradients within 2x the
  plain path's own bf16-vs-f32 distance per leaf (the Function block
  rounds at the kernels' cast points, not at every op; the conv biases as
  above);
* the launch formulas of ``chip_smoke.py`` count the bf16 Function path
  on the ``*_bf16`` names;
* ``train-bench`` and ``serve-bench --compute_dtype bfloat16`` on the
  CPU, padded and unpadded.
"""

import collections
import importlib.util
import os

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
from test_torch_bf16 import BOUND, _from_jax, xla_cpu_sums  # noqa: F401
from test_torch_train import (
    FUNCTION_BLOCKS,
    TWINS,
    WEIGHTS,
    _batch,
    _cfgs,
    _jax,
    _torch,
)

torch.set_num_threads(2)

BF16 = torch.bfloat16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the models of the parity test: (stats_impl, config change)
MODELS = {
    "conv-first pad 1 twopass": ("twopass", {}),
    "conv-first pad 1 fused": ("fused", {}),
    "conv-first pad 0 twopass": ("twopass", dict(conv_padding=False)),
    "conv-first pad 0 fused": ("fused", dict(conv_padding=False)),
    "norm-first": ("twopass", dict(block_order="norm_conv_relu")),
    "layer-norm": ("twopass", dict(norm_layer="layer_norm")),
    "strided": ("twopass", dict(max_pooling=False)),
}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _cancelled(cfg, key):
    """A conv bias whose meta-gradient a batch norm cancels: the model's
    conv feeds a batch norm (conv first)."""
    return (cfg.norm_layer == "batch_norm"
            and cfg.block_order == "conv_norm_relu"
            and key.endswith(".conv.bias"))


def _hold_tree(cfg, got, want, want32):
    """Every leaf of ``{group: {key: array}}`` within BOUND of its own
    bf16-vs-f32 distance, the cancelled conv biases within BOUND of the
    tree's largest."""
    spreads = {(g, k): np.abs(_np(want[g][k]) - _np(want32[g][k])).max()
               for g in want for k in want[g]}
    tree = max(spreads.values())
    for (g, k), spread in spreads.items():
        err = np.abs(_np(got[g][k]) - _np(want[g][k])).max()
        limit = BOUND * (tree if _cancelled(cfg, k) else spread)
        assert err <= limit, f"{g}/{k}: {err:.3e} > {limit:.3e}"


def _jax_grads(jcfg, jstate, batch):
    with jax.disable_jit():
        loss, grads = jax_maml.make_grads_fn(jcfg, True)(
            jstate, *_jax(batch), jnp.asarray(WEIGHTS))
    return float(loss), jax.device_get(grads)


# -- the cast point: the derivative of the rsqrt's derivative -----------------


def _jax_norm(piece, y, gamma, beta, var_first=False):
    """JAX's bf16 forward of ``piece`` (its f32 ``sum(out * ct)`` is the
    test's loss); the statistics in ``batch_norm``'s order, the mean
    first, or with ``var_first`` the variance first."""
    y = y.astype(jnp.bfloat16)
    axes = (0, 1, 2)
    if piece == "batch norm":
        out, _, _ = JF.batch_norm(y, gamma, beta, None, None)
        return out
    if var_first:
        rstd = jax.lax.rsqrt(jnp.var(y, axis=axes) + 1e-5)
        mean = jnp.mean(y, axis=axes)
    else:
        mean = jnp.mean(y, axis=axes)
        rstd = jax.lax.rsqrt(jnp.var(y, axis=axes) + 1e-5)
    if piece == "rsqrt":
        return y * rstd
    return (y - mean) * rstd


def _port_norm(piece, y, gamma, beta):
    y = y.to(BF16)
    if piece == "batch norm":
        return F.batch_norm(y, gamma, beta, None, None)[0]
    mean, var = F.batch_stats(y)
    rstd = F._per_channel(F.rsqrt_eps(var, F.BN_EPS), y)
    if piece == "rsqrt":
        return y * rstd
    return (y - F._per_channel(mean, y)) * rstd


def _norm_inputs(cotangent):
    rng = np.random.RandomState(1)
    C = 6
    y = (rng.randn(5, 8, 8, C) * 1.3 + 0.2).astype(np.float32)
    gamma = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    beta = (0.1 * rng.randn(C)).astype(np.float32)
    ct = rng.randn(5, 8, 8, C).astype(np.float32)
    vy = rng.randn(*y.shape).astype(np.float32) * (cotangent == "y")
    vg = rng.randn(C).astype(np.float32) * (cotangent == "gamma")
    return y, gamma, beta, ct, vy, vg


def _jax_second(piece, cotangent, var_first=False):
    """JAX's bf16 second derivative of ``piece`` (``_norm_inputs``): the
    gradient of ``<v, grad loss>`` with respect to y and gamma."""
    y, gamma, beta, ct, vy, vg = _norm_inputs(cotangent)

    def loss(y, g, b):
        out = _jax_norm(piece, y, g, b, var_first)
        return jnp.sum(out.astype(jnp.float32) * ct)

    def outer(y, g, b):
        gy, gg = jax.grad(loss, argnums=(0, 1))(y, g, b)
        return jnp.sum(gy * vy) + jnp.sum(gg * vg)

    with jax.disable_jit():
        return jax.grad(outer, argnums=(0, 1))(
            *map(jnp.asarray, (y, gamma, beta)))


@pytest.mark.usefixtures("xla_cpu_sums")
@pytest.mark.parametrize("piece,cotangent", [
    ("rsqrt", "y"), ("normalize", "y"), ("batch norm", "y"),
    ("batch norm", "gamma")])
def test_bf16_batch_norm_second_derivative_equals_jax(piece, cotangent):
    """The second derivative (the gradient of ``<v, grad loss>``) of
    ``y * rsqrt(var(y) + eps)``, of batch norm's normalize and of batch
    norm (along the outer cotangent of y, or of gamma, alone) in bf16
    equals the JAX package's bit for bit, the derivative of the division
    in ``lax.rsqrt``'s derivative taken by JAX's rule (``_Bf16Div``)."""
    y, gamma, beta, ct, vy, vg = _norm_inputs(cotangent)
    want = _jax_second(piece, cotangent)
    ts = [torch.from_numpy(a.copy()).requires_grad_(True)
          for a in (y, gamma, beta)]
    out = _port_norm(piece, *ts)
    assert out.dtype == BF16
    gy, gg = torch.autograd.grad((out.float() * torch.from_numpy(ct)).sum(),
                                 ts[:2], create_graph=True, allow_unused=True)
    outer = (gy * torch.from_numpy(vy)).sum()
    if gg is not None:
        outer = outer + (gg * torch.from_numpy(vg)).sum()
    got = torch.autograd.grad(outer, ts[:2], allow_unused=True)
    for name, a, b in zip(("y", "gamma"), got, want):
        b = _np(b)
        a = np.zeros_like(b) if a is None else _np(a)
        assert np.abs(b).max() > 0 or name == "gamma"
        assert np.array_equal(a, b), (
            f"{name}: {(a != b).mean():.1%} of the elements differ")


def test_bf16_second_derivative_follows_the_order_of_the_forward():
    """Why the cancelled conv biases are judged against the tree: JAX's own
    bf16 second derivative of batch norm's normalize changes when its
    forward computes the variance before the mean, the same function (on
    about a fifth of the elements here): the order of the forward decides
    the order in which the transpose adds each bf16 value's gradient
    contributions, each add rounded. The port's statistics follow
    ``batch_norm``'s order, the mean first."""
    mean_first, _ = _jax_second("normalize", "y")
    var_first, _ = _jax_second("normalize", "y", var_first=True)
    differ = float(np.mean(_np(mean_first) != _np(var_first)))
    assert differ > 0.05, differ


# -- the models -----------------------------------------------------------------


@pytest.mark.usefixtures("xla_cpu_sums")
@pytest.mark.parametrize("model", list(MODELS))
def test_second_order_meta_grads_bf16_match_jax(model):
    """The port's plain bf16 second-order meta-gradients (2 inner steps, 2
    stages, MSL, per-step BN) against the JAX package's bf16, every
    ``net`` and ``lslr`` leaf, within the module docstring's bound; the
    loss equal to JAX's within a bf16-free rtol (it is f32 of the same bf16
    logits)."""
    stats_impl, change = MODELS[model]
    jcfg, cfg = _cfgs(stats_impl, **change)
    jstate = jax_maml.init_state(jcfg, seed=4)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    batch = _batch(cfg, 1)
    _, want32 = _jax_grads(jcfg, jstate, batch)
    jloss, want = _jax_grads(jcfg.replace(compute_dtype="bfloat16"), jstate,
                             batch)
    loss, got = maml.make_grads_fn(cfg.replace(compute_dtype="bfloat16"),
                                   True)(state, *_torch(batch), WEIGHTS)
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-6)
    assert {v.dtype for part in got.values() for v in part.values()} \
        == {torch.float32}
    _hold_tree(cfg, got, want, want32)


@pytest.mark.usefixtures("xla_cpu_sums")
@pytest.mark.parametrize("conv_padding", [True, False],
                         ids=["pad 1", "pad 0"])
def test_bf16_train_step_matches_jax(conv_padding):
    """One full bf16 ``make_train_step`` (second order, Adam from a fresh
    state) against the JAX package's: the loss, and the Adam first moments
    (0.1 times the step's meta-gradients) within the module docstring's
    bound; master parameters and Adam moments stay f32."""
    jcfg, cfg = _cfgs(conv_padding=conv_padding)
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
    _hold_tree(cfg, new.opt.mu, moments["bfloat16"], moments["float32"])


# -- the kernels' twins -----------------------------------------------------------


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no bias"])
@pytest.mark.parametrize("padding", [1, 0])
def test_k1_stats_free_bf16_twin_equals_jax(padding, bias):
    """K1's stats-free twin in bf16 (the f32 sum of bf16 products rounded
    once, the bias add rounded again) equals JAX ``_conv2d_raw`` in bf16
    bit for bit, per tenant."""
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 3, 9, 9, 5)).astype(np.float32)
    w = (rng.randn(2, 3, 3, 5, 7) * 0.3).astype(np.float32)
    b = (rng.randn(2, 7) * 0.5).astype(np.float32)
    got = F.conv3x3(*(torch.from_numpy(a).to(BF16) for a in (x, w)),
                    torch.from_numpy(b).to(BF16) if bias else None,
                    padding=padding)
    assert got.dtype == BF16
    assert torch.equal(got, cb.conv3x3_fwd(
        *(torch.from_numpy(a).to(BF16) for a in (x, w)),
        torch.from_numpy(b).to(BF16) if bias else None, padding=padding))
    for t in range(2):
        want = JF._conv2d_raw(
            *(jnp.asarray(a[t]).astype(jnp.bfloat16) for a in (x, w)),
            jnp.asarray(b[t]).astype(jnp.bfloat16) if bias else None, 1,
            padding, "im2col", "off")
        assert torch.equal(got[t], _from_jax(want))


def _k5_inputs(seed, h=9):
    """bf16 K5 inputs at an odd map (the pool drops the last row and
    column): y, its K1 statistics, gamma, beta, K2's argmax, a pooled
    gradient and the three cotangents."""
    rng = np.random.RandomState(seed)
    T, N, C = 2, 3, 6

    def bf(*shape, scale=1.0, shift=0.0):
        return (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                * scale + shift).to(BF16)

    y = bf(T, N, h, h, C, scale=1.5, shift=0.2)
    mean, _, rstd = F.bn_stats(y)
    gamma, beta = bf(T, C, scale=0.1, shift=1.0), bf(T, C, scale=0.3)
    _, arg = F.bn_act_pool_fwd(y, mean, rstd, gamma, beta)
    dp = bf(T, N, h // 2, h // 2, C)
    a, ggamma, gbeta = bf(*y.shape), bf(T, C), bf(T, C)
    return a, ggamma, gbeta, dp, arg, y, mean, rstd, gamma, beta


def test_k5_bf16_twin_is_the_f32_formulas_with_the_bf16_chain_masks(
        monkeypatch):
    """K5's bf16 twin equals the f32 twin on the same bf16 inputs (upcast)
    with its leaky-ReLU masks taken from K2's bf16 chain and the slope
    rounded to bf16, each of
    ``g_dpooled``, ``g_y`` and ``g_gamma`` rounded once to bf16; the masks
    of an f32 chain differ on these inputs, so the chain matters."""
    args = _k5_inputs(3)
    a, ggamma, gbeta, dp, arg, y, mean, rstd, gamma, beta = args
    got = F.bn_act_pool_bwd_bwd(*args)
    assert [g.dtype for g in got] == [BF16] * 3
    chain_z = F._affine_act(y, mean, rstd, gamma, beta)[1]
    f32_z = F._affine_act(*(v.float() for v in (y, mean, rstd, gamma,
                                                beta)))[1]
    assert ((chain_z >= 0) != (f32_z >= 0)).any()
    affine = F._affine_act
    monkeypatch.setattr(F, "_affine_act",
                        lambda *v: (None, chain_z.float()))
    # the slope as the bf16 twin takes it, rounded to bf16
    want = F.bn_act_pool_bwd_bwd(*(v if v.dtype == torch.uint8 else v.float()
                                   for v in args),
                                 negative_slope=F.scalar_like(F.LEAKY_SLOPE,
                                                              y))
    monkeypatch.setattr(F, "_affine_act", affine)
    for g, w in zip(got, want):
        assert w.dtype == torch.float32
        assert torch.equal(g, w.to(BF16))
    # the wrapper takes the twin for a CPU tensor
    for g, w in zip(cb.bn_act_pool_bwd_bwd(*args), got):
        assert torch.equal(g, w)


# -- the Function block on the twins ---------------------------------------------


def _tree_spread(a, b):
    return {g: {k: float((a[g][k] - b[g][k]).abs().max()) for k in a[g]}
            for g in a}


@pytest.mark.parametrize("conv_padding", [True, False],
                         ids=["pad 1", "pad 0"])
def test_bf16_function_block_gives_the_plain_meta_grads(conv_padding):
    """The learner on the hand-written Function block in bf16 (the card's
    structure, on the twins here) against the plain bf16 block, second
    order. The Function block rounds at the kernels' cast points, once per
    kernel, where the plain graph rounds after every op: two bf16 roundings
    of one function, each its own distance from f32, so the bound is the
    card's bf16 serve gate (``chip_smoke.check_bf16_serve``): the loss and
    each leaf within 2x the plain path's own bf16-vs-f32 distance, the
    cancelled conv biases within 2x the tree's largest."""
    _, cfg = _cfgs(conv_padding=conv_padding)
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    state = state_lib.init_state(cfg, seed=2, device="cpu")
    batch = _torch(_batch(cfg, 2))
    loss32, plain32 = maml.make_grads_fn(cfg, True)(state, *batch, WEIGHTS)
    loss, plain = maml.make_grads_fn(cfg16, True)(state, *batch, WEIGHTS)
    floss, fgrads = maml.make_grads_fn(
        cfg16, True, block=cb.function_block)(state, *batch, WEIGHTS)
    assert abs(float(floss) - float(loss)) \
        <= 2 * abs(float(loss) - float(loss32))
    spread = _tree_spread(plain, plain32)
    err = _tree_spread(fgrads, plain)
    tree = max(v for part in spread.values() for v in part.values())
    for g in spread:
        for k, s in spread[g].items():
            assert fgrads[g][k].dtype == torch.float32
            limit = 2 * (tree if _cancelled(cfg, k) else s)
            assert err[g][k] <= limit, (g, k, err[g][k], limit)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _count_bf16_function_path(monkeypatch, cfg, serve=False):
    """Every kernel call of one second-order train step (with ``serve``,
    one serve dispatch) on the bf16 Function path of the config's block
    order, counted at the twins the wrappers take on the CPU (a twin that
    calls another counts once), on ``<name>_bf16`` for a bf16 call."""
    calls = collections.Counter()
    depth = [0]
    for twin, kernel in TWINS.items():
        def counted(*a, _f=getattr(F, twin), _k=kernel, **kw):
            if depth[0] == 0:
                name = (cb._conv_name(_k, kw.get("stride", 1),
                                      kw.get("padding", 1))
                        if _k.startswith("conv3x3") else _k)
                dtype = next(v.dtype for v in a
                             if isinstance(v, torch.Tensor))
                calls[name + ("_bf16" if dtype == BF16 else "")] += 1
            depth[0] += 1
            try:
                return _f(*a, **kw)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(F, twin, counted)
    state = state_lib.init_state(cfg, device="cpu", with_opt=True)
    batch = bench.synth_batch(cfg, 0, torch.device("cpu"))
    steps = cfg.number_of_training_steps_per_iter
    block = FUNCTION_BLOCKS[(cfg.block_order, cfg.norm_layer)]
    if serve:
        maml.make_serve_step(cfg, block=block)(
            state, *batch, torch.ones(cfg.batch_size))
    else:
        maml.make_train_step(cfg, True, block=block)(
            state, *batch, np.ones(steps, np.float32) / steps, 1e-3)
    return {k: calls[k] for k in cb.KERNELS}


def _formula_cfg(conv_padding, accum=1):
    from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig

    return MAMLConfig(
        dataset_name="omniglot_dataset", image_height=12, image_width=12,
        image_channels=1, num_classes_per_set=2, num_samples_per_class=1,
        num_target_samples=1, batch_size=2, cnn_num_filters=3, num_stages=2,
        max_pooling=True, per_step_bn_statistics=True,
        learnable_per_layer_per_step_inner_loop_learning_rate=True,
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2, meta_accum_steps=accum,
        conv_padding=conv_padding, compute_dtype="bfloat16")


@pytest.mark.parametrize("conv_padding,accum", [(True, 1), (False, 2)],
                         ids=["pad 1", "pad 0 accum 2"])
def test_chip_smoke_launch_formula_counts_the_bf16_function_path(
        monkeypatch, conv_padding, accum):
    """Every kernel call of a bf16 second-order train step on the Function
    path, counted at the twins, equals ``expected_train_launches``: the
    f32 formula on the ``*_bf16`` names (the pad-0 convs on
    ``conv3x3_p0_*_bf16``), every f32 kernel at 0."""
    cfg = _formula_cfg(conv_padding, accum)
    want = _chip_smoke().expected_train_launches(cfg, True)
    assert want["conv3x3_fwd_bf16" if conv_padding
                else "conv3x3_p0_fwd_bf16"] > 0
    assert want["bn_act_pool_bwd_bwd_bf16"] > 0
    assert not any(v for k, v in want.items() if not k.endswith("_bf16"))
    assert _count_bf16_function_path(monkeypatch, cfg) == want


def test_chip_smoke_serve_launch_formula_counts_the_unpadded_bf16_path(
        monkeypatch):
    """One serve dispatch of the unpadded bf16 model on the Function path
    equals ``expected_launches``: K1 with statistics, K2, K3, dgrad and
    wgrad on the ``conv3x3_p0_*_bf16`` / ``*_bf16`` names."""
    cfg = _formula_cfg(False)
    want = _chip_smoke().expected_launches(cfg)
    assert want["conv3x3_p0_fwd_stats_bf16"] > 0
    assert _count_bf16_function_path(monkeypatch, cfg, serve=True) == want


# -- the benches ------------------------------------------------------------------


@pytest.mark.parametrize("padding", ["true", "false"],
                         ids=["pad 1", "pad 0"])
def test_train_bench_bf16_second_order_on_the_cpu(padding):
    """``train-bench --fast --device cpu --compute_dtype bfloat16`` (and
    ``--conv_padding false``) trains second order: one line, finite
    losses, no kernel launched (the plain ops ran)."""
    line = bench.run(["--fast", "--device", "cpu", "--warmup", "0",
                      "--steps", "2", "--compute_dtype", "bfloat16",
                      "--conv_padding", padding])
    assert line["dtype"] == "bfloat16" and line["second_order"] is True
    assert line["conv_padding"] is (padding == "true")
    assert len(line["loss"]) == 2 and all(np.isfinite(line["loss"]))
    assert {v for step in line["kernel_launches_per_step"]
            for v in step.values()} == {0}


def test_serve_bench_unpadded_bf16_on_the_cpu():
    """``serve-bench --compute_dtype bfloat16 --conv_padding false`` serves
    on the CPU (finite latency, the dtype and the pad reported)."""
    line = serve_bench.run(["--fast", "--device", "cpu", "--requests", "3",
                            "--compute_dtype", "bfloat16", "--conv_padding",
                            "false"])
    assert line["dtype"] == "bfloat16" and line["conv_padding"] is False
    assert np.isfinite(line["adaptation_latency_ms_p50"])
