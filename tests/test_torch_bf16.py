"""``compute_dtype='bfloat16'`` held to the JAX package's bf16 on the CPU.

The port follows the JAX package's bf16 cast points: f32 parameters cast
to bf16 where they are used (conv weight and bias, gamma and beta, the
head), bf16 activations, every elementwise op rounded to bf16 (Python
scalars rounded to bf16 first, as JAX's weak types are: the leaky slope is
0.010009765625 and ``eps`` bf16(1e-5)), the batch statistics as
``jnp.mean`` / ``jnp.var`` compute them (f32 sums about the f32 mean, each
rounded once), ``rsqrt`` of the bf16 ``var + eps`` rounded once, logits
and the loss in f32, and the gradients of the f32 leaves the bf16
cotangents cast to f32. XLA:CPU sums a bf16 ``reduce_sum`` in a bf16
accumulator, one row at a time; every bf16 gradient the JAX package takes
on the CPU sums that way (the transpose of each broadcast). The port sums
those gradients in f32, as XLA on an accelerator and the kernels do, so
the parity tests below swap XLA:CPU's sum in at the port's one broadcast
seam (``functional.bcast``, ``xla_cpu_sums``) for their comparison with
JAX; the package itself keeps its f32 sums.

Bound, fixed before the repair: each output of the port at most 0.5x the
JAX package's own bf16-vs-f32 distance on the same inputs (max |port -
jax_bf16| <= 0.5 * max |jax_bf16 - jax_f32|, per array: the logits, each
BN state leaf, each gradient leaf; the serve step's preds and loss). The
repaired port meets it with room: on these inputs it equals the JAX
package's bf16 bit for bit. The JAX side runs eagerly (``jax.disable_jit``)
so that no fusion reorders its bf16 arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from howtotrainyourmamlpytorch_tpu.core import maml as jax_maml
from howtotrainyourmamlpytorch_tpu.models import vgg as jax_vgg
from howtotrainyourmamlpytorch_tpu.ops import functional as JF
from howtotrainyourmamlpytorch_tpu_torch import state as state_lib
from howtotrainyourmamlpytorch_tpu_torch.core import maml
from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block as cb
from howtotrainyourmamlpytorch_tpu_torch.models import vgg
from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F
from howtotrainyourmamlpytorch_tpu_torch.serving import bench
from test_torch_model import _cfgs, _state
from test_torch_serve import _batch
from test_torch_serve import _cfgs as _serve_cfgs

torch.set_num_threads(2)

BF16 = torch.bfloat16
#: the port's distance to JAX's bf16 over JAX's own bf16-vs-f32 distance
BOUND = 0.5

MODELS = {
    "conv-first": {},
    "norm-first": dict(block_order="norm_conv_relu"),
    "layer-norm": dict(norm_layer="layer_norm"),
    "layer-norm norm-first": dict(norm_layer="layer_norm",
                                  block_order="norm_conv_relu"),
}
GEOMETRIES = {
    "pooled pad 1": {},
    "pooled pad 0": dict(conv_padding=False),
    "strided": dict(max_pooling=False),
}


class _XlaCpuBf16Broadcast(torch.autograd.Function):
    """``v`` expanded to ``shape``, whose backward sums the cotangent over
    the broadcast axes as XLA:CPU's bf16 ``reduce_sum`` does: a bf16
    accumulator, one row at a time in row-major order (2-11% off the f32
    sum at 500-176,000 terms)."""

    @staticmethod
    def forward(ctx, v, shape):
        ctx.v_shape = v.shape
        return v.expand(shape)

    @staticmethod
    def backward(ctx, g):
        v_shape = (1,) * (g.dim() - len(ctx.v_shape)) + tuple(ctx.v_shape)
        axes = [d for d in range(g.dim())
                if v_shape[d] == 1 and g.shape[d] > 1]
        keep = [d for d in range(g.dim()) if d not in axes]
        rows = g.permute(*axes, *keep).reshape(
            -1, *(g.shape[d] for d in keep)).float()
        acc = torch.zeros_like(rows[0])
        for row in rows:
            acc = (acc + row).to(BF16).float()
        out = acc.to(g.dtype).reshape(
            [g.shape[d] if d in keep else 1 for d in range(g.dim())])
        return out.reshape(ctx.v_shape), None


def _xla_cpu_bcast(v, x):
    """``functional.bcast`` with XLA:CPU's bf16 gradient sum for a bf16
    operand that needs a gradient."""
    if v.dtype == BF16 and v.requires_grad and torch.is_grad_enabled():
        return _XlaCpuBf16Broadcast.apply(v, x.shape)
    return v


@pytest.fixture
def xla_cpu_sums(monkeypatch):
    """The port's plain ops with XLA:CPU's bf16 gradient sums, for the
    comparisons with the JAX package on the CPU."""
    monkeypatch.setattr(F, "bcast", _xla_cpu_bcast)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _within_bound(got, want, want32, what):
    """max |got - want| <= BOUND * max |want - want32|."""
    got, want, want32 = _np(got), _np(want), _np(want32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    spread = np.abs(want - want32).max()
    assert err <= BOUND * spread, f"{what}: {err:.3e} > {BOUND} x {spread:.3e}"


def _from_jax(a):
    """A JAX array as a torch tensor of its dtype (bf16 through f32)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(_np(a).astype(np.float32)).to(BF16)
    return torch.from_numpy(np.array(a))


def _jax_apply(jcfg, net, bn, x, ct, step):
    def fn(params):
        logits, new_bn = jax_vgg.apply(
            jcfg, params, {k: jnp.asarray(v) for k, v in bn.items()},
            jnp.asarray(x), step)
        return jnp.sum(logits * ct), (logits, new_bn)

    with jax.disable_jit():
        grads, (logits, new_bn) = jax.grad(fn, has_aux=True)(
            {k: jnp.asarray(v) for k, v in net.items()})
    return logits, new_bn, grads


@pytest.mark.usefixtures("xla_cpu_sums")
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("model", list(MODELS))
def test_apply_bf16_matches_jax(model, geometry):
    """Logits, the returned BN state and d(logits . ct)/dparams of
    ``vgg.apply`` in bf16 against ``jax_vgg.apply`` in bf16, within half
    the JAX package's own bf16-vs-f32 distance (every model the port
    accepts: both block orders, both norm layers, pooled at pad 1 and 0,
    strided)."""
    change = {**MODELS[model], **GEOMETRIES[geometry]}
    jcfg, cfg = _cfgs(10, "twopass", **change)
    jcfg16 = jcfg.replace(compute_dtype="bfloat16")
    cfg16 = cfg.replace(compute_dtype="bfloat16")
    net, bn = _state(jcfg)
    rng = np.random.RandomState(5)
    x = rng.randn(5, 10, 10, 3).astype(np.float32)
    ct = rng.randn(5, 3).astype(np.float32)
    logits32, bn32, grads32 = _jax_apply(jcfg, net, bn, x, ct, 1)
    jlogits, jbn, jgrads = _jax_apply(jcfg16, net, bn, x, ct, 1)
    params = {k: torch.from_numpy(v.copy()).requires_grad_(True)
              for k, v in net.items()}
    logits, new_bn = vgg.apply(cfg16, params,
                               {k: torch.from_numpy(v) for k, v in
                                bn.items()}, torch.from_numpy(x), 1)
    assert logits.dtype == torch.float32
    grads = torch.autograd.grad((logits * torch.from_numpy(ct)).sum(),
                                list(params.values()), allow_unused=True)
    _within_bound(logits, jlogits, logits32, "logits")
    assert sorted(new_bn) == sorted(jbn)
    for k in jbn:
        assert new_bn[k].dtype == torch.float32
        _within_bound(new_bn[k], jbn[k], bn32[k], k)
    for k, g in zip(params, grads):
        g = torch.zeros_like(params[k]) if g is None else g
        assert g.dtype == torch.float32
        _within_bound(g, jgrads[k], grads32[k], f"grad {k}")


@pytest.mark.usefixtures("xla_cpu_sums")
@pytest.mark.parametrize("stats_impl", ["twopass", "fused"])
@pytest.mark.parametrize("model", ["conv-first", "norm-first"])
def test_serve_step_bf16_matches_jax(model, stats_impl):
    """The bf16 serve step (2 first-order inner steps, tenant axis, a zero
    pad tenant) against the JAX package's ``make_serve_step`` in bf16:
    preds and loss within half its own bf16-vs-f32 distance."""
    jcfg, cfg = _serve_cfgs(stats_impl, **MODELS[model])
    jstate = jax_maml.init_state(jcfg, seed=4)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    batch = _batch(cfg, tenants=2, shots=2, pad=1, seed=3)
    outs = {}
    for dtype in ("float32", "bfloat16"):
        with jax.disable_jit():
            _, outs[dtype] = jax_maml.make_serve_step(
                jcfg.replace(compute_dtype=dtype))(
                    jstate, *[jnp.asarray(a) for a in batch])
    _, out = maml.make_serve_step(cfg.replace(compute_dtype="bfloat16"))(
        state, *[torch.from_numpy(a) for a in batch])
    real = slice(0, 2)
    for key in ("preds", "loss"):
        _within_bound(out[key][real], outs["bfloat16"][key][real],
                      outs["float32"][key][real], key)
    assert torch.isfinite(out["preds"]).all()


# -- the cast points, one case each -------------------------------------------


def _bf16_array(rng, *shape, scale=1.0, shift=0.0):
    return jnp.asarray((rng.randn(*shape) * scale + shift).astype(
        np.float32)).astype(jnp.bfloat16)


def test_block_output_stays_bf16():
    """The block on bf16 x, w, b with f32 gamma and beta returns bf16 (the
    kernel twins cast gamma and beta to the activation's dtype, as the
    JAX package's batch norm does), its statistics bf16 too; so does the
    plain block."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 3, 8, 8, 3).astype(np.float32))
    w = torch.from_numpy(rng.randn(2, 3, 3, 3, 4).astype(np.float32) * 0.3)
    b = torch.zeros(2, 4)
    gamma, beta = torch.ones(4), torch.zeros(4)
    for block in (cb.function_block, F.conv_bn_act_pool):
        out, mean, var = block(x.to(BF16), w.to(BF16), b.to(BF16), gamma,
                               beta)
        assert out.dtype == mean.dtype == var.dtype == BF16, block


def test_batch_stats_are_the_f32_variance_rounded_once():
    """``batch_stats`` and ``bn_stats`` in bf16: the f32 mean and the f32
    variance about the f32 mean, each rounded once to bf16 (not the
    variance of bf16 deviations from a bf16 mean), as ``jnp.mean`` and
    ``jnp.var``; rstd the f32 rsqrt of bf16(var + bf16(eps)), rounded once,
    as ``lax.rsqrt``."""
    rng = np.random.RandomState(1)
    # a mean far from 0, so that the bf16 mean's rounding moves the
    # bf16-centred variance
    xj = _bf16_array(rng, 4, 8, 8, 16, scale=2.0, shift=5.0)
    x = _from_jax(xj)
    x32 = x.float()
    mean32 = x32.mean((0, 1, 2))
    want_var = ((x32 - mean32) ** 2).mean((0, 1, 2)).to(BF16)
    mean, var = F.batch_stats(x)
    assert torch.equal(mean, mean32.to(BF16))
    assert torch.equal(var, want_var)
    assert not torch.equal(var, ((x - mean) ** 2).mean((0, 1, 2)))
    jmean, jvar = jnp.mean(xj, axis=(0, 1, 2)), jnp.var(xj, axis=(0, 1, 2))
    assert torch.equal(var, _from_jax(jvar))
    assert torch.equal(mean, _from_jax(jmean))
    t_mean, t_var, t_rstd = F.bn_stats(x.unsqueeze(0))
    assert torch.equal(t_mean[0], mean) and torch.equal(t_var[0], var)
    assert torch.equal(t_rstd[0], _from_jax(lax.rsqrt(jvar + 1e-5)))


def test_leaky_relu_bf16_equals_jax():
    """The slope rounded to bf16 before the multiply (JAX's weak type):
    ``leaky_relu`` equals ``jax.nn.leaky_relu`` bit for bit, where the f32
    slope would differ on part of the negative side."""
    xj = _bf16_array(np.random.RandomState(2), 4096, scale=3.0)
    x = _from_jax(xj)
    want = _from_jax(jax.nn.leaky_relu(xj, 0.01))
    assert torch.equal(F.leaky_relu(x), want)
    assert not torch.equal(torch.where(x >= 0, x, 0.01 * x), want)
    assert F.scalar_like(0.01, x) == 0.010009765625


def test_k2_twin_equals_jax_chain():
    """Given the same bf16 conv output y, the K2 twin (``bn_stats`` +
    ``bn_act_pool_fwd``) equals the JAX package's ``batch_norm`` ->
    ``leaky_relu`` -> ``max_pool2d(impl='reduce_window')`` bit for bit, and
    its argmax picks the first maximum of each window as
    ``reduce_window``'s gradient does."""
    rng = np.random.RandomState(3)
    yj = _bf16_array(rng, 3, 9, 9, 6, scale=1.5, shift=0.3)
    gamma = (1 + 0.1 * rng.randn(6)).astype(np.float32)
    beta = (0.1 * rng.randn(6)).astype(np.float32)
    with jax.disable_jit():
        z, _, _ = JF.batch_norm(yj, jnp.asarray(gamma), jnp.asarray(beta),
                                None, None)
        want = JF.max_pool2d(JF.leaky_relu(z), impl="reduce_window")
    y = _from_jax(yj).unsqueeze(0)
    mean, _, rstd = F.bn_stats(y)
    g, b = (torch.from_numpy(v)[None] for v in (gamma, beta))
    pooled, arg = F.bn_act_pool_fwd(y, mean, rstd, g, b)
    assert pooled.dtype == BF16
    assert torch.equal(pooled[0], _from_jax(want))
    act = F.bn_act_fwd(y, mean, rstd, g, b)
    win = F._windows(act)
    first = (win == pooled.unsqueeze(-1)).int().argmax(-1)
    assert torch.equal(arg.long(), first.long())


def test_bf16_reductions_follow_each_form():
    """What the two bf16 sums are: XLA:CPU's bf16 ``reduce_sum`` (every
    bf16 gradient the JAX package takes on the CPU) accumulates in bf16 one
    row at a time, as ``_xla_cpu_bcast``'s gradient does; the port's plain
    ops (``functional.bcast``), the K3 twin and the K3 kernel sum in f32
    and round once, as XLA on an accelerator does."""
    rng = np.random.RandomState(4)
    gj = _bf16_array(rng, 5, 7, 7, 6)
    g = _from_jax(gj)
    f32_sum = g.float().sum((0, 1, 2)).to(BF16)
    grads = {}
    for name, fn in (("xla", _xla_cpu_bcast), ("port", F.bcast)):
        v = torch.zeros(6, dtype=BF16, requires_grad=True)
        (grads[name],) = torch.autograd.grad((fn(v, g) * g).sum(), [v])
    assert torch.equal(grads["xla"], _from_jax(lax.reduce_sum(gj, (0, 1, 2))))
    assert not torch.equal(grads["xla"], f32_sum)
    assert torch.equal(grads["port"], f32_sum)
    # K3's twin: dbeta is sum(dz), dz = dpooled at each argmax
    y = _from_jax(_bf16_array(rng, 1, 5, 8, 8, 6))
    mean, _, rstd = F.bn_stats(y)
    ones, zeros = torch.ones(1, 6, dtype=BF16), torch.zeros(1, 6, dtype=BF16)
    _, arg = F.bn_act_pool_fwd(y, mean, rstd, ones, zeros)
    dp = _from_jax(_bf16_array(rng, 1, 5, 4, 4, 6))
    _, _, dbeta = F.bn_act_pool_bwd(dp, arg, y, mean, rstd, ones, zeros)
    z = F.bn_act_fwd(y, mean, rstd, ones, zeros)
    dz = F._leaky_masked(F._unpool(dp, arg, 8, 8).float(), z,
                         F.scalar_like(0.01, y))
    assert dbeta.dtype == BF16
    assert torch.equal(dbeta, dz.sum((1, 2, 3)).to(BF16))


# -- the card's dtype guards, through the guard functions ---------------------


def test_bf16_guards_name_the_missing_kernel():
    """On the card a bf16 tensor reaches every kernel (each has a bf16
    version: the batch-norm models' and, since the layer-norm models run
    in bf16 too, the layer norm's four); any other dtype raises
    ``TypeError`` naming the kernel, and ``_check_block_input`` passes
    every block in bf16, the layer-norm blocks among them, pooled and
    strided, and refuses a block in another dtype, naming its kernels."""
    x = torch.zeros(1, 2, 6, 6, 3, dtype=BF16)
    assert cb.BF16_KERNELS == tuple(k for k in cb.KERNELS
                                    if not k.endswith("_bf16"))
    for name in cb.BF16_KERNELS:
        assert f"{name}_bf16" in cb.KERNELS
        assert cb.kernel_dtype(name, x) == BF16
        assert cb.kernel_dtype(name, x.float()) == torch.float32
    for name in ("conv3x3_s2_fwd", "bn_act_bwd_bwd", "conv3x3_s2_p0_wgrad",
                 "global_avg_pool2d_fwd", "bn_input_stats", "batch_norm_bwd",
                 "act_pool_gather", "act_fwd", "layer_norm_stats",
                 "layer_norm_fwd", "layer_norm_bwd", "layer_norm_bwd_bwd"):
        assert name in cb.BF16_KERNELS
    for dtype in (torch.float64, torch.float16):
        for name in ("conv3x3_fwd_stats", "layer_norm_stats"):
            with pytest.raises(TypeError,
                               match=f"^{name}: .*float32 or bfloat16"):
                cb.kernel_dtype(name, x.to(dtype))
    kernels = ("conv3x3_fwd_stats", "bn_act_pool_fwd", "bn_act_pool_bwd",
               "conv3x3_dgrad", "conv3x3_wgrad", "conv3x3_fwd",
               "bn_act_pool_bwd_bwd")
    pool_free = ("conv3x3_fwd_stats", "bn_act_fwd", "bn_act_bwd",
                 "conv3x3_dgrad", "conv3x3_wgrad", "conv3x3_fwd",
                 "bn_act_bwd_bwd")
    norm_first = ("bn_input_stats", "batch_norm_fwd", "batch_norm_bwd",
                  "conv3x3_fwd", "act_pool_fwd", "act_pool_bwd",
                  "conv3x3_dgrad", "conv3x3_wgrad", "batch_norm_bwd_bwd",
                  "act_pool_gather", "act_fwd", "act_bwd")
    for padding in (1, 0):
        cb._check_block_input("conv_bn_act_pool", x, kernels, 1, padding,
                              False)
        cb._check_block_input("conv_bn_act_pool", x, pool_free, 2, padding,
                              True)
        cb._check_block_input("norm_conv_act_pool", x, norm_first, 2,
                              padding, True)
        for name in ("conv_ln_act_pool", "ln_conv_act_pool"):
            cb._check_block_input(name, x, cb._LN_BLOCK_KERNELS[True], 1,
                                  padding, False)
            cb._check_block_input(name, x, cb._LN_BLOCK_KERNELS[False], 2,
                                  padding, True)
    for pool in (True, False):
        with pytest.raises(NotImplementedError, match="layer_norm_stats"):
            cb._check_block_input("conv_ln_act_pool", x.half(),
                                  cb._LN_BLOCK_KERNELS[pool], 1, 1, False)


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_benches_take_compute_dtype(entry, capsys):
    """``--compute_dtype bfloat16`` on both benches (the plain ops on the
    CPU): the line reports the dtype, the losses are finite."""
    if entry == "serve":
        line = bench.run(["--fast", "--device", "cpu", "--requests", "3",
                          "--compute_dtype", "bfloat16"])
        assert np.isfinite(line["adaptation_latency_ms_p50"])
    else:
        from howtotrainyourmamlpytorch_tpu_torch import bench as train_bench

        line = train_bench.run(["--fast", "--device", "cpu", "--warmup",
                                "0", "--steps", "1", "--compute_dtype",
                                "bfloat16"])
        assert all(np.isfinite(v) for v in line["loss"])
    assert line["dtype"] == "bfloat16"
