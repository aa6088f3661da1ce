"""The port's ``models.vgg.apply`` held to the JAX package's on the CPU:
logits, the returned BN state and the first gradient of the logits, for
every step index including the clamp past ``bn_num_steps``, with and
without the tenant axis, both ``bn_stats_impl`` modes, and an odd image
size (11 -> conv 11 -> pool 5 -> pool 2 drops a row and a column); and
the strided model (``max_pooling=False``: 10 -> 5 -> 3 and 11 -> 6 -> 3,
then the global average pool).

Tolerances: logits and BN state 1e-5 and gradients 1e-4 of their scale
(f32, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.core import maml as jax_maml
from howtotrainyourmamlpytorch_tpu.core import partition as jax_partition
from howtotrainyourmamlpytorch_tpu.models import vgg as jax_vgg
from howtotrainyourmamlpytorch_tpu_torch import state as state_lib
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.models import vgg

torch.set_num_threads(2)

VALUE_TOL = 1e-5
GRAD_TOL = 1e-4


def _cfgs(hw, stats_impl, **extra):
    kw = dict(
        dataset_name="omniglot_dataset", image_height=hw, image_width=hw,
        image_channels=3, num_classes_per_set=3, num_samples_per_class=2,
        num_target_samples=2, batch_size=2, cnn_num_filters=6, num_stages=2,
        max_pooling=True, per_step_bn_statistics=True,
        learnable_per_layer_per_step_inner_loop_learning_rate=True,
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2, use_remat=False,
        bn_stats_impl=stats_impl,
    )
    kw.update(extra)
    return JaxConfig(**kw), MAMLConfig(**kw)


def _close(got, want, tol, what, scale=None):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max() if scale is None else scale
    err = np.abs(got - want).max()
    assert err <= tol * max(scale, 1e-30), f"{what}: {err:.3e} vs {scale:.3e}"


def _state(jcfg, seed=0):
    host = jax.device_get(jax_maml.init_state(jcfg, seed=seed))
    # perturb the BN statistics and affine so that every step index reads
    # distinct values
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


@pytest.mark.parametrize("stats_impl", ["twopass", "fused"])
@pytest.mark.parametrize("hw,max_pooling", [
    (10, True), (11, True), (10, False), (11, False)],
    ids=["10", "11", "10-strided", "11-strided"])
@pytest.mark.parametrize("step", [0, 1, 3])
def test_apply_matches_jax(stats_impl, hw, max_pooling, step):
    """Logits, new BN state and d(logits . ct)/dparams; step 3 is past
    bn_num_steps = 2 and clamps to the last step."""
    jcfg, cfg = _cfgs(hw, stats_impl, max_pooling=max_pooling)
    net, bn = _state(jcfg)
    rng = np.random.RandomState(hw + step)
    x = rng.randn(5, hw, hw, 3).astype(np.float32)
    ct = rng.randn(5, 3).astype(np.float32)

    def jax_fn(params):
        logits, new_bn = jax_vgg.apply(
            jcfg, params, {k: jnp.asarray(v) for k, v in bn.items()},
            jnp.asarray(x), step)
        return jnp.sum(logits * ct), (logits, new_bn)

    jgrad, (jlogits, jbn) = jax.grad(jax_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in net.items()})
    tparams = {k: torch.from_numpy(v).requires_grad_(True)
               for k, v in net.items()}
    tbn = {k: torch.from_numpy(v) for k, v in bn.items()}
    logits, new_bn = vgg.apply(cfg, tparams, tbn, torch.from_numpy(x), step)
    tgrad = torch.autograd.grad((logits * torch.from_numpy(ct)).sum(),
                                list(tparams.values()), allow_unused=True)
    _close(logits, jlogits, VALUE_TOL, "logits")
    assert sorted(new_bn) == sorted(jbn)
    for k in jbn:
        _close(new_bn[k], jbn[k], VALUE_TOL, k)
    gscale = max(np.abs(np.asarray(g)).max() for g in jgrad.values())
    for k, g in zip(tparams, tgrad):
        g = torch.zeros_like(tparams[k]) if g is None else g
        _close(g, jgrad[k], GRAD_TOL, f"grad {k}", gscale)


@pytest.mark.parametrize("stats_impl", ["twopass", "fused"])
def test_apply_tenant_axis_matches_jax_vmap(stats_impl):
    """Tenant form: adapted params carry a T axis, frozen ones are shared,
    each tenant's BN statistics cover its own images; the JAX side vmaps
    ``apply`` over tenants."""
    jcfg, cfg = _cfgs(11, stats_impl)
    net, bn = _state(jcfg, seed=1)
    rng = np.random.RandomState(7)
    T = 3
    adapted = {k for k in net if jax_partition.is_inner_adapted(jcfg, k)}
    tnet = {
        k: (v[None] + 0.05 * rng.randn(T, *v.shape)).astype(np.float32)
        if k in adapted else v
        for k, v in net.items()
    }
    x = rng.randn(T, 4, 11, 11, 3).astype(np.float32)

    def one(params_adapted, xi):
        frozen = {k: jnp.asarray(v) for k, v in tnet.items()
                  if k not in adapted}
        return jax_vgg.apply(jcfg, {**frozen, **params_adapted},
                             {k: jnp.asarray(v) for k, v in bn.items()},
                             xi, 1)

    jlogits, jbn = jax.vmap(one)(
        {k: jnp.asarray(tnet[k]) for k in adapted}, jnp.asarray(x))
    logits, new_bn = vgg.apply(
        cfg, {k: torch.from_numpy(v) for k, v in tnet.items()},
        {k: torch.from_numpy(v) for k, v in bn.items()},
        torch.from_numpy(x), 1)
    _close(logits, jlogits, VALUE_TOL, "logits")
    for k in jbn:
        _close(new_bn[k], jbn[k], VALUE_TOL, k)


def test_apply_eval_returns_bn_state_unchanged():
    jcfg, cfg = _cfgs(10, "twopass")
    net, bn = _state(jcfg)
    x = np.random.RandomState(0).randn(2, 10, 10, 3).astype(np.float32)
    tbn = {k: torch.from_numpy(v) for k, v in bn.items()}
    _, new_bn = vgg.apply(cfg, {k: torch.from_numpy(v) for k, v in
                                net.items()}, tbn, torch.from_numpy(x), 0,
                          training=False)
    for k in tbn:
        assert torch.equal(new_bn[k], tbn[k])


def test_init_and_feature_dim_match_jax():
    """Both geometries: pooled (11 -> 5 -> 2, 2x2x6 features) and strided
    (11 -> 6 -> 3, pooled to 6 features)."""
    for max_pooling in (True, False):
        jcfg, cfg = _cfgs(11, "twopass", max_pooling=max_pooling)
        assert vgg.feature_dim(cfg) == jax_vgg.feature_dim(jcfg)
        assert list(vgg._stage_dims(cfg)) == list(jax_vgg._stage_dims(jcfg))
        params, bn = vgg.init(cfg, torch.Generator().manual_seed(0))
        jparams, jbn = jax_vgg.init(jcfg, jax.random.PRNGKey(0))
        assert {k: tuple(v.shape) for k, v in params.items()} == {
            k: tuple(v.shape) for k, v in jparams.items()}
        assert {k: tuple(v.shape) for k, v in bn.items()} == {
            k: tuple(v.shape) for k, v in jbn.items()}


def _unpadded_matches_jax(change, hw=10):
    """``vgg.init`` shapes and ``vgg.apply`` logits and new BN state of
    the model ``change`` describes against the JAX package's."""
    jcfg, cfg = _cfgs(hw, "twopass", **change)
    params, bn = vgg.init(cfg, torch.Generator().manual_seed(0))
    jparams, jbn = jax_vgg.init(jcfg, jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in jparams.items()}
    assert {k: tuple(v.shape) for k, v in bn.items()} == {
        k: tuple(v.shape) for k, v in jbn.items()}
    net, bn = _state(jcfg)
    x = np.random.RandomState(1).rand(3, hw, hw, 3).astype(np.float32)
    jlogits, jnew = jax_vgg.apply(
        jcfg, {k: jnp.asarray(v) for k, v in net.items()},
        {k: jnp.asarray(v) for k, v in bn.items()}, jnp.asarray(x), 1)
    logits, new = vgg.apply(cfg, {k: torch.from_numpy(v)
                                  for k, v in net.items()},
                            {k: torch.from_numpy(v) for k, v in bn.items()},
                            torch.from_numpy(x), 1)
    _close(logits, jlogits, VALUE_TOL, "logits")
    for k, v in jnew.items():
        _close(new[k], v, VALUE_TOL, k)


@pytest.mark.parametrize("change", [
    dict(conv_padding=False), dict(conv_padding=False, max_pooling=False),
    dict(block_order="norm_conv_relu", conv_padding=False),
])
def test_uncovered_models_raise(change):
    """The unpadded models (``conv_padding=False``: 10 -> 8/4 -> 2/1
    pooled, 10 -> 4 -> 1 strided), which raised before the port took
    them: ``vgg.init`` shapes and ``vgg.apply`` against the JAX package.
    What still raises is a geometry with no conv output: the unpadded
    strided 28x28 Omniglot model (28 -> 13 -> 6 -> 2 -> 0), with
    ``ValueError``."""
    _unpadded_matches_jax(change)
    if not change.get("max_pooling", True):
        _, cfg = _cfgs(28, "twopass", image_channels=1, num_stages=4,
                       **change)
        with pytest.raises(ValueError, match="vanishes at stage 3"):
            vgg.init(cfg, torch.Generator().manual_seed(0))
        state = state_lib.init_state(_cfgs(10, "twopass")[1], device="cpu")
        with pytest.raises(ValueError, match="vanishes at stage 3"):
            vgg.apply(cfg, state.net, state.bn, torch.zeros(1, 28, 28, 1),
                      0)
