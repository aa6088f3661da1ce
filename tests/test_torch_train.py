"""The port's training slice held to the JAX package on the CPU, at the tiny
geometry of ``test_torch_serve.py`` (11x11x3 images, 6 filters, 2 stages,
2 inner steps, 3-way 2-shot, batch 2, f32), the JAX state converted with
``state.from_numpy``:

* meta-gradients of ``make_grads_fn`` for both orders and both
  ``bn_stats_impl``, on every ``net`` and ``lslr`` leaf and on the loss;
* the same second-order meta-gradients through the hand-written
  Function block (its wrappers take the twins on the CPU);
* the functional Adam against optax for 3 steps with frozen leaves;
* ``cosine_lr`` and ``epoch_schedule`` against the JAX values;
* a JAX state taken after 2 train steps continues in the port;
* one ``make_train_step`` step: loss, accuracy, merged BN;
* ``meta_accum_steps=2`` against one pass;
* the per-step kernel-launch formula that ``chip_smoke.py`` holds the card
  to, counted on the Function path's twins;
* ``train-bench --fast --device cpu``, and its refusal without a device.

Tolerances: a meta-gradient leaf within ``1e-6 + 1e-4 * max|jax leaf|``
(f32 through 2 inner steps, second order, sums in another order; the
absolute part covers the conv biases, whose true gradient through batch
norm is 0 and whose computed one is round-off of ~1e-7), the loss within
rtol 1e-4.
"""

import collections
import importlib.util
import io
import json
import os
from contextlib import redirect_stdout
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.core import maml as jax_maml
from howtotrainyourmamlpytorch_tpu.experiment.system import (
    MAMLFewShotClassifier,
)
from howtotrainyourmamlpytorch_tpu_torch import bench
from howtotrainyourmamlpytorch_tpu_torch import state as state_lib
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.core import adam, maml
from howtotrainyourmamlpytorch_tpu_torch.kernels import conv_block
from howtotrainyourmamlpytorch_tpu_torch.ops import functional as F

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_ATOL = 1e-6
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-4
WEIGHTS = np.asarray([0.4, 0.6], np.float32)


def _cfgs(stats_impl="twopass", **extra):
    kw = dict(
        dataset_name="omniglot_dataset", image_height=11, image_width=11,
        image_channels=3, num_classes_per_set=3, num_samples_per_class=2,
        num_target_samples=2, batch_size=2, cnn_num_filters=6, num_stages=2,
        max_pooling=True, per_step_bn_statistics=True,
        learnable_per_layer_per_step_inner_loop_learning_rate=True,
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2, use_remat=False,
        task_learning_rate=0.1, bn_stats_impl=stats_impl,
        use_multi_step_loss_optimization=True,
    )
    kw.update(extra)
    return JaxConfig(**kw), MAMLConfig(**kw)


def _batch(cfg, seed):
    """Numpy task batch (class-dependent means, so adaptation matters)."""
    rng = np.random.RandomState(seed)
    b, n = cfg.batch_size, cfg.num_classes_per_set
    s, t = cfg.num_samples_per_class, cfg.num_target_samples
    h, w, c = cfg.im_shape
    means = rng.randn(b, n, 1, 1, 1, 1).astype(np.float32)
    x_s = (rng.randn(b, n, s, h, w, c) * 0.5 + means).astype(np.float32)
    x_t = (rng.randn(b, n, t, h, w, c) * 0.5 + means).astype(np.float32)
    y_s = np.tile(np.arange(n, dtype=np.int32)[None, :, None], (b, 1, s))
    y_t = np.tile(np.arange(n, dtype=np.int32)[None, :, None], (b, 1, t))
    return x_s, y_s, x_t, y_t


def _jax(batch):
    return [jnp.asarray(a) for a in batch]


def _torch(batch):
    return [torch.from_numpy(a) for a in batch]


def _assert_leaf(got, want, what, atol=GRAD_ATOL, rtol=GRAD_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= atol + rtol * float(np.abs(want).max()), (what, err)


def _assert_grads(got, want, **tol):
    for group in ("net", "lslr"):
        assert sorted(got[group]) == sorted(want[group]), group
        for key, w in want[group].items():
            _assert_leaf(got[group][key].detach().numpy(), w,
                         f"{group}/{key}", **tol)


@pytest.mark.parametrize("stats_impl", ["twopass", "fused"])
@pytest.mark.parametrize("second_order", [True, False],
                         ids=["second_order", "first_order"])
def test_meta_grads_match_jax(second_order, stats_impl):
    jcfg, cfg = _cfgs(stats_impl)
    jstate = jax_maml.init_state(jcfg, seed=4)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    batch = _batch(cfg, 1)
    jloss, jgrads = jax.jit(jax_maml.make_grads_fn(jcfg, second_order))(
        jstate, *_jax(batch), jnp.asarray(WEIGHTS))
    loss, grads = maml.make_grads_fn(cfg, second_order)(
        state, *_torch(batch), WEIGHTS)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_grads(grads, jax.device_get(jgrads))


def _tree_scale(grads):
    return max(float(g.abs().max()) for part in grads.values()
               for g in part.values())


@pytest.mark.parametrize("second_order", [True, False],
                         ids=["second_order", "first_order"])
def test_function_block_gives_the_plain_meta_grads(second_order):
    """The learner with the hand-written Function block (the card's
    structure, through the twins here) against the default plain block:
    within 1e-5 of the gradient tree's largest entry (a leaf-relative
    bound is meaningless for the conv biases, whose true gradient is 0)."""
    _, cfg = _cfgs("twopass")
    state = state_lib.init_state(cfg, seed=2, device="cpu")
    batch = _torch(_batch(cfg, 2))
    loss, grads = maml.make_grads_fn(cfg, second_order)(state, *batch,
                                                        WEIGHTS)
    floss, fgrads = maml.make_grads_fn(
        cfg, second_order, block=conv_block.function_block)(state, *batch,
                                                            WEIGHTS)
    np.testing.assert_allclose(float(floss), float(loss), rtol=1e-6)
    scale = _tree_scale(grads)
    for group in grads:
        for key, g in grads[group].items():
            err = float((fgrads[group][key] - g).abs().max())
            assert err <= 1e-5 * scale, (group, key, err, scale)


def test_f64_reference_step_matches_jax():
    """``chip_smoke.py`` holds the kernels' full-width meta-gradients
    against this step in f64 on the plain ops: given an f64 state and f64
    images it stays f64 throughout, and computes what the JAX package
    computes (within the f32 parity tolerance of the JAX side)."""
    jcfg, cfg = _cfgs("twopass")
    jstate = jax_maml.init_state(jcfg, seed=4)
    state = state_lib.to_device(
        state_lib.from_numpy(jax.device_get(jstate), device="cpu"),
        torch.device("cpu"), torch.float64)
    batch = _batch(cfg, 1)
    jloss, jgrads = jax.jit(jax_maml.make_grads_fn(jcfg, True))(
        jstate, *_jax(batch), jnp.asarray(WEIGHTS))
    x_s, y_s, x_t, y_t = _torch(batch)
    loss, grads = maml.make_grads_fn(cfg, True)(
        state, x_s.double(), y_s, x_t.double(), y_t, WEIGHTS)
    assert loss.dtype == torch.float64
    assert {g.dtype for part in grads.values() for g in part.values()} \
        == {torch.float64}
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_grads(grads, jax.device_get(jgrads))


@pytest.mark.parametrize("frozen", ["bn_gamma", "lslr"])
def test_adam_matches_optax(frozen):
    extra = (dict(learnable_bn_gamma=False) if frozen == "bn_gamma" else
             dict(learnable_per_layer_per_step_inner_loop_learning_rate=False))
    jcfg, cfg = _cfgs(**extra)
    host = jax.device_get(jax_maml.init_state(jcfg, seed=7))
    trainable = {"net": host.net, "lslr": host.lslr}
    jopt = jax_maml.make_optimizer(jcfg, host.net)
    jst = jopt.init(jax.tree_util.tree_map(jnp.asarray, trainable))
    ttrain = {g: {k: torch.from_numpy(np.array(v)) for k, v in part.items()}
              for g, part in trainable.items()}
    opt = adam.make_optimizer(cfg, ttrain["net"])
    st = opt.init(ttrain)
    frozen_keys = {(g, k) for g, part in opt.labels.items()
                   for k, lab in part.items() if lab == "freeze"}
    assert frozen_keys
    rng = np.random.RandomState(8)
    for _ in range(3):
        grads = {g: {k: rng.randn(*np.shape(v)).astype(np.float32)
                     for k, v in part.items()}
                 for g, part in trainable.items()}
        jup, jst = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                               jst)
        up, st = opt.update({g: {k: torch.from_numpy(v)
                                 for k, v in part.items()}
                             for g, part in grads.items()}, st)
        jadam = state_lib._adam_of(jax.device_get(jst))
        assert int(st.count) == int(jadam.count)
        for g, part in grads.items():
            for k in part:
                want = np.asarray(jup[g][k])
                _assert_leaf(up[g][k].numpy(), want, f"update {g}/{k}",
                             atol=0.0, rtol=1e-6)
                if (g, k) in frozen_keys:
                    assert not want.any() and k not in st.mu[g]
                    continue
                for name in ("mu", "nu"):
                    _assert_leaf(getattr(st, name)[g][k].numpy(),
                                 getattr(jadam, name)[g][k],
                                 f"{name} {g}/{k}", atol=0.0, rtol=1e-6)


def test_cosine_lr_and_epoch_schedule_match_jax():
    jcfg, cfg = _cfgs(second_order=True, first_order_to_second_order_epoch=14,
                      min_learning_rate=1e-5, meta_learning_rate=1e-3,
                      total_epochs=100, multi_step_loss_num_epochs=15)
    system = SimpleNamespace(cfg=jcfg)
    for epoch in (0, 1, 14, 15, 99):
        assert maml.cosine_lr(cfg, epoch) == jax_maml.cosine_lr(jcfg, epoch)
        lr, weights, second = maml.epoch_schedule(cfg, epoch)
        jlr, jweights, jsecond, _ = MAMLFewShotClassifier._epoch_schedule(
            system, epoch)
        assert lr == jlr and second == jsecond
        np.testing.assert_array_equal(weights, jweights)
    assert not maml.epoch_schedule(cfg, 14)[2]
    assert maml.epoch_schedule(cfg, 15)[2]


def _assert_state_equal(got, want):
    for name in ("net", "lslr", "bn"):
        w, g = getattr(want, name), getattr(got, name)
        assert sorted(g) == sorted(w), name
        for key in w:
            assert g[key].dtype == np.asarray(w[key]).dtype, key
            np.testing.assert_array_equal(g[key], w[key])
    jadam = state_lib._adam_of(want.opt)
    assert int(got.opt.count) == int(jadam.count)
    for name in ("mu", "nu"):
        for group, part in getattr(jadam, name).items():
            kept = {k: v for k, v in part.items() if hasattr(v, "shape")}
            assert sorted(getattr(got.opt, name)[group]) == sorted(kept)
            for key, v in kept.items():
                np.testing.assert_array_equal(
                    getattr(got.opt, name)[group][key], v)


def test_jax_state_taken_mid_training_continues_in_the_port():
    jcfg, cfg = _cfgs(learnable_bn_gamma=False)
    jstate = jax_maml.init_state(jcfg, seed=9)
    jstep = jax.jit(jax_maml.make_train_step(jcfg, second_order=True))
    for seed in (10, 11):
        jstate, _ = jstep(jstate, *_jax(_batch(cfg, seed)),
                          jnp.asarray(WEIGHTS), 1e-3)
    host = jax.device_get(jstate)
    state = state_lib.from_numpy(host, device="cpu")
    assert int(state.opt.count) == 2
    _assert_state_equal(state_lib.to_numpy(state), host)
    _assert_state_equal(state_lib.to_numpy(state_lib.from_numpy(
        state_lib.to_numpy(state), device="cpu")), host)
    batch = _batch(cfg, 12)
    jloss, jgrads = jax.jit(jax_maml.make_grads_fn(jcfg, True))(
        jstate, *_jax(batch), jnp.asarray(WEIGHTS))
    loss, grads = maml.make_grads_fn(cfg, True)(state, *_torch(batch),
                                                WEIGHTS)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_grads(grads, jax.device_get(jgrads))


def test_train_step_matches_jax():
    jcfg, cfg = _cfgs()
    jstate = jax_maml.init_state(jcfg, seed=13)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    batch = _batch(cfg, 14)
    jnew, jmetrics = jax.jit(jax_maml.make_train_step(jcfg, True))(
        jstate, *_jax(batch), jnp.asarray(WEIGHTS), 1e-3)
    new, metrics = maml.make_train_step(cfg, True)(state, *_torch(batch),
                                                   WEIGHTS, 1e-3)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["accuracy"]),
                               float(jmetrics["accuracy"]), atol=1e-6)
    jbn = jax.device_get(jnew.bn)
    assert sorted(new.bn) == sorted(jbn)
    for key, v in jbn.items():
        np.testing.assert_allclose(new.bn[key].numpy(), v, rtol=0,
                                   atol=1e-5)
    assert int(new.opt.count) == 1
    # an update moved every trainable leaf, and Adam's first step moves
    # each element by at most lr (|m_hat / sqrt(v_hat)| <= 1), up to the
    # f32 rounding of the new value (gamma sits at 1.0)
    for key, v in new.net.items():
        step = (v - state.net[key]).abs().max()
        assert 0 < float(step) <= 1e-3 + 2e-7 * float(v.abs().max()), key


def test_meta_accum_steps_matches_one_pass():
    _, cfg = _cfgs()
    _, cfg2 = _cfgs(meta_accum_steps=2)
    state = state_lib.init_state(cfg, seed=15, device="cpu", with_opt=True)
    batch = _torch(_batch(cfg, 16))
    loss, grads = maml.make_grads_fn(cfg, True)(state, *batch, WEIGHTS)
    loss2, grads2 = maml.make_grads_fn(cfg2, True)(state, *batch, WEIGHTS)
    np.testing.assert_allclose(float(loss2), float(loss), rtol=1e-5)
    scale = _tree_scale(grads)
    for group in grads:
        for key, g in grads[group].items():
            err = float((grads2[group][key] - g).abs().max())
            assert err <= 1e-5 * scale, (group, key, err)
    new, _ = maml.make_train_step(cfg2, True)(state, *batch, WEIGHTS, 1e-3)
    assert all(v.shape == state.bn[k].shape for k, v in new.bn.items())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the twin -> the kernel whose wrapper takes it on the CPU; the conv twins
# serve both strides, and the stride they are called with picks the
# counter (``conv_block._conv_name``)
TWINS = {
    "conv3x3_fwd_stats": "conv3x3_fwd_stats",
    "bn_act_pool_fwd": "bn_act_pool_fwd",
    "bn_act_pool_bwd": "bn_act_pool_bwd",
    "conv3x3_dgrad": "conv3x3_dgrad",
    "conv3x3_wgrad": "conv3x3_wgrad",
    "conv3x3": "conv3x3_fwd",
    "bn_act_pool_bwd_bwd": "bn_act_pool_bwd_bwd",
    "bn_act_fwd": "bn_act_fwd",
    "bn_act_bwd": "bn_act_bwd",
    "bn_act_bwd_bwd": "bn_act_bwd_bwd",
    "global_avg_pool2d": "global_avg_pool2d_fwd",
    "global_avg_pool2d_bwd": "global_avg_pool2d_bwd",
    "bn_input_stats": "bn_input_stats",
    "batch_norm_fwd": "batch_norm_fwd",
    "batch_norm_bwd": "batch_norm_bwd",
    "batch_norm_bwd_bwd": "batch_norm_bwd_bwd",
    "act_pool_fwd": "act_pool_fwd",
    "act_pool_bwd": "act_pool_bwd",
    "act_pool_gather": "act_pool_gather",
    "act_fwd": "act_fwd",
    "act_bwd": "act_bwd",
    "layer_norm_stats": "layer_norm_stats",
    "layer_norm_fwd": "layer_norm_fwd",
    "layer_norm_bwd": "layer_norm_bwd",
    "layer_norm_bwd_bwd": "layer_norm_bwd_bwd",
}

# the Function block of each (block_order, norm_layer)
FUNCTION_BLOCKS = {
    ("conv_norm_relu", "batch_norm"): conv_block.function_block,
    ("norm_conv_relu", "batch_norm"): conv_block.norm_function_block,
    ("conv_norm_relu", "layer_norm"): conv_block.conv_ln_function_block,
    ("norm_conv_relu", "layer_norm"): conv_block.ln_conv_function_block,
}


def _count_function_path(monkeypatch, cfg, second_order, serve=False):
    """Every kernel call of one train step (with ``serve``, one serve
    dispatch) on the Function path of the config's block order and norm
    layer, counted at
    the twins the wrappers take on the CPU (a twin that calls another twin
    counts once, as its one kernel)."""
    calls = collections.Counter()
    depth = [0]
    for twin, kernel in TWINS.items():
        def counted(*a, _f=getattr(F, twin), _k=kernel, **kw):
            if depth[0] == 0:
                calls[conv_block._conv_name(_k, kw.get("stride", 1),
                                            kw.get("padding", 1))
                      if _k.startswith("conv3x3") else _k] += 1
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
        maml.make_train_step(cfg, second_order, block=block)(
            state, *batch, np.ones(steps, np.float32) / steps, 1e-3)
    return {k: calls[k] for k in conv_block.KERNELS}


def _formula_cfg(stages, steps, accum, max_pooling,
                 block_order="conv_norm_relu", norm_layer="batch_norm"):
    return MAMLConfig(
        dataset_name="omniglot_dataset", image_height=12, image_width=12,
        image_channels=1, num_classes_per_set=2, num_samples_per_class=1,
        num_target_samples=1, batch_size=2, cnn_num_filters=3,
        num_stages=stages, max_pooling=max_pooling,
        per_step_bn_statistics=True,
        learnable_per_layer_per_step_inner_loop_learning_rate=True,
        number_of_training_steps_per_iter=steps,
        number_of_evaluation_steps_per_iter=steps, meta_accum_steps=accum,
        block_order=block_order, norm_layer=norm_layer)


@pytest.mark.parametrize("second_order,stages,steps,accum", [
    (True, 2, 2, 1), (True, 3, 3, 2), (False, 3, 2, 1), (False, 2, 3, 2)])
def test_chip_smoke_launch_formula_counts_the_function_path(
        monkeypatch, second_order, stages, steps, accum):
    """Every kernel call of a train step on the Function path, counted at
    the twins the wrappers take on the CPU, equals the per-step formula
    ``chip_smoke.py`` holds the card's launch counters to."""
    assert set(TWINS.values()) | {
        conv_block._conv_name(k, s, p) for k in TWINS.values()
        if k.startswith("conv3x3") for s in conv_block.STRIDES
        for p in conv_block.PADDINGS} | {
        f"{k}_bf16" for k in conv_block.BF16_KERNELS} == set(
            conv_block.KERNELS)
    cfg = _formula_cfg(stages, steps, accum, max_pooling=True)
    want = _chip_smoke().expected_train_launches(cfg, second_order)
    assert _count_function_path(monkeypatch, cfg, second_order) == want


@pytest.mark.parametrize("second_order,stages,steps,accum", [
    (True, 2, 2, 1), (True, 3, 3, 2), (False, 3, 2, 1), (False, 2, 3, 2)])
def test_chip_smoke_launch_formula_counts_the_strided_function_path(
        monkeypatch, second_order, stages, steps, accum):
    """The same for the strided model (``max_pooling=False``): the
    stride-2 conv kernels, the pool-free K2/K3/K5 and the global average
    pool's forward and backward."""
    cfg = _formula_cfg(stages, steps, accum, max_pooling=False)
    want = _chip_smoke().expected_train_launches(cfg, second_order)
    assert want["global_avg_pool2d_fwd"] > 0
    assert _count_function_path(monkeypatch, cfg, second_order) == want


@pytest.mark.parametrize("max_pooling", [True, False],
                         ids=["pooled", "strided"])
def test_chip_smoke_serve_launch_formula_counts_the_function_path(
        monkeypatch, max_pooling):
    """One serve dispatch on the Function path, counted at the twins,
    equals ``chip_smoke.expected_launches``, for both models."""
    cfg = _formula_cfg(3, 2, 1, max_pooling)
    want = _chip_smoke().expected_launches(cfg)
    assert _count_function_path(monkeypatch, cfg, False, serve=True) == want


def test_train_bench_fast_prints_one_line():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = bench.main(["--fast", "--device", "cpu", "--warmup", "1",
                         "--steps", "2"])
    assert rc == 0
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["device"] == "cpu" and line["second_order"] is True
    assert line["tasks_per_sec"] > 0 and line["step_ms_p50"] > 0
    assert len(line["loss"]) == 2 and all(np.isfinite(line["loss"]))
    assert line["model_flops_per_task"] > 0 and line["peak_mem_gb"] is None
    # the plain ops ran: no kernel launched on the CPU
    assert len(line["kernel_launches_per_step"]) == 2
    assert {v for step in line["kernel_launches_per_step"]
            for v in step.values()} == {0}
    with redirect_stdout(io.StringIO()):
        first = bench.run(["--fast", "--device", "cpu", "--warmup", "0",
                           "--steps", "1", "--first-order"])
    assert first["second_order"] is False


def test_train_bench_raises_without_a_device_when_cuda_is_absent(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.run(["--fast"])
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="--device cpu"):
        state_lib.init_state(cfg, with_opt=True)
