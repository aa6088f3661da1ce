"""The port's serving slice held to the JAX package on the CPU:
``make_serve_step`` and ``make_eval_step`` on ``preds``, ``loss``,
``accuracy`` and the masked ``metrics`` (shots 1 and 2, with a zero pad
tenant), ``ServingEngine.serve_group`` end to end, and the port's
``serve-bench --fast --device cpu`` line.

Tolerances (f32 through 2 first-order inner steps, sums in another
order): ``preds`` atol 1e-4, ``loss`` rtol 1e-4, ``accuracy`` equal
wherever the top-2 softmax margin exceeds 1e-4.
"""

import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.core import maml as jax_maml
from howtotrainyourmamlpytorch_tpu.serving.batcher import (
    AdaptRequest as JaxRequest,
)
from howtotrainyourmamlpytorch_tpu.serving.engine import (
    ServingEngine as JaxEngine,
)
from howtotrainyourmamlpytorch_tpu_torch import state as state_lib
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.core import maml
from howtotrainyourmamlpytorch_tpu_torch.serving import bench
from howtotrainyourmamlpytorch_tpu_torch.serving.batcher import (
    AdaptRequest,
    group_requests,
    serve_requests,
)
from howtotrainyourmamlpytorch_tpu_torch.serving.engine import ServingEngine

torch.set_num_threads(2)

PREDS_ATOL = 1e-4
LOSS_RTOL = 1e-4
MARGIN = 1e-4


def _cfgs(stats_impl="twopass", **extra):
    kw = dict(
        dataset_name="omniglot_dataset", image_height=11, image_width=11,
        image_channels=3, num_classes_per_set=3, num_samples_per_class=1,
        num_target_samples=2, batch_size=2, cnn_num_filters=6, num_stages=2,
        max_pooling=True, per_step_bn_statistics=True,
        learnable_per_layer_per_step_inner_loop_learning_rate=True,
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2, use_remat=False,
        task_learning_rate=0.1, bn_stats_impl=stats_impl,
        serving_bucket_ladder=[1, 2, 4], serving_max_tenants_per_dispatch=4,
    )
    kw.update(extra)
    return JaxConfig(**kw), MAMLConfig(**kw)


def _batch(cfg, tenants, shots, pad, seed=0):
    """``tenants`` real tenants (class-dependent means, so adaptation
    matters) followed by ``pad`` all-zero pad tenants."""
    rng = np.random.RandomState(seed)
    n, t = cfg.num_classes_per_set, cfg.num_target_samples
    h, w, c = cfg.im_shape
    b = tenants + pad
    means = rng.randn(tenants, n, 1, 1, 1, 1).astype(np.float32)
    x_s = np.zeros((b, n, shots, h, w, c), np.float32)
    x_t = np.zeros((b, n, t, h, w, c), np.float32)
    x_s[:tenants] = rng.randn(tenants, n, shots, h, w, c) * 0.5 + means
    x_t[:tenants] = rng.randn(tenants, n, t, h, w, c) * 0.5 + means
    y_s = np.tile(np.arange(n, dtype=np.int32)[None, :, None], (b, 1, shots))
    y_t = np.tile(np.arange(n, dtype=np.int32)[None, :, None], (b, 1, t))
    y_s[tenants:] = 0
    y_t[tenants:] = 0
    valid = np.zeros(b, np.float32)
    valid[:tenants] = 1.0
    return x_s, y_s, x_t, y_t, valid


def _assert_preds(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=PREDS_ATOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > MARGIN
    assert (got.argmax(-1) == want.argmax(-1))[clear].all()


@pytest.mark.parametrize("stats_impl", ["twopass", "fused"])
@pytest.mark.parametrize("shots", [1, 2])
def test_serve_step_matches_jax(stats_impl, shots):
    jcfg, cfg = _cfgs(stats_impl)
    jstate = jax_maml.init_state(jcfg, seed=4)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    batch = _batch(cfg, tenants=2, shots=shots, pad=1, seed=shots)
    _, jout = jax.jit(jax_maml.make_serve_step(jcfg))(
        jstate, *[jnp.asarray(a) for a in batch])
    _, out = maml.make_serve_step(cfg)(
        state, *[torch.from_numpy(a) for a in batch])
    real = slice(0, 2)
    _assert_preds(out["preds"][real], jout["preds"][real])
    np.testing.assert_allclose(out["loss"][real], jout["loss"][real],
                               rtol=LOSS_RTOL)
    # the same correct-count; the mean may differ in its last bit
    np.testing.assert_allclose(out["accuracy"][real],
                               jout["accuracy"][real], rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(out["metrics"]["loss"]),
                               float(jout["metrics"]["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(out["metrics"]["accuracy"]),
                               float(jout["metrics"]["accuracy"]),
                               rtol=0, atol=1e-6)
    # the pad tenant is finite (zero variance, rsqrt(eps)) and masked out
    assert torch.isfinite(out["preds"]).all()
    assert torch.isfinite(out["loss"]).all()


def test_serve_step_all_masked_reports_zero():
    _, cfg = _cfgs()
    state = state_lib.init_state(cfg, device="cpu")
    batch = _batch(cfg, tenants=1, shots=1, pad=1)
    batch[-1][:] = 0.0
    _, out = maml.make_serve_step(cfg)(
        state, *[torch.from_numpy(a) for a in batch])
    assert float(out["metrics"]["loss"]) == 0.0
    assert float(out["metrics"]["accuracy"]) == 0.0


@pytest.mark.parametrize("stats_impl", ["twopass", "fused"])
def test_eval_step_matches_jax(stats_impl):
    jcfg, cfg = _cfgs(stats_impl, number_of_evaluation_steps_per_iter=3)
    jstate = jax_maml.init_state(jcfg, seed=5)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    x_s, y_s, x_t, y_t, _ = _batch(cfg, tenants=2, shots=2, pad=0, seed=9)
    jmetrics, jpreds = jax.jit(jax_maml.make_eval_step(jcfg))(
        jstate, *[jnp.asarray(a) for a in (x_s, y_s, x_t, y_t)])
    metrics, preds = maml.make_eval_step(cfg)(
        state, *[torch.from_numpy(a) for a in (x_s, y_s, x_t, y_t)])
    _assert_preds(preds, jpreds)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["accuracy"]),
                               float(jmetrics["accuracy"]), atol=1e-6)


def _requests(cfg, shots, count, seed, request_cls, labeled=True):
    x_s, y_s, x_t, y_t, _ = _batch(cfg, tenants=count, shots=shots, pad=0,
                                   seed=seed)
    return [
        request_cls(support_x=x_s[i], support_y=y_s[i], query_x=x_t[i],
                    query_y=y_t[i] if labeled or i == 0 else None,
                    tenant_id=f"t{i}")
        for i in range(count)
    ]


def test_serve_group_matches_jax_engine():
    """3 tenants -> bucket 4 with one pad tenant; tenants 1 and 2 ship no
    query labels (their loss/accuracy are None, their preds are served)."""
    jcfg, cfg = _cfgs()
    jstate = jax_maml.init_state(jcfg, seed=6)
    jeng = JaxEngine(jcfg, jstate, shots_buckets=(2,), strict_retrace=False)
    eng = ServingEngine(cfg, jax.device_get(jstate), shots_buckets=(2,),
                        device="cpu")
    jres = jeng.serve_group(_requests(jcfg, 2, 3, 11, JaxRequest, False))
    res = eng.serve_group(_requests(cfg, 2, 3, 11, AdaptRequest, False))
    assert res.bucket == jres.bucket == 4
    assert res.tenants == 3 and res.shots == 2
    for r, jr in zip(res.results, jres.results):
        assert r.tenant_id == jr.tenant_id
        _assert_preds(r.preds, jr.preds)
        if jr.loss is None:
            assert r.loss is None and r.accuracy is None
        else:
            np.testing.assert_allclose(r.loss, jr.loss, rtol=LOSS_RTOL)
            assert abs(r.accuracy - jr.accuracy) <= 1e-6
    np.testing.assert_allclose(res.metrics["loss"], jres.metrics["loss"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(res.metrics["accuracy"],
                               jres.metrics["accuracy"], atol=1e-6)


def test_per_tenant_outputs_do_not_depend_on_the_bucket():
    _, cfg = _cfgs()
    eng = ServingEngine(cfg, state_lib.init_state(cfg, device="cpu"),
                        shots_buckets=(1,), device="cpu")
    reqs = _requests(cfg, 1, 3, 12, AdaptRequest)
    alone = eng.serve_group(reqs[:1])
    grouped = eng.serve_group(reqs)
    assert (alone.bucket, grouped.bucket) == (1, 4)
    np.testing.assert_allclose(alone.results[0].preds,
                               grouped.results[0].preds, rtol=0, atol=1e-6)


def test_engine_validates_requests():
    _, cfg = _cfgs()
    eng = ServingEngine(cfg, state_lib.init_state(cfg, device="cpu"),
                        shots_buckets=(1,), device="cpu")
    with pytest.raises(ValueError, match="shots buckets"):
        eng.serve_group(_requests(cfg, 2, 1, 0, AdaptRequest))
    with pytest.raises(ValueError, match="exceed"):
        eng.serve_group(_requests(cfg, 1, 5, 0, AdaptRequest))
    bad = _requests(cfg, 1, 1, 0, AdaptRequest)[0]
    bad.query_x = bad.query_x[:, :1]
    with pytest.raises(ValueError, match="query_x"):
        eng.serve_group([bad])


def test_serve_requests_realigns_mixed_shots():
    _, cfg = _cfgs()
    eng = ServingEngine(cfg, state_lib.init_state(cfg, device="cpu"),
                        shots_buckets=(1, 2), device="cpu")
    reqs = [r for pair in zip(_requests(cfg, 1, 3, 1, AdaptRequest),
                              _requests(cfg, 2, 3, 2, AdaptRequest))
            for r in pair]
    assert group_requests(reqs, 2) == [[0, 2], [4], [1, 3], [5]]
    results, dispatches = serve_requests(eng, reqs, max_tenants=2)
    assert [d.tenants for d in dispatches] == [2, 1, 2, 1]
    assert [r.tenant_id for r in results] == [r.tenant_id for r in reqs]
    roll = eng.rollup()
    assert roll["dispatches"] == 4 and roll["tenants"] == 6
    assert roll["tenants_per_sec"] > 0


def test_serve_bench_fast_prints_one_line():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = bench.main(["--fast", "--device", "cpu", "--requests", "5"])
    assert rc == 0
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["tenants"] == 5 and line["device"] == "cpu"
    assert line["dtype"] == "float32"
    assert line["adaptation_latency_ms_p50"] > 0
    assert line["dispatches"] == len(line["kernel_launches_per_dispatch"])
    # the plain ops ran: no kernel launched on the CPU
    assert set(line["kernel_launches"].values()) == {0}
