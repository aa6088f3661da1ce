"""The port's uint8 and index ingests held to the JAX package on the CPU:

* the expanders' plain twins (``ops/device_pipeline.py``: the index
  expander with and without rotation and all four k, the serve expander,
  the decoder) against the JAX package's, bit for bit; the rows-outside-
  the-store rule and the k clamp against ``jnp``'s gather and
  ``lax.switch``; the square-image check;
* ``make_train_step_indexed``: its meta-gradients (Adam's first moment
  after one step, ``mu = (1 - b1) g``) against the JAX indexed step at the
  parity tolerance of ``tests/test_torch_train.py``, on a tiny
  Omniglot-like geometry (2 stages, 8 filters, 10x10x1, rot on), and the
  port's own indexed and uint8 steps against its host-tier step, bit for
  bit; ``make_eval_step_indexed`` against the JAX one;
* ``ServingEngine(ingest='index' | 'uint8')`` against the JAX engine with
  the same ingest at the serve tolerances of ``tests/test_torch_serve.py``,
  ``h2d_bytes_per_dispatch`` equal to the JAX rollup's, the index dispatch
  bit-identical to the f32 dispatch on the host-decoded pixels, and the
  engine's checks of rows, pixels and the store;
* the ``serve-bench --ingest`` and ``train-bench --data-placement`` lines,
  the refusal of both without a device, the ingest wrapper's refusal of a
  tensor off the CPU, and ``vgg.apply`` at the Omniglot geometry.
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
from howtotrainyourmamlpytorch_tpu.models import vgg as jax_vgg
from howtotrainyourmamlpytorch_tpu.ops import device_pipeline as jax_dp
from howtotrainyourmamlpytorch_tpu.serving.batcher import (
    AdaptRequest as JaxRequest,
)
from howtotrainyourmamlpytorch_tpu.serving.batcher import (
    IndexRequest as JaxIndexRequest,
)
from howtotrainyourmamlpytorch_tpu.serving.engine import (
    ServingEngine as JaxEngine,
)
from howtotrainyourmamlpytorch_tpu_torch import bench
from howtotrainyourmamlpytorch_tpu_torch import state as state_lib
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.core import adam, maml
from howtotrainyourmamlpytorch_tpu_torch.data import loader
from howtotrainyourmamlpytorch_tpu_torch.data.episodes import (
    augment_stack,
    decode_cached,
)
from howtotrainyourmamlpytorch_tpu_torch.data.preprocess import FlatStore
from howtotrainyourmamlpytorch_tpu_torch.kernels import episode_expand
from howtotrainyourmamlpytorch_tpu_torch.models import vgg
from howtotrainyourmamlpytorch_tpu_torch.ops import device_pipeline as dp
from howtotrainyourmamlpytorch_tpu_torch.serving import bench as serve_bench
from howtotrainyourmamlpytorch_tpu_torch.serving.batcher import (
    AdaptRequest,
    IndexRequest,
)
from howtotrainyourmamlpytorch_tpu_torch.serving.engine import ServingEngine

torch.set_num_threads(2)

GRAD_ATOL = 1e-6
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-4
PREDS_ATOL = 1e-4
MARGIN = 1e-4
DATASETS = {
    "omniglot": dict(dataset_name="omniglot_dataset", image_channels=1),
    "mini_imagenet": dict(dataset_name="mini_imagenet_full_size",
                          image_channels=3),
    "mini_imagenet_bgr": dict(dataset_name="mini_imagenet_full_size",
                              image_channels=3, reverse_channels=True),
}


def _cfgs(dataset="omniglot", **extra):
    kw = dict(
        image_height=10, image_width=10, num_classes_per_set=3,
        num_samples_per_class=2, num_target_samples=2, batch_size=2,
        cnn_num_filters=8, num_stages=2, max_pooling=True,
        per_step_bn_statistics=True,
        learnable_per_layer_per_step_inner_loop_learning_rate=True,
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2, use_remat=False,
        task_learning_rate=0.1, bn_stats_impl="twopass",
        use_multi_step_loss_optimization=True, use_mmap_cache=True,
        data_placement="device", serving_bucket_ladder=[1, 2, 4],
        serving_max_tenants_per_dispatch=4,
    )
    kw.update(DATASETS[dataset])
    kw.update(extra)
    return JaxConfig(**kw), MAMLConfig(**kw)


def _store(cfg, n_classes=6, per_class=8, seed=0, values=256):
    rng = np.random.RandomState(seed)
    data = rng.randint(0, values, (n_classes * per_class,) + cfg.im_shape
                       ).astype(np.uint8)
    return FlatStore(data, {str(i): i * per_class for i in range(n_classes)},
                     {str(i): per_class for i in range(n_classes)})


def _indices(cfg, store, seeds):
    keys = loader.class_keys_of(store)
    return loader.stack_indices(
        [loader.episode_indices(cfg, store, keys, s) for s in seeds],
        "train", True)


def _all_k(rot_k):
    """rot_k with the four k's cycling over the (task, class) slots."""
    return (np.arange(rot_k.size, dtype=np.int32) % 4).reshape(rot_k.shape)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- expanders ---------------------------------------------------------------


@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_index_expander_matches_jax(dataset, augment):
    jcfg, cfg = _cfgs(dataset)
    store = _store(cfg, seed=1)
    batch = _indices(cfg, store, (3, 4, 5))
    rot_k = _all_k(batch.rot_k)
    got = dp.make_index_expander(cfg, augment)(
        *_t(store.data, batch.gather, rot_k))
    want = jax.jit(jax_dp.make_index_expander(jcfg, augment))(
        store.data, batch.gather, rot_k)
    assert got[0].is_contiguous() and got[2].is_contiguous()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if augment and dataset == "omniglot":
        unrotated = dp.make_index_expander(cfg, False)(
            *_t(store.data, batch.gather, rot_k))
        assert not torch.equal(got[0], unrotated[0])


@pytest.mark.parametrize("shots", [1, 2])
@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_serve_expander_and_decoder_match_jax(dataset, shots):
    jcfg, cfg = _cfgs(dataset)
    store = _store(cfg, seed=2)
    rng = np.random.RandomState(shots)
    gather = rng.randint(0, len(store.data), (3, 3, shots + 2)).astype(
        np.int32)
    got = dp.make_serve_expander(cfg, shots)(*_t(store.data, gather))
    want = jax.jit(jax_dp.make_serve_expander(jcfg, shots))(store.data,
                                                            gather)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    pixels = store.data[gather]
    np.testing.assert_array_equal(
        dp.make_decoder(cfg)(torch.from_numpy(pixels)).numpy(),
        np.asarray(jax.jit(jax_dp.make_decoder(jcfg))(pixels)))


def test_rows_outside_the_store_and_k_outside_0_3_follow_jax():
    """Negative rows wrap once then clamp, rows past the end clamp, as
    ``jnp``'s ``store[gather]`` does on the CPU; k is clamped to [0, 3],
    as ``lax.switch`` clamps its index. The engine and the sampler never
    make such rows (the engine refuses them on the host)."""
    jcfg, cfg = _cfgs()
    store = _store(cfg, n_classes=2, per_class=5, seed=3)  # 10 rows
    gather = np.array([[[-1, -10, -11, -400, 0], [9, 10, 11, 4000, 3],
                        [2, -3, 12, 5, -9]]], np.int32)
    rot_k = np.array([[-2, 7, 1]], np.int32)
    got = dp.make_index_expander(cfg, True)(*_t(store.data, gather, rot_k))
    want = jax.jit(jax_dp.make_index_expander(jcfg, True))(store.data,
                                                           gather, rot_k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rows = dp.clamp_rows(torch.from_numpy(gather), 10).numpy()
    np.testing.assert_array_equal(
        rows, np.asarray(jnp.arange(10)[jnp.asarray(gather)]))


def test_non_square_rot90_and_a_sharded_store_are_refused():
    jcfg, cfg = _cfgs(image_height=8, image_width=6)
    for make in (dp.make_index_expander, jax_dp.make_index_expander):
        with pytest.raises(ValueError, match="square"):
            make(cfg if make is dp.make_index_expander else jcfg, True)
    dp.make_index_expander(cfg, augment=False)
    with pytest.raises(NotImplementedError, match="parallel/"):
        dp.make_index_expander(cfg, False, store_mesh=object())


def test_ingest_wrapper_never_takes_the_plain_path_off_the_cpu():
    episode_expand.reset_launches()
    store = torch.empty(4, 6, 6, 1, dtype=torch.uint8, device="meta")
    rows = torch.empty(2, 3, dtype=torch.int32, device="meta")
    lut = torch.empty(256, 1, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        episode_expand.gather_decode(store, rows, None, lut, 1)
    with pytest.raises(ValueError, match="CUDA"):
        episode_expand.decode(store, lut)
    assert episode_expand.launches() == {"episode_expand": 0}


# -- train and eval ----------------------------------------------------------


def _weights(cfg):
    return np.asarray([0.4, 0.6], np.float32)


def test_indexed_train_step_meta_grads_match_jax():
    """One ``make_train_step_indexed`` step from a converted JAX state,
    port and JAX package on the same store, rows and rot90 draws (all four
    k): the loss, and the meta-gradients read from Adam's first moment
    after one step (``mu = (1 - b1) g``; ROADMAP: compare gradients, not
    post-Adam weights)."""
    jcfg, cfg = _cfgs()
    store = _store(cfg, seed=5, values=2)
    batch = _indices(cfg, store, (21, 22))
    rot_k = _all_k(batch.rot_k)
    jstate = jax_maml.init_state(jcfg, seed=4)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    jnew, jmetrics = jax.jit(jax_maml.make_train_step_indexed(
        jcfg, second_order=True, augment=True))(
        jstate, store.data, batch.gather, rot_k,
        jnp.asarray(_weights(cfg)), 1e-3)
    new, metrics = maml.make_train_step_indexed(cfg, True, augment=True)(
        state, *_t(store.data, batch.gather, rot_k), _weights(cfg), 1e-3)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=LOSS_RTOL)
    jmu = state_lib._adam_of(jax.device_get(jnew).opt).mu
    for group, part in new.opt.mu.items():
        for key, mu in part.items():
            got = mu.numpy() / (1 - adam.B1)
            want = np.asarray(jmu[group][key]) / (1 - adam.B1)
            err = float(np.abs(got - want).max())
            assert err <= GRAD_ATOL + GRAD_RTOL * float(
                np.abs(want).max()), (group, key, err)


@pytest.mark.parametrize("placement", ["device", "uint8_stream"])
def test_indexed_and_uint8_steps_equal_the_host_step(placement):
    """The same tasks through the port's three tiers give the same new
    state and metrics, bit for bit: the expansion is exact, and what
    follows is the one f32 step."""
    _, cfg = _cfgs()
    store = _store(cfg, seed=6, values=2)
    keys = loader.class_keys_of(store)
    seeds = (31, 32)
    x_s, x_t, y_s, y_t, _ = loader.stack(
        [loader.episode(cfg, store, keys, s, True) for s in seeds])
    state = state_lib.init_state(cfg, seed=7, device="cpu", with_opt=True)
    weights = _weights(cfg)
    host, hmetrics = maml.make_train_step(cfg, True)(
        state, *_t(x_s, y_s, x_t, y_t), weights, 1e-3)
    if placement == "device":
        batch = _indices(cfg, store, seeds)
        new, metrics = maml.make_train_step_indexed(cfg, True, True)(
            state, *_t(store.data, batch.gather, batch.rot_k), weights,
            1e-3)
    else:
        u8 = loader.stack([loader.episode_uint8(cfg, store, keys, s, True)
                           for s in seeds])
        ucfg = cfg.replace(data_placement="uint8_stream")
        new, metrics = maml.make_train_step(ucfg, True)(
            state, *_t(u8[0], u8[2], u8[1], u8[3]), weights, 1e-3)
    assert float(metrics["loss"]) == float(hmetrics["loss"])
    assert float(metrics["accuracy"]) == float(hmetrics["accuracy"])
    for name in ("net", "lslr", "bn"):
        for key, v in getattr(host, name).items():
            assert torch.equal(getattr(new, name)[key], v), (name, key)


def test_indexed_eval_step_matches_jax():
    jcfg, cfg = _cfgs("mini_imagenet")
    store = _store(cfg, seed=8)
    batch = _indices(cfg, store, (41, 42))
    jstate = jax_maml.init_state(jcfg, seed=9)
    state = state_lib.from_numpy(jax.device_get(jstate), device="cpu")
    jmetrics, jpreds = jax.jit(jax_maml.make_eval_step_indexed(jcfg))(
        jstate, store.data, batch.gather, batch.rot_k)
    metrics, preds = maml.make_eval_step_indexed(cfg)(
        state, *_t(store.data, batch.gather, batch.rot_k))
    _assert_preds(preds.numpy(), np.asarray(jpreds))
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=LOSS_RTOL)


# -- serving -----------------------------------------------------------------


def _assert_preds(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=PREDS_ATOL)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > MARGIN
    assert (got.argmax(-1) == want.argmax(-1))[clear].all()


def _index_requests(cfg, store, shots, count, seed, cls, unlabeled=()):
    rng = np.random.RandomState(seed)
    n, t = cfg.num_classes_per_set, cfg.num_target_samples
    rows = len(store.data)
    return [cls(support_idx=rng.randint(0, rows, (n, shots)).astype(np.int32),
                query_idx=rng.randint(0, rows, (n, t)).astype(np.int32),
                labeled=i not in unlabeled, tenant_id=f"t{i}")
            for i in range(count)]


def _uint8_requests(cfg, shots, count, seed, cls):
    rng = np.random.RandomState(seed)
    n, t = cfg.num_classes_per_set, cfg.num_target_samples
    return [cls(
        support_x=rng.randint(0, 256, (n, shots) + cfg.im_shape).astype(
            np.uint8),
        support_y=np.tile(np.arange(n, dtype=np.int32)[:, None], (1, shots)),
        query_x=rng.randint(0, 256, (n, t) + cfg.im_shape).astype(np.uint8),
        query_y=(np.tile(np.arange(n, dtype=np.int32)[:, None], (1, t))
                 if i != 1 else None),
        tenant_id=f"t{i}") for i in range(count)]


@pytest.mark.parametrize("ingest", ["index", "uint8"])
def test_serve_group_matches_the_jax_engine(ingest):
    """3 tenants -> bucket 4 with one pad tenant; tenant 1 is unlabeled
    (its loss/accuracy are None, its preds served). Then the rollups'
    ``h2d_bytes_per_dispatch`` over the same dispatches are equal."""
    jcfg, cfg = _cfgs("mini_imagenet", num_samples_per_class=2)
    store = _store(cfg, seed=10)
    jstate = jax_maml.init_state(jcfg, seed=6)
    kw = dict(ingest=ingest, store=store if ingest == "index" else None)
    jeng = JaxEngine(jcfg, jstate, shots_buckets=(2,), strict_retrace=False,
                     **kw)
    eng = ServingEngine(cfg, jax.device_get(jstate), shots_buckets=(2,),
                        device="cpu", **kw)
    if ingest == "index":
        reqs = [_index_requests(cfg, store, 2, 3, 11, c, unlabeled=(1,))
                for c in (IndexRequest, JaxIndexRequest)]
    else:
        reqs = [_uint8_requests(cfg, 2, 3, 11, c)
                for c in (AdaptRequest, JaxRequest)]
    res, jres = eng.serve_group(reqs[0]), jeng.serve_group(reqs[1])
    assert res.bucket == jres.bucket == 4
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
    eng.serve_group(reqs[0][:1])
    jeng.serve_group(reqs[1][:1])
    roll, jroll = eng.rollup(), jeng.rollup()
    assert roll["ingest"] == jroll["ingest"] == ingest
    assert roll["h2d_bytes_per_dispatch"] == jroll["h2d_bytes_per_dispatch"]


def test_f32_h2d_bytes_equal_the_jax_rollup():
    jcfg, cfg = _cfgs("mini_imagenet", num_samples_per_class=1)
    jstate = jax_maml.init_state(jcfg, seed=2)
    jeng = JaxEngine(jcfg, jstate, shots_buckets=(1,), strict_retrace=False)
    eng = ServingEngine(cfg, jax.device_get(jstate), shots_buckets=(1,),
                        device="cpu")
    reqs = [_uint8_requests(cfg, 1, 2, 3, c) for c in (AdaptRequest,
                                                       JaxRequest)]
    for group in reqs:
        for r in group:
            r.support_x = r.support_x.astype(np.float32) / 255
            r.query_x = r.query_x.astype(np.float32) / 255
    dr = eng.serve_group(reqs[0])
    jeng.serve_group(reqs[1])
    assert dr.ingest_bytes == eng.rollup()["h2d_bytes_per_dispatch"]
    assert eng.rollup()["h2d_bytes_per_dispatch"] == jeng.rollup()[
        "h2d_bytes_per_dispatch"]


def test_index_dispatch_equals_the_f32_dispatch_on_the_same_pixels():
    """The port's index ingest against its f32 ingest fed the host decode
    (``decode_cached`` + ``augment_stack``) of the same rows: preds and
    loss bit-identical, and the upload is the rows and the mask only."""
    _, cfg = _cfgs("mini_imagenet", num_samples_per_class=2)
    store = _store(cfg, seed=12)
    state = state_lib.init_state(cfg, seed=3, device="cpu")
    reqs = _index_requests(cfg, store, 2, 4, 13, IndexRequest)
    n = cfg.num_classes_per_set

    def pixels(rows):
        x = augment_stack(cfg, decode_cached(cfg, store.data[rows]), 0,
                          False)
        return np.ascontiguousarray(x, np.float32)

    pixel_reqs = [AdaptRequest(
        support_x=pixels(r.support_idx),
        support_y=np.tile(np.arange(n, dtype=np.int32)[:, None], (1, 2)),
        query_x=pixels(r.query_idx),
        query_y=np.tile(np.arange(n, dtype=np.int32)[:, None], (1, 2)),
        tenant_id=r.tenant_id) for r in reqs]
    index = ServingEngine(cfg, state, [2], device="cpu", ingest="index",
                          store=store).serve_group(reqs)
    f32 = ServingEngine(cfg, state, [2], device="cpu").serve_group(
        pixel_reqs)
    for a, b in zip(index.results, f32.results):
        np.testing.assert_array_equal(a.preds, b.preds)
        assert a.loss == b.loss
    assert index.ingest_bytes == 4 * (4 * n * 4) + 4 * 4  # rows + mask


def test_engine_checks_rows_pixels_and_the_store():
    _, cfg = _cfgs("mini_imagenet", num_samples_per_class=1)
    store = _store(cfg, seed=14)
    state = state_lib.to_numpy(state_lib.init_state(cfg, device="cpu"))
    with pytest.raises(ValueError, match="requires a registered store"):
        ServingEngine(cfg, state, device="cpu", ingest="index")
    with pytest.raises(ValueError, match="only applies"):
        ServingEngine(cfg, state, device="cpu", ingest="uint8", store=store)
    with pytest.raises(ValueError, match="uint8"):
        ServingEngine(cfg, state, device="cpu", ingest="index",
                      store=store.data.astype(np.float32))
    with pytest.raises(ValueError, match="ingest must be"):
        ServingEngine(cfg, state, device="cpu", ingest="jpeg")
    eng = ServingEngine(cfg, state, device="cpu", ingest="index",
                        store=store)
    bad = _index_requests(cfg, store, 1, 1, 0, IndexRequest)[0]
    bad.query_idx = bad.query_idx.copy()
    bad.query_idx[0, 0] = len(store.data)
    with pytest.raises(ValueError, match="out of range"):
        eng.serve_group([bad])
    bad.query_idx[0, 0] = -1
    with pytest.raises(ValueError, match="out of range"):
        eng.serve_group([bad])
    with pytest.raises(ValueError, match="shots buckets"):
        eng.serve_group(_index_requests(cfg, store, 2, 1, 0, IndexRequest))
    u8 = ServingEngine(cfg, state, device="cpu", ingest="uint8")
    req = _uint8_requests(cfg, 1, 1, 0, AdaptRequest)[0]
    req.support_x = req.support_x.astype(np.float32)
    with pytest.raises(ValueError, match="requires uint8"):
        u8.serve_group([req])


# -- benches and entry points ------------------------------------------------


@pytest.mark.parametrize("ingest", ["index", "uint8"])
def test_serve_bench_ingest_line(ingest):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = serve_bench.main(["--fast", "--device", "cpu", "--requests",
                               "4", "--ingest", ingest, "--store-rows",
                               "50"])
    assert rc == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line["ingest"] == ingest and line["tenants"] == 4
    cfg = serve_bench._bench_cfg(serve_bench._parser().parse_args(
        ["--fast"]))
    n, t = cfg.num_classes_per_set, cfg.num_target_samples
    for d in line["per_dispatch"]:
        rows = d["bucket"] * n * (d["shots"] + t)
        want = (4 * rows if ingest == "index"
                else rows * int(np.prod(cfg.im_shape))
                + 4 * d["bucket"] * n * (d["shots"] + t)) + 4 * d["bucket"]
        assert d["ingest_bytes"] == want
    assert line["h2d_bytes_per_dispatch"] == pytest.approx(
        np.mean([d["ingest_bytes"] for d in line["per_dispatch"]]), abs=0.05)
    assert set(line["kernel_launches"].values()) == {0}


def test_train_bench_data_placement_lines():
    """The three tiers of ``train-bench --fast --device cpu`` draw the
    same tasks (equal losses), upload what each tier ships, and launch no
    kernel on the CPU."""
    lines = {}
    for placement in ("host", "uint8_stream", "device"):
        with redirect_stdout(io.StringIO()):
            lines[placement] = bench.run([
                "--fast", "--device", "cpu", "--warmup", "1", "--steps",
                "2", "--data-placement", placement])
    cfg = bench._bench_cfg(bench._parser().parse_args(["--fast"]))
    b, n = cfg.batch_size, cfg.num_classes_per_set
    cols = cfg.num_samples_per_class + cfg.num_target_samples
    pixels = b * n * cols * int(np.prod(cfg.im_shape))
    labels = 4 * b * n * cols
    assert lines["device"]["h2d_bytes_per_step"] == 4 * b * n * cols + 4 * b * n
    assert lines["uint8_stream"]["h2d_bytes_per_step"] == pixels + labels
    assert lines["host"]["h2d_bytes_per_step"] == 4 * pixels + labels
    for placement, line in lines.items():
        assert line["data_placement"] == placement
        assert line["loss"] == lines["host"]["loss"]
        assert line["host_assembly_ms_per_step"] > 0
        assert line["expand_launches_per_step"] == [0, 0]


def test_new_entry_points_raise_without_a_device_when_cuda_is_absent(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs("mini_imagenet")
    host = state_lib.to_numpy(state_lib.init_state(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="--device cpu"):
        ServingEngine(cfg, host, ingest="index", store=_store(cfg))
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_bench.run(["--fast", "--ingest", "index"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.run(["--fast", "--data-placement", "device"])


@pytest.mark.parametrize("step", [0, 4])
def test_apply_at_the_omniglot_geometry_matches_jax(step):
    """``vgg.apply`` at 28x28x1 with 4 stages (pooling 28 -> 14 -> 7 -> 3
    -> 1, a 1x1xf feature) and a 20-way head, against the JAX package's:
    logits and BN state within 1e-5 of their scale."""
    jcfg, cfg = _cfgs(image_height=28, image_width=28, num_stages=4,
                      cnn_num_filters=4, num_classes_per_set=20,
                      num_samples_per_class=1, num_target_samples=1,
                      number_of_training_steps_per_iter=5)
    host = jax.device_get(jax_maml.init_state(jcfg, seed=1))
    state = state_lib.from_numpy(host, device="cpu")
    x = np.random.RandomState(step).randint(0, 2, (20, 28, 28, 1)).astype(
        np.float32)
    jlogits, jbn = jax_vgg.apply(
        jcfg, {k: jnp.asarray(v) for k, v in host.net.items()},
        {k: jnp.asarray(v) for k, v in host.bn.items()}, jnp.asarray(x),
        step)
    logits, bn = vgg.apply(cfg, state.net, state.bn, torch.from_numpy(x),
                           step)
    assert logits.shape == (20, 20)
    scale = float(np.abs(np.asarray(jlogits)).max())
    assert float(np.abs(logits.detach().numpy() - np.asarray(jlogits)).max()
                 ) <= 1e-5 * scale
    for key, v in jax.device_get(jbn).items():
        np.testing.assert_allclose(bn[key].numpy(), v, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(v).max()))
