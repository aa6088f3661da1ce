"""The port's training entry point held to the JAX package's on the CPU:

* ``ExperimentBuilder`` against the JAX package's, 2 epochs x 4
  iterations first order on the same dataset: the same CSV header and
  rows, every per-epoch loss mean within 1e-4 relative, every accuracy
  mean within one target image per batch (first order avoids the
  jit-against-eager drift of tiny second-order geometries);
* the same top-5 ensemble epochs and the same pruned checkpoints from the
  same validation history, ties included;
* second order, port only: a 2-epoch run resumed for a third equals a
  3-epoch run bit for bit (every column but the timings, and the final
  state); the three data tiers give the same rows; ``max_models_to_save``
  prunes; the chunked steps equal their single steps bit for bit;
* ``cli train``'s parsing is the JAX package's, and each config field the
  runner has not ported is refused naming its ROADMAP item.

On the pre-split 10x10x3 dataset of ``tests/test_e2e_presplit.py``, 4
filters, 2 stages.
"""

import csv
import os

import jax
import numpy as np
import pytest
import torch
from test_e2e_presplit import _write_presplit_rgb

from howtotrainyourmamlpytorch_tpu import cli as jax_cli
from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.data.loader import (
    MetaLearningDataLoader as JaxLoader,
)
from howtotrainyourmamlpytorch_tpu.experiment.builder import (
    ExperimentBuilder as JaxBuilder,
)
from howtotrainyourmamlpytorch_tpu.experiment.system import (
    MAMLFewShotClassifier as JaxSystem,
)
from howtotrainyourmamlpytorch_tpu_torch import cli
from howtotrainyourmamlpytorch_tpu_torch import state as state_lib
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.core import maml
from howtotrainyourmamlpytorch_tpu_torch.data.loader import (
    MetaLearningDataLoader,
)
from howtotrainyourmamlpytorch_tpu_torch.experiment import builder as builder_lib
from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt
from howtotrainyourmamlpytorch_tpu_torch.experiment.builder import (
    ExperimentBuilder,
)
from howtotrainyourmamlpytorch_tpu_torch.experiment.system import (
    MAMLFewShotClassifier,
)
from howtotrainyourmamlpytorch_tpu_torch.ops import device_pipeline

torch.set_num_threads(2)

NAME = "tiny_presplit_rgb"


def _kw(data_root, **extra):
    kw = dict(
        dataset_name=NAME, dataset_path=data_root, sets_are_pre_split=True,
        indexes_of_folders_indicating_class=[-3, -2], image_height=10,
        image_width=10, image_channels=3, num_classes_per_set=2,
        num_samples_per_class=1, num_target_samples=1, batch_size=2,
        cnn_num_filters=4, num_stages=2, max_pooling=True,
        per_step_bn_statistics=True,
        learnable_per_layer_per_step_inner_loop_learning_rate=True,
        use_multi_step_loss_optimization=True, second_order=True,
        number_of_training_steps_per_iter=2,
        number_of_evaluation_steps_per_iter=2, total_epochs=2,
        total_iter_per_epoch=4, num_evaluation_tasks=4,
        num_dataprovider_workers=2, seed=0, use_remat=False,
        # a constant LR, as the mini-ImageNet MAML++ JSON has it: the
        # cosine schedule's period is total_epochs, which a resume with
        # more epochs changes
        meta_learning_rate=0.001, min_learning_rate=0.001,
    )
    kw.update(extra)
    return kw


def _rows(exp):
    with open(os.path.join(exp, "logs", "summary_statistics.csv")) as f:
        return list(csv.reader(f))


def _untimed(rows):
    header = rows[0]
    keep = [i for i, k in enumerate(header)
            if not ("time" in k or "per_sec" in k or k.startswith("stream_"))]
    return [[row[i] for i in keep] for row in rows]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("runner")
    _write_presplit_rgb(str(root / NAME))
    return str(root / NAME)


@pytest.fixture(scope="module")
def both_runs(data_root, tmp_path_factory):
    """The JAX package's and the port's runners on one config, first
    order, from the JAX package's initial state (the two packages' random
    streams differ): (JAX builder, port builder, JAX test result,
    port's)."""
    tmp = tmp_path_factory.mktemp("both")
    kw = _kw(data_root, second_order=False,
             number_of_training_steps_per_iter=1,
             number_of_evaluation_steps_per_iter=1)
    jcfg = JaxConfig(**kw, experiment_name=str(tmp / "jax"),
                     cache_dir=str(tmp / "jax_cache"))
    cfg = MAMLConfig(**kw, experiment_name=str(tmp / "port"),
                     cache_dir=str(tmp / "port_cache"))
    jsys = JaxSystem(jcfg, use_mesh=False)
    system = MAMLFewShotClassifier(cfg, "cpu")
    system.state = state_lib.from_numpy(jax.device_get(jsys.state), "cpu")
    jb = JaxBuilder(jcfg, jsys, JaxLoader, verbose=False)
    jres = jb.run_experiment()
    pb = ExperimentBuilder(cfg, system, MetaLearningDataLoader,
                           verbose=False)
    pres = pb.run_experiment()
    return jb, pb, jres, pres


def test_the_runner_writes_the_jax_runners_statistics(both_runs):
    jb, pb, jres, pres = both_runs
    jrows = _rows(os.path.dirname(jb.logs_filepath))
    prows = _rows(os.path.dirname(pb.logs_filepath))
    assert prows[0] == jrows[0]
    assert len(prows) == len(jrows) == 3
    cfg = pb.cfg
    per_batch = 1.0 / (cfg.batch_size * cfg.num_classes_per_set
                       * cfg.num_target_samples)
    for prow, jrow in zip(prows[1:], jrows[1:]):
        for key, got, want in zip(prows[0], prow, jrow):
            if "time" in key or "per_sec" in key or key.startswith("stream"):
                continue
            got, want = float(got), float(want)
            if "accuracy" in key:
                assert abs(got - want) <= per_batch, key
            elif "loss" in key and "importance" not in key:
                assert abs(got - want) <= 1e-4 * abs(want), key
            else:  # the schedule: LR, MSL weights, the epoch
                assert got == pytest.approx(want, rel=1e-6), key
    assert 0.0 <= pres["test_accuracy_mean"] <= 1.0
    assert abs(pres["test_accuracy_mean"]
               - jres["test_accuracy_mean"]) <= per_batch
    for b in (jb, pb):
        assert sorted(os.listdir(b.saved_models_filepath)) == [
            "train_model_1", "train_model_2", "train_model_latest"]
        assert os.path.isfile(os.path.join(b.logs_filepath,
                                           "test_summary.csv"))


HISTORIES = [
    ([0.5, 0.75, 0.75, 0.25, 0.75, 0.5, 1.0], 5),
    ([0.5, 0.75, 0.75, 0.25, 0.75, 0.5, 1.0], 2),
    ([0.25, 0.25, 0.25], 5),
    ([0.1, 0.9, 0.3, 0.9, 0.9, 0.2, 0.9, 0.4], 3),
]


@pytest.mark.parametrize("history,max_models", HISTORIES)
def test_the_ensemble_takes_the_jax_runners_epochs(both_runs, monkeypatch,
                                                   history, max_models):
    picked = {}
    for which, b in zip(("jax", "port"), both_runs[:2]):
        def predict(sorted_idx, n_batches, which=which):
            picked[which] = [int(i) for i in sorted_idx]
            return [[np.zeros((2, 2))] for _ in sorted_idx], [np.zeros(2)]

        monkeypatch.setattr(b, "_ensemble_predict", predict)
        monkeypatch.setattr(b, "cfg", b.cfg.replace(
            max_models_to_save=max_models))
        monkeypatch.setitem(b.state, "per_epoch_statistics",
                            {"val_accuracy_mean": list(history)})
        b.evaluated_test_set_using_the_best_models(top_n_models=5)
    assert picked["port"] == picked["jax"]


@pytest.mark.parametrize("history,max_models", HISTORIES)
def test_pruning_keeps_the_jax_runners_checkpoints(both_runs, monkeypatch,
                                                   tmp_path, history,
                                                   max_models):
    kept = {}
    for which, b in zip(("jax", "port"), both_runs[:2]):
        saved = tmp_path / which
        for name in [str(i) for i in range(1, len(history) + 1)] + ["latest"]:
            os.makedirs(saved / f"train_model_{name}")
        monkeypatch.setattr(b, "saved_models_filepath", str(saved))
        monkeypatch.setattr(b, "cfg", b.cfg.replace(
            max_models_to_save=max_models))
        monkeypatch.setitem(b.state, "per_epoch_statistics",
                            {"val_accuracy_mean": list(history)})
        b._prune_saved_models()
        kept[which] = sorted(os.listdir(saved))
    assert kept["port"] == kept["jax"]
    assert len(kept["port"]) == min(max_models, len(history)) + 1


def _cli_train(data_root, exp, cache, *extra):
    kw = _kw(data_root)
    args = ["train", "--device", "cpu", "--experiment_name", exp,
            "--cache_dir", cache]
    for k, v in kw.items():
        if k in ("total_epochs",):
            continue
        v = (str(v).lower() if isinstance(v, bool) else
             str(v) if not isinstance(v, list) else str(v))
        args += [f"--{k}", v]
    assert cli.main(args + list(extra)) == 0


def test_a_resumed_run_equals_an_uninterrupted_one_bit_for_bit(data_root,
                                                               tmp_path):
    cache = str(tmp_path / "cache")
    resumed, whole = str(tmp_path / "resumed"), str(tmp_path / "whole")
    _cli_train(data_root, resumed, cache, "--total_epochs", "2")
    two = _rows(resumed)
    _cli_train(data_root, resumed, cache, "--total_epochs", "3")
    _cli_train(data_root, whole, cache, "--total_epochs", "3")
    assert _rows(resumed)[:3] == two  # exactly one new epoch
    assert len(_rows(resumed)) == len(_rows(whole)) == 4
    assert _untimed(_rows(resumed)) == _untimed(_rows(whole))
    target = state_lib.init_state(MAMLConfig(**_kw(data_root)),
                                  device="cpu", with_opt=True)
    a, ea = ckpt.load_checkpoint(os.path.join(resumed, "saved_models"),
                                 "train_model", "latest", target)
    b, eb = ckpt.load_checkpoint(os.path.join(whole, "saved_models"),
                                 "train_model", "latest", target)
    for group in ("net", "lslr", "bn"):
        for k, v in getattr(a, group).items():
            assert torch.equal(v, getattr(b, group)[k]), k
    assert torch.equal(a.opt.count, b.opt.count)
    assert ea["current_iter"] == eb["current_iter"] == 12
    assert ea["episode_cursor"] == 24


@pytest.mark.parametrize("tier", ["uint8_stream", "device"])
def test_every_data_tier_trains_the_host_tiers_rows(data_root, tmp_path,
                                                    tier):
    cache = str(tmp_path / "cache")
    rows = {}
    for placement in ("host", tier):
        exp = str(tmp_path / placement)
        _cli_train(data_root, exp, cache, "--total_epochs", "1",
                   "--use_mmap_cache", "true", "--data_placement", placement,
                   "--steps_per_dispatch", "2",
                   "--eval_batches_per_dispatch", "2")
        rows[placement] = _untimed(_rows(exp))
    assert rows[tier] == rows["host"]


def test_max_models_to_save_prunes_and_names_itself(data_root, tmp_path):
    exp = str(tmp_path / "exp")
    _cli_train(data_root, exp, str(tmp_path / "cache"), "--total_epochs",
               "4", "--total_iter_per_epoch", "2", "--max_models_to_save",
               "2")
    saved = set(os.listdir(os.path.join(exp, "saved_models")))
    val = np.asarray([float(r[_rows(exp)[0].index("val_accuracy_mean")])
                      for r in _rows(exp)[1:]])
    best = {f"train_model_{int(i) + 1}"
            for i in np.argsort(val, kind="stable")[::-1][:2]}
    assert saved == best | {"train_model_latest"}
    pruned = min({1, 2, 3, 4} - {int(n.rsplit("_", 1)[1]) for n in best})
    with pytest.raises(FileNotFoundError, match="max_models_to_save"):
        _cli_train(data_root, exp, str(tmp_path / "cache"), "--total_epochs",
                   "4", "--total_iter_per_epoch", "2",
                   "--continue_from_epoch", str(pruned))


def _batches(cfg, k, seed):
    rng = np.random.RandomState(seed)
    b, n = cfg.batch_size, cfg.num_classes_per_set
    s, t = cfg.num_samples_per_class, cfg.num_target_samples
    x_s = torch.from_numpy(rng.randn(k, b, n, s, *cfg.im_shape).astype(
        np.float32))
    x_t = torch.from_numpy(rng.randn(k, b, n, t, *cfg.im_shape).astype(
        np.float32))
    y_s = torch.arange(n, dtype=torch.int32)[None, None, :, None].expand(
        k, b, n, s).contiguous()
    y_t = torch.arange(n, dtype=torch.int32)[None, None, :, None].expand(
        k, b, n, t).contiguous()
    return x_s, y_s, x_t, y_t


def _same_state(a, b):
    for group in ("net", "lslr", "bn"):
        for k, v in getattr(a, group).items():
            assert torch.equal(v, getattr(b, group)[k]), k
    for name in ("mu", "nu"):
        for g, leaves in getattr(a.opt, name).items():
            for k, v in leaves.items():
                assert torch.equal(v, getattr(b.opt, name)[g][k]), k


@pytest.mark.parametrize("second_order", [False, True])
def test_the_chunked_train_step_is_k_single_steps(data_root, second_order):
    cfg = MAMLConfig(**_kw(data_root))
    lr, weights, _ = maml.epoch_schedule(cfg, 0)
    batches = _batches(cfg, 2, seed=3)
    state = state_lib.init_state(cfg, device="cpu", with_opt=True)
    multi, metrics = maml.make_train_multi_step(cfg, second_order)(
        state, *batches, weights, lr)
    step = maml.make_train_step(cfg, second_order)
    single = state
    for j in range(2):
        single, m = step(single, *(a[j] for a in batches), weights, lr)
        for key in m:
            assert torch.equal(metrics[key][j], m[key]), key
    _same_state(multi, single)


def test_the_chunked_steps_of_the_device_tier_and_eval(data_root):
    cfg = MAMLConfig(**_kw(data_root, use_mmap_cache=True,
                           data_placement="device"))
    lr, weights, _ = maml.epoch_schedule(cfg, 0)
    rng = np.random.RandomState(5)
    store = torch.from_numpy(rng.randint(0, 256, (12, *cfg.im_shape)).astype(
        np.uint8))
    gather = torch.from_numpy(rng.randint(0, 12, (2, 2, 2, 2)).astype(
        np.int32))
    rot_k = torch.from_numpy(rng.randint(0, 4, (2, 2, 2)).astype(np.int32))
    state = state_lib.init_state(cfg, device="cpu", with_opt=True)
    multi, metrics = maml.make_train_multi_step_indexed(cfg, True, False)(
        state, store, gather, rot_k, weights, lr)
    step = maml.make_train_step_indexed(cfg, True, False)
    single = state
    for j in range(2):
        single, m = step(single, store, gather[j], rot_k[j], weights, lr)
        assert torch.equal(metrics["loss"][j], m["loss"])
    _same_state(multi, single)
    expand = device_pipeline.make_index_expander(cfg, False)
    pixels = [expand(store, gather[j], rot_k[j]) for j in range(2)]
    for with_preds in (False, True):
        got_i = maml.make_eval_multi_step_indexed(cfg, with_preds)(
            state, store, gather, rot_k)
        got_p = maml.make_eval_multi_step(cfg, with_preds)(
            state, *(torch.stack(a) for a in zip(*pixels)))
        for j in range(2):
            m, p = maml.make_eval_step(cfg)(state, *pixels[j])
            for got in (got_i, got_p):
                assert torch.equal(got[0]["loss"][j], m["loss"])
                assert torch.equal(got[0]["accuracy"][j], m["accuracy"])
                if with_preds:
                    assert torch.equal(got[1][j], p)
                else:
                    assert got[1] is None


ARGVS = [
    ["--name_of_args_json_file",
     "experiment_config/mini-imagenet_maml++-mini-imagenet_5_5_2_0.01_48_0.json",
     "--total_epochs", "3", "--max_pooling", "false",
     "--train_val_test_split", "[0.7, 0.1, 0.2]", "--meta_learning_rate",
     "0.01"],
    ["--dataset_name", NAME, "--sets_are_pre_split", "true", "--batch_size",
     "4", "--indexes_of_folders_indicating_class", "[-3, -2]"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_cli_train_parses_like_the_jax_command_line(argv, monkeypatch):
    monkeypatch.chdir(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cfg, device = cli.get_args(argv + ["--device", "cpu"])
    assert device == "cpu"
    import dataclasses

    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_cli.get_args(argv))


REFUSED = {
    "tracing_level": ("on", "Queue A 6"),
    "telemetry_level": ("scalars", "Queue A 6"),
    "health_level": ("monitor", "Queue A 6"),
    "watchdog_timeout_s": (30.0, "Queue A 6"),
    "profile_trace_dir": ("/nonexistent/trace", "Queue A 6"),
    "fault_spec": ("ckpt_save:oserror@call=1", "Queue A 5"),
    "analysis_level": ("warn", "Queue A 7"),
}


@pytest.mark.parametrize("field", sorted(REFUSED))
def test_each_unported_field_is_refused_naming_its_item(field):
    value, item = REFUSED[field]
    extra = {field: value}
    if field == "tracing_level":
        extra["telemetry_level"] = "scalars"
    cfg = MAMLConfig(**extra)
    assert {f for f, _, _ in builder_lib.UNPORTED} == set(REFUSED)
    with pytest.raises(NotImplementedError,
                       match=f"{field}=.*ROADMAP {item}"):
        ExperimentBuilder(cfg, model=None, data_loader_cls=None)


class _NoLoader:
    """A loader that records the resume point it was built for."""

    def __init__(self, cfg, current_iter, cache_dir, episode_cursor):
        self.current_iter = current_iter
        self.episode_cursor = episode_cursor


@pytest.mark.parametrize("cont", ["latest", "3"])
def test_a_resume_point_that_is_not_on_disk(tmp_path, cont):
    cfg = MAMLConfig(experiment_name=str(tmp_path / "exp"),
                     continue_from_epoch=cont)
    if cont == "latest":  # no latest yet: a fresh run
        b = ExperimentBuilder(cfg, model=None, data_loader_cls=_NoLoader)
        assert b.create_summary_csv and b.start_epoch == 0
        assert (b.data.current_iter, b.data.episode_cursor) == (0, None)
    else:  # an epoch pruned away is named as such
        with pytest.raises(FileNotFoundError, match="max_models_to_save"):
            ExperimentBuilder(cfg, model=None, data_loader_cls=_NoLoader)
