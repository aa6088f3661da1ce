"""The port's ``torch.save`` checkpoints and its import tool:

* a save and a load give back every leaf of the ``MetaState`` (Adam's too)
  and the experiment state exactly; the async save with its ``latest``
  clone lands both; a writer's error surfaces at the barrier;
* the ``.tmp`` / ``.old`` swap and its recovery, and a corrupt file, as
  the JAX package's ``tests/test_checkpoint.py`` covers them;
* a JAX ``init_state`` through the JAX package's export tool and the
  port's import tool equals ``state.from_numpy`` of the same leaves,
  exactly, and becomes a port checkpoint the runner loads.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.core import maml as jax_maml
from howtotrainyourmamlpytorch_tpu.tools import export_torch_checkpoint
from howtotrainyourmamlpytorch_tpu_torch import state as state_lib
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt
from howtotrainyourmamlpytorch_tpu_torch.tools import import_torch_checkpoint

torch.set_num_threads(2)

TINY = dict(dataset_name="mini_imagenet_full_size", image_height=10,
            image_width=10, image_channels=3, num_classes_per_set=2,
            num_samples_per_class=1, num_target_samples=1,
            cnn_num_filters=4, num_stages=2, max_pooling=True,
            per_step_bn_statistics=True,
            learnable_per_layer_per_step_inner_loop_learning_rate=True,
            number_of_training_steps_per_iter=2,
            number_of_evaluation_steps_per_iter=2)


def _state(seed=0):
    """A port state whose every leaf (Adam's moments and count too) is
    made from ``seed``, so a lost or swapped leaf shows."""
    cfg = MAMLConfig(**TINY)
    state = state_lib.init_state(cfg, device="cpu", with_opt=True)
    gen = torch.Generator().manual_seed(seed)
    state = state_lib._map_state(state, lambda v: (
        torch.randn(v.shape, generator=gen).to(v.dtype)
        if v.is_floating_point() else v + 7))
    return cfg, state


def _flat(state):
    host = state_lib.to_numpy(state)
    out = {}
    for group in ("net", "lslr", "bn"):
        out.update({f"{group}/{k}": v for k, v in getattr(host, group).items()})
    out["opt/count"] = host.opt.count
    for name in ("mu", "nu"):
        for g, leaves in getattr(host.opt, name).items():
            out.update({f"opt/{name}/{g}/{k}": v for k, v in leaves.items()})
    return out


def _assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


EXP = {"best_val_acc": np.float32(0.75), "current_iter": 12,
       "episode_cursor": 24, "per_epoch_statistics": {"val_accuracy_mean":
                                                      [0.5, 0.75]}}


@pytest.mark.parametrize("how", ["sync", "async"])
def test_save_and_load_give_back_every_leaf(tmp_path, how):
    _, state = _state()
    _, other = _state(seed=1)
    if how == "sync":
        ckpt.save_checkpoint(str(tmp_path), "train_model", 3, state, EXP)
    else:
        ckpt.save_checkpoint_async(str(tmp_path), "train_model", 3, state,
                                   EXP, clone_to="latest")
        ckpt.wait_for_pending()
    for idx in (3, "latest") if how == "async" else (3,):
        got, exp = ckpt.load_checkpoint(str(tmp_path), "train_model", idx,
                                        other)
        _assert_same(got, state)
        assert exp == {**EXP, "best_val_acc": 0.75}
    assert ckpt.list_checkpoints(str(tmp_path), "train_model") == (
        ["3", "latest"] if how == "async" else ["3"])


def test_the_async_save_copies_the_state_before_it_returns(tmp_path):
    _, state = _state()
    want = {k: v.copy() for k, v in _flat(state).items()}
    ckpt.save_checkpoint_async(str(tmp_path), "train_model", 1, state, EXP)
    for v in state.net.values():
        v.add_(1.0)  # the next step may go on at once
    got, _ = ckpt.load_checkpoint(str(tmp_path), "train_model", 1, state)
    for k, v in _flat(got).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_a_failed_background_write_surfaces_at_the_barrier(tmp_path,
                                                           monkeypatch):
    _, state = _state()

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", broken)
    ckpt.save_checkpoint_async(str(tmp_path), "train_model", 1, state, EXP)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_for_pending()
    assert not ckpt.checkpoint_exists(str(tmp_path), "train_model", 1)


def test_an_interrupted_swap_is_recovered_and_tmp_is_ignored(tmp_path):
    _, state = _state()
    d = str(tmp_path)
    path = ckpt.save_checkpoint(d, "train_model", "latest", state, EXP)
    # killed between the swap's two renames: only <path>.old is left
    os.replace(path, path + ".old")
    # and a build killed mid-write left a half-written tmp
    os.makedirs(os.path.join(d, "train_model_2.tmp"))
    assert ckpt.list_checkpoints(d, "train_model") == []
    # a peek moves the .old back and reads it
    assert ckpt.peek_experiment_state(
        d, "train_model", "latest")["current_iter"] == 12
    assert os.path.isdir(path) and not os.path.isdir(path + ".old")
    # and so does a load
    os.replace(path, path + ".old")
    got, _ = ckpt.load_checkpoint(d, "train_model", "latest", state)
    _assert_same(got, state)
    assert os.path.isdir(path) and not os.path.isdir(path + ".old")
    assert ckpt.checkpoint_exists(d, "train_model", "latest")
    assert ckpt.list_checkpoints(d, "train_model") == ["latest"]
    # a prune takes the .old sibling too, so nothing resurrects it
    os.replace(path, path + ".old")
    ckpt.remove_checkpoint(d, "train_model", "latest")
    assert not ckpt.checkpoint_exists(d, "train_model", "latest")


def test_a_swap_keeps_a_complete_checkpoint_at_every_instant(tmp_path):
    _, first = _state(seed=0)
    _, second = _state(seed=1)
    d = str(tmp_path)
    ckpt.save_checkpoint(d, "train_model", "latest", first, EXP)
    ckpt.save_checkpoint(d, "train_model", "latest", second,
                         {**EXP, "current_iter": 15})
    got, exp = ckpt.load_checkpoint(d, "train_model", "latest", first)
    _assert_same(got, second)
    assert exp["current_iter"] == 15
    assert sorted(os.listdir(d)) == ["train_model_latest"]


@pytest.mark.parametrize("damage", ["truncated", "missing_json", "garbage"])
def test_a_corrupt_checkpoint_names_its_fallbacks(tmp_path, damage):
    _, state = _state()
    d = str(tmp_path)
    for idx in (1, 2, "latest"):
        ckpt.save_checkpoint(d, "train_model", idx, state, EXP)
    path = os.path.join(d, "train_model_2")
    if damage == "truncated":
        with open(os.path.join(path, "state.pt"), "r+b") as f:
            f.truncate(100)
    elif damage == "missing_json":
        os.remove(os.path.join(path, "experiment_state.json"))
    else:
        with open(os.path.join(path, "state.pt"), "wb") as f:
            f.write(b"not a checkpoint")
    with pytest.raises(ckpt.CheckpointCorruptError) as info:
        ckpt.load_checkpoint(d, "train_model", 2, state)
    assert info.value.fallbacks == ["1", "latest"]
    assert "train_model_2" in str(info.value)
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(d, "train_model", 9, state)


def test_a_checkpoint_of_another_architecture_is_refused(tmp_path):
    _, state = _state()
    ckpt.save_checkpoint(str(tmp_path), "train_model", 1, state, EXP)
    wide = state_lib.init_state(MAMLConfig(**{**TINY, "cnn_num_filters": 8}),
                                device="cpu", with_opt=True)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_checkpoint(str(tmp_path), "train_model", 1, wide)


@pytest.mark.parametrize("variant", [
    dict(),
    dict(max_pooling=False, per_step_bn_statistics=False),
    dict(norm_layer="layer_norm"),
])
def test_a_jax_state_exported_and_imported_equals_from_numpy(tmp_path,
                                                             variant):
    kw = {**TINY, **variant}
    jcfg, cfg = JaxConfig(**kw), MAMLConfig(**kw)
    jstate = jax.device_get(jax_maml.init_state(jcfg))
    ref = export_torch_checkpoint.convert_to_reference_state(
        jcfg, jstate.net, jstate.bn, jstate.lslr)
    path = str(tmp_path / "ref.pt")
    torch.save({"network": {k: torch.from_numpy(np.array(v))
                            for k, v in ref.items()},
                "current_iter": 8, "best_val_acc": 0.5}, path)
    got, exp = import_torch_checkpoint.import_torch_checkpoint(cfg, path,
                                                               "cpu")
    want = state_lib.from_numpy(jstate, device="cpu")
    for group in ("net", "lslr", "bn"):
        g, w = getattr(got, group), getattr(want, group)
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            assert torch.equal(g[k], w[k]), k
    assert exp == {"current_iter": 8, "best_val_acc": 0.5}
    assert int(got.opt.count) == 0
    assert all(float(v.abs().max()) == 0.0
               for m in (got.opt.mu, got.opt.nu)
               for leaves in m.values() for v in leaves.values())
    # the tool writes a port checkpoint the runner resumes from
    out = str(tmp_path / "saved_models")
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(kw, f)
    import_torch_checkpoint.main(["--config", cfg_path, "--torch_checkpoint",
                                  path, "--output_dir", out, "--device",
                                  "cpu"])
    loaded, exp = ckpt.load_checkpoint(out, "train_model", "latest", got)
    _assert_same(loaded, got)
    assert exp["current_iter"] == 8
    shutil.rmtree(out)
