"""The port's data tier held to the JAX package on the CPU, bit for bit:
the decode table, the index sampler's rows and rot90 draws, the three
per-task builders (host pixels, host uint8 pixels, index rows) of a flat
store, ``FlatStore.views`` and ``IndexBatch``, at tiny geometries with
stores made from numpy seeds.

Everything here is integer bookkeeping or the host's own float decode, so
every comparison is exact.
"""

import numpy as np
import pytest

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.data import episodes as jax_episodes
from howtotrainyourmamlpytorch_tpu.data.loader import (
    FewShotEpisodicDataset as JaxDataset,
)
from howtotrainyourmamlpytorch_tpu.data.loader import (
    IndexBatch as JaxIndexBatch,
)
from howtotrainyourmamlpytorch_tpu.data.preprocess import (
    FlatStore as JaxFlatStore,
)
from howtotrainyourmamlpytorch_tpu.ops import device_pipeline as jax_dp
from howtotrainyourmamlpytorch_tpu_torch import bench
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.data import episodes, loader
from howtotrainyourmamlpytorch_tpu_torch.data.preprocess import FlatStore
from howtotrainyourmamlpytorch_tpu_torch.ops import device_pipeline as dp

SEEDS = (0, 3, 17, 123456)
GEOMETRIES = {
    "omniglot": dict(dataset_name="omniglot_dataset", image_channels=1),
    "mini_imagenet": dict(dataset_name="mini_imagenet_full_size",
                          image_channels=3),
    "mini_imagenet_bgr": dict(dataset_name="mini_imagenet_full_size",
                              image_channels=3, reverse_channels=True),
}


def _cfgs(geometry="omniglot", **extra):
    kw = dict(image_height=6, image_width=6, num_classes_per_set=4,
              num_samples_per_class=2, num_target_samples=3,
              use_mmap_cache=True, data_placement="device")
    kw.update(GEOMETRIES[geometry])
    kw.update(extra)
    return JaxConfig(**kw), MAMLConfig(**kw)


def _stores(cfg, n_classes=7, seed=0):
    """The same uint8 store as the port's and the JAX package's
    ``FlatStore``; classes of unequal size, so offsets matter."""
    rng = np.random.RandomState(seed)
    sizes = {f"c{i}": 6 + i for i in range(n_classes)}
    offsets, at = {}, 0
    for key, size in sizes.items():
        offsets[key] = at
        at += size
    data = rng.randint(0, 256, (at,) + cfg.im_shape).astype(np.uint8)
    return (FlatStore(data, offsets, sizes),
            JaxFlatStore(data, dict(offsets), dict(sizes)))


def _jax_dataset(jcfg, jstore, base_seed):
    """The JAX package's dataset object over ``jstore`` without its
    on-disk index: the attributes its per-task builders read."""
    ds = object.__new__(JaxDataset)
    ds.cfg = jcfg
    ds.flat_stores = {"train": jstore}
    ds.splits = {"train": jstore.views()}
    ds.class_keys = {"train": np.array(list(jstore.offsets.keys()))}
    ds.seed = {"train": base_seed}
    return ds


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_decode_lut_is_the_jax_lut_bit_for_bit(geometry):
    jcfg, cfg = _cfgs(geometry)
    got, want = dp.decode_lut(cfg), jax_dp._decode_lut(jcfg)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (256, cfg.image_channels)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("geometry", ["omniglot", "mini_imagenet"])
@pytest.mark.parametrize("seed", SEEDS)
def test_sample_episode_indices_matches_jax(geometry, seed):
    jcfg, cfg = _cfgs(geometry)
    store, jstore = _stores(cfg, seed=seed % 5)
    keys = loader.class_keys_of(store)
    got = episodes.sample_episode_indices(cfg, store.offsets, store.sizes,
                                          keys, seed)
    want = jax_episodes.sample_episode_indices(
        jcfg, jstore.offsets, jstore.sizes, keys, seed)
    assert got.gather.dtype == want.gather.dtype == np.int32
    np.testing.assert_array_equal(got.gather, want.gather)
    np.testing.assert_array_equal(got.rot_k, want.rot_k)
    assert got.seed == want.seed


@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_task_builders_match_jax(geometry, augment):
    """``episode``, ``episode_uint8`` and ``episode_indices`` against the
    JAX dataset's methods of the same names, over several task seeds."""
    jcfg, cfg = _cfgs(geometry)
    store, jstore = _stores(cfg, seed=2)
    keys = loader.class_keys_of(store)
    base = 1000
    ds = _jax_dataset(jcfg, jstore, base)
    for idx in range(4):
        seed = base + idx
        ie, jie = (loader.episode_indices(cfg, store, keys, seed),
                   ds.episode_indices("train", idx))
        np.testing.assert_array_equal(ie.gather, jie.gather)
        np.testing.assert_array_equal(ie.rot_k, jie.rot_k)
        for got, want in (
                (loader.episode(cfg, store, keys, seed, augment),
                 ds.episode("train", idx, augment)),
                (loader.episode_uint8(cfg, store, keys, seed, augment),
                 ds.episode_uint8("train", idx, augment))):
            for field in ("x_support", "x_target", "y_support",
                          "y_target"):
                g, w = getattr(got, field), getattr(want, field)
                assert g.dtype == w.dtype, field
                np.testing.assert_array_equal(g, w, err_msg=field)
            assert got.seed == want.seed


def test_omniglot_rotations_are_drawn_and_applied():
    """The rot90 draws reach the host pixels (train-time Omniglot only):
    some class is rotated, and without augment none is."""
    _, cfg = _cfgs()
    store, _ = _stores(cfg, seed=4)
    keys = loader.class_keys_of(store)
    ie = loader.episode_indices(cfg, store, keys, 9)
    assert (ie.rot_k != 0).any()
    rotated = loader.episode_uint8(cfg, store, keys, 9, True)
    plain = loader.episode_uint8(cfg, store, keys, 9, False)
    for i, k in enumerate(ie.rot_k):
        np.testing.assert_array_equal(
            rotated.x_support[i], np.rot90(plain.x_support[i], k, (1, 2)))


def test_flat_store_views_and_index_batch_match_jax():
    jcfg, cfg = _cfgs()
    store, jstore = _stores(cfg, seed=1)
    views, jviews = store.views(), jstore.views()
    assert list(views) == list(jviews)
    for key in views:
        np.testing.assert_array_equal(views[key], jviews[key])
    keys = loader.class_keys_of(store)
    eps = [loader.episode_indices(cfg, store, keys, s) for s in (5, 6, 7)]
    batch = loader.stack_indices(eps, "train", True)
    jbatch = JaxIndexBatch(
        gather=np.stack([e.gather for e in eps]),
        rot_k=np.stack([e.rot_k for e in eps]),
        seeds=np.array([5, 6, 7], np.int64), set_name="train",
        augment=True)
    assert batch.gather.shape == (3, 4, 5) and batch.seeds.tolist() == [
        5, 6, 7]
    np.testing.assert_array_equal(batch.target_labels(3),
                                  jbatch.target_labels(3))
    host = loader.stack([loader.episode(cfg, store, keys, s, True)
                         for s in (5, 6, 7)])
    np.testing.assert_array_equal(host[3], batch.target_labels(3))
    assert host[4].tolist() == [5, 6, 7]


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_the_three_tiers_give_the_same_pixels(geometry):
    """For one batch of tasks: the host tier's float pixels equal the
    uint8 tier's pixels decoded by the plain twin and the index tier's
    rows expanded by the plain twin, bit for bit."""
    import torch

    _, cfg = _cfgs(geometry)
    store, _ = _stores(cfg, seed=3)
    keys = loader.class_keys_of(store)
    seeds = (11, 12, 13)
    host = loader.stack([loader.episode(cfg, store, keys, s, True)
                         for s in seeds])
    u8 = loader.stack([loader.episode_uint8(cfg, store, keys, s, True)
                       for s in seeds])
    idx = loader.stack_indices([loader.episode_indices(cfg, store, keys, s)
                                for s in seeds], "train", True)
    decode = dp.make_decoder(cfg)
    for got, want in ((decode(torch.from_numpy(u8[0])), host[0]),
                      (decode(torch.from_numpy(u8[1])), host[1])):
        np.testing.assert_array_equal(got.numpy(), want)
    x_s, y_s, x_t, y_t = dp.make_index_expander(cfg, augment=True)(
        torch.from_numpy(store.data), torch.from_numpy(idx.gather),
        torch.from_numpy(idx.rot_k))
    np.testing.assert_array_equal(x_s.numpy(), host[0])
    np.testing.assert_array_equal(x_t.numpy(), host[1])
    np.testing.assert_array_equal(y_s.numpy(), host[2])
    np.testing.assert_array_equal(y_t.numpy(), host[3])


def test_synthetic_train_store_has_the_real_split_size():
    """Omniglot: int(0.70918052988 * 1623) = 1150 classes x 20 images,
    pixels in {0, 1}; the ImageNet family: 64 x 600."""
    _, cfg = _cfgs(image_height=4, image_width=4,
                   train_val_test_split=[0.70918052988, 0.03080714725,
                                         0.2606284658])
    store = bench.synth_train_store(cfg, 0)
    assert len(store.offsets) == 1150 and store.data.shape == (23000, 4, 4,
                                                              1)
    assert set(np.unique(store.data)) == {0, 1}
    assert store.offsets["1149"] == 22980 and store.sizes["0"] == 20
    _, mini = _cfgs("mini_imagenet", image_height=2, image_width=2)
    store = bench.synth_train_store(mini, 0)
    assert store.data.shape == (38400, 2, 2, 3) and len(store.sizes) == 64
    np.testing.assert_array_equal(
        store.data, bench.synth_train_store(mini, 0).data)
