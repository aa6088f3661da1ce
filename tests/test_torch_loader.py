"""The port's data layer held to the JAX package's on the CPU, bit for bit:

* the image decode: the port's PNG reader against the JAX package's PIL
  ``load_image_uint8`` on 8-bit RGB, grey, RGBA and 1-bit files, every
  filter type, in both decode rules (Omniglot's and the ImageNet
  family's); without PIL a PNG at the target size still decodes and a
  resize raises ``ImportError`` naming the file;
* ``MetaLearningDataLoader``: the train, val and test batches of all three
  tiers (host pixels from paths or preloaded, host uint8, device index
  rows), with Omniglot's rot90 augmentation on, after
  ``continue_from_iter(k)`` and after an ``episode_cursor`` resume, equal
  the JAX loader's (``shard_id=0, num_shards=1``);
* the class-index and mmap caches: what either package writes, the other
  reads as it is;
* a dead producer is latched and re-raised from every later pull.

On the pre-split 10x10x3 dataset of ``tests/test_e2e_presplit.py``.
"""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image
from test_e2e_presplit import _write_presplit_rgb

from howtotrainyourmamlpytorch_tpu.config import MAMLConfig as JaxConfig
from howtotrainyourmamlpytorch_tpu.data import episodes as jax_episodes
from howtotrainyourmamlpytorch_tpu.data import loader as jax_loader
from howtotrainyourmamlpytorch_tpu.data import preprocess as jax_preprocess
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.data import (
    episodes,
    loader,
    png,
    preprocess,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RGB_NAME, OMNIGLOT_NAME = "tiny_presplit_rgb", "tiny_omniglot_rgb"


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("presplit")
    _write_presplit_rgb(str(root / "ds"))
    return str(root / "ds")


def _cfgs(data_root, cache_dir, name=RGB_NAME, **extra):
    kw = dict(
        dataset_name=name, dataset_path=data_root, sets_are_pre_split=True,
        indexes_of_folders_indicating_class=[-3, -2], image_height=10,
        image_width=10, image_channels=3, num_classes_per_set=2,
        num_samples_per_class=2, num_target_samples=2, batch_size=2,
        num_dataprovider_workers=2, cache_dir=str(cache_dir), seed=0,
    )
    kw.update(extra)
    return JaxConfig(**kw), MAMLConfig(**kw)


# -- the image decode --------------------------------------------------------


def _png_with_filter(pixels, ftype):
    """An 8-bit PNG whose every row carries filter ``ftype`` (the encoder
    side of the PNG filters, so the reader's inverse meets each one)."""
    a = pixels if pixels.ndim == 3 else pixels[:, :, None]
    h, w, c = a.shape
    raw = a.reshape(h, w * c).astype(np.int64)
    rows = []
    for y in range(h):
        x, up = raw[y], raw[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if ftype == 0:
            f = x
        elif ftype == 1:
            f = x - left
        elif ftype == 2:
            f = x - up
        elif ftype == 3:
            f = x - (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, upleft))
            f = x - pred
        rows.append(bytes([ftype]) + (f & 255).astype(np.uint8).tobytes())
    ctype = {1: 0, 3: 2, 4: 6}[c]

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body)))

    return (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_reader_undoes_every_filter_as_pil_does(tmp_path, ftype,
                                                    channels):
    rng = np.random.RandomState(ftype * 7 + channels)
    pixels = rng.randint(0, 256, (9, 7, channels)).astype(np.uint8)
    path = tmp_path / "im.png"
    path.write_bytes(_png_with_filter(pixels, ftype))
    mode, got = png.decode_file(str(path))
    want = np.asarray(Image.open(path))
    assert mode == Image.open(path).mode
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.reshape(pixels.shape), pixels)


def _write_pil(path, mode, rng, size=(10, 10)):
    h, w = size
    if mode == "1":
        im = Image.fromarray(rng.randint(0, 2, (h, w)).astype(bool))
    elif mode == "L":
        im = Image.fromarray(rng.randint(0, 256, (h, w)).astype(np.uint8))
    else:
        im = Image.fromarray(
            rng.randint(0, 256, (h, w, len(mode))).astype(np.uint8), mode)
    im.save(path)


@pytest.mark.parametrize("name", [RGB_NAME, "tiny_omniglot"])
@pytest.mark.parametrize("mode", ["RGB", "L", "1", "RGBA"])
def test_load_image_uint8_equals_the_jax_pil_decode(tmp_path, mode, name):
    rng = np.random.RandomState(len(mode))
    channels = 1 if mode in ("L", "1") and "omniglot" in name else 3
    jcfg, cfg = _cfgs(str(tmp_path), tmp_path, name,
                      image_channels=channels)
    path = str(tmp_path / f"im_{mode}.png")
    _write_pil(path, mode, rng)
    assert png.decode_file(path) is not None  # the port's own reader
    got = episodes.load_image_uint8(cfg, path)
    want = jax_episodes.load_image_uint8(jcfg, path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(episodes.load_image(cfg, path),
                                  jax_episodes.load_image(jcfg, path))


def test_png_writer_is_read_back_by_pil(tmp_path):
    rng = np.random.RandomState(0)
    for shape in ((5, 9), (5, 9, 1), (6, 4, 3), (3, 8, 4)):
        pixels = rng.randint(0, 256, shape).astype(np.uint8)
        png.write(str(tmp_path / "w.png"), pixels)
        want = np.asarray(Image.open(tmp_path / "w.png"))
        np.testing.assert_array_equal(want.reshape(pixels.shape), pixels)


_NO_PIL = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("PIL is blocked")
sys.meta_path.insert(0, _Block())
from howtotrainyourmamlpytorch_tpu_torch.config import MAMLConfig
from howtotrainyourmamlpytorch_tpu_torch.data import episodes
path, size = sys.argv[1], int(sys.argv[2])
cfg = MAMLConfig(dataset_name="tiny_presplit_rgb", image_height=size,
                 image_width=size, image_channels=3)
try:
    print(episodes.load_image_uint8(cfg, path).sum())
except ImportError as e:
    print("ImportError", e)
"""


def test_without_pil_a_target_size_png_decodes_and_a_resize_raises(tmp_path):
    rng = np.random.RandomState(1)
    pixels = rng.randint(0, 256, (10, 10, 3)).astype(np.uint8)
    path = str(tmp_path / "im.png")
    png.write(path, pixels)

    def run(size):
        out = subprocess.run(
            [sys.executable, "-c", _NO_PIL, path, str(size)], cwd=ROOT,
            capture_output=True, text=True, timeout=120, check=True)
        return out.stdout.strip()

    assert run(10) == str(pixels.astype(np.int64).sum())
    msg = run(8)
    assert msg.startswith("ImportError") and path in msg


# -- the loader ----------------------------------------------------------------

TIERS = {
    "host_paths": dict(),
    "host_preloaded": dict(load_into_memory=True),
    "host_mmap": dict(use_mmap_cache=True),
    "uint8_stream": dict(use_mmap_cache=True, data_placement="uint8_stream"),
    "device": dict(use_mmap_cache=True, data_placement="device"),
}


def _assert_batches_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    if isinstance(got, loader.IndexBatch):
        for field in ("gather", "rot_k", "seeds"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert (got.set_name, got.augment) == (want.set_name, want.augment)
        return
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _streams(data, augment):
    return [("train", list(data.get_train_batches(3, augment))),
            ("val", list(data.get_val_batches(2))),
            ("test", list(data.get_test_batches(2)))]


@pytest.mark.parametrize("name", [RGB_NAME, OMNIGLOT_NAME])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_loader_batches_equal_the_jax_loader(data_root, tmp_path, tier,
                                             name):
    jcfg, cfg = _cfgs(data_root, tmp_path / "cache", name, **TIERS[tier])
    augment = "omniglot" in name
    for current_iter, cursor in ((0, None), (3, None), (3, 6)):
        ours = loader.MetaLearningDataLoader(
            cfg, current_iter=current_iter, episode_cursor=cursor)
        ref = jax_loader.MetaLearningDataLoader(
            jcfg, current_iter=current_iter, shard_id=0, num_shards=1,
            episode_cursor=cursor)
        for (set_name, got), (_, want) in zip(_streams(ours, augment),
                                              _streams(ref, augment)):
            assert len(got) == len(want), set_name
            for g, w in zip(got, want):
                _assert_batches_equal(g, w)
        # a second train call continues where the quirk says it does
        _assert_batches_equal(next(iter(ours.get_train_batches(1))),
                              next(iter(ref.get_train_batches(1))))


def test_a_cursor_that_disagrees_with_the_iteration_is_refused(data_root,
                                                               tmp_path):
    _, cfg = _cfgs(data_root, tmp_path / "cache")
    with pytest.raises(ValueError, match="episode cursor"):
        loader.MetaLearningDataLoader(cfg, current_iter=3, episode_cursor=5)


def test_a_dead_producer_is_reraised_from_every_later_pull(data_root,
                                                           tmp_path):
    _, cfg = _cfgs(data_root, tmp_path / "cache")
    data = loader.MetaLearningDataLoader(cfg)

    def broken(*args):
        raise OSError("disk gone")

    data.dataset.episode = broken
    with pytest.raises(loader.ProducerCrashedError) as info:
        list(data.get_train_batches(2))
    assert isinstance(info.value.__cause__, OSError)
    for pull in (data.get_val_batches, data.get_test_batches,
                 data.get_train_batches):
        with pytest.raises(loader.ProducerCrashedError):
            list(pull(1))


# -- the caches ------------------------------------------------------------------


def _stat(cache_dir):
    return {f: os.stat(os.path.join(cache_dir, f)).st_mtime_ns
            for f in sorted(os.listdir(cache_dir))}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_cache_either_package_writes_the_other_reads(data_root, tmp_path,
                                                       writer):
    cache = tmp_path / "cache"
    jcfg, cfg = _cfgs(data_root, cache, use_mmap_cache=True)
    first, second = ((cfg, loader), (jcfg, jax_loader))
    if writer == "jax":
        first, second = second, first
    kw = dict(shard_id=0, num_shards=1)
    built = first[1].MetaLearningDataLoader(first[0], **kw)
    files = _stat(str(cache))
    assert any(f.endswith(".u8") for f in files)
    assert any(f == f"{RGB_NAME}.json" for f in files)
    read = second[1].MetaLearningDataLoader(second[0], **kw)
    assert _stat(str(cache)) == files  # read as it is, nothing rebuilt
    for name, store in built.dataset.flat_stores.items():
        other = read.dataset.flat_stores[name]
        np.testing.assert_array_equal(np.asarray(store.data),
                                      np.asarray(other.data))
        assert store.offsets == other.offsets and store.sizes == other.sizes


def test_the_mmap_cache_layout_is_the_jax_packages(data_root, tmp_path):
    jcfg, cfg = _cfgs(data_root, tmp_path)
    assert (preprocess._cache_base(cfg, "c", "train")
            == jax_preprocess._cache_base(jcfg, "c", "train"))
