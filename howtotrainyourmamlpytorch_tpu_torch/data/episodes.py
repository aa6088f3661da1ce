"""Episode (task) sampling with the reference's exact RNG discipline.

The port of the JAX package's ``data/episodes.py``: the image decode
(``load_image_uint8`` :47, ``load_image`` :81, ``decode_cached``), the
rng-free transform rules (``augment_stack``), the index-only episode
(``IndexEpisode``, ``sample_episode_indices``) and ``sample_episode`` over
per-class arrays or image paths. Numpy only, so every tier draws the same
tasks as the JAX package for the same seed.

RNG sequence per task (``np.random.RandomState(seed)``), as the reference's
``get_set``:

1. ``choice(class_keys, num_classes_per_set, replace=False)``;
2. ``shuffle(selected_classes)``;
3. ``randint(0, 4, num_classes_per_set)``: the rot90 k of each class;
4. per class: ``choice(class_size, spc + targets, replace=False)``.

Quirks kept: Omniglot pixels are float32 in their integer range (no
``/255``); ImageNet-family pixels are ``/255`` then normalized with the
ImageNet statistics whatever the augment flag; k is always drawn but only
applied to train-time Omniglot. Not ported yet: CIFAR's per-image crop
and flip (``augment_image``).

PIL is not a dependency. A PNG at the config's size whose pixels PIL's
``resize`` and ``convert`` would leave as they are (``png.decode``: 8-bit
grey, RGB or RGBA, or 1-bit, non-interlaced, no transparency) is read by
``data/png.py``, bit for bit what the JAX package's PIL decode gives. Any
other file (a JPEG, a resize such as Omniglot's LANCZOS 105 -> 28)
takes the JAX package's PIL route through an import inside the function,
which raises ``ImportError`` naming the file where PIL is missing.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Union

import numpy as np

from ..config import MAMLConfig
from . import png

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class Episode(NamedTuple):
    """One few-shot task, NHWC. Shapes: x (n_way, k, h, w, c), y (n_way, k)."""

    x_support: np.ndarray
    x_target: np.ndarray
    y_support: np.ndarray
    y_target: np.ndarray
    seed: int


class IndexEpisode(NamedTuple):
    """One task as flat-store rows: ``gather[i, j]`` is the row of the j-th
    sample of episode class i (columns ``[:spc]`` support, ``[spc:]``
    target), ``rot_k[i]`` class i's rot90 draw. Sample (i, j) has label i."""

    gather: np.ndarray  # (n_way, spc + nts) int32
    rot_k: np.ndarray  # (n_way,) int32
    seed: int


def _as_uint8(cfg: MAMLConfig, mode: str, arr: np.ndarray) -> np.ndarray:
    """The JAX decode's array for a PNG already at the target size: the
    pixels as ``np.asarray`` gives them after PIL's (identity) ``resize``,
    then ``convert('RGB')`` outside Omniglot (grey replicated, 1-bit to
    0/255, alpha dropped)."""
    if "omniglot" in cfg.dataset_name:
        if cfg.image_channels == 1 and arr.ndim == 2:
            arr = arr[:, :, None]
        return arr
    if mode == "1":
        arr = arr * np.uint8(255)
    if arr.ndim == 2:
        return np.repeat(arr[:, :, None], 3, axis=2)
    return np.ascontiguousarray(arr[:, :, :3])


def _load_with_pil(cfg: MAMLConfig, image_path: str) -> np.ndarray:
    """The JAX package's decode (``load_image_uint8``), for the files the
    port's PNG reader leaves to PIL."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding {image_path!r} needs PIL (a JPEG, a resize to "
            f"{cfg.image_height}x{cfg.image_width} or a PNG form the port's "
            "reader does not take); PIL is not installed"
        ) from e
    image = Image.open(image_path)
    if "omniglot" in cfg.dataset_name:
        image = image.resize(
            (cfg.image_height, cfg.image_width), resample=Image.LANCZOS
        )
        arr = np.asarray(image)
        if arr.dtype == bool:
            arr = arr.astype(np.uint8)
        if cfg.image_channels == 1 and arr.ndim == 2:
            arr = arr[:, :, None]
    else:
        image = image.resize((cfg.image_height, cfg.image_width)).convert(
            "RGB")
        arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise ValueError(
            f"{image_path!r} decodes to {arr.dtype}, not uint8 — only 8-bit "
            f"(or 1-bit) sources are supported, like the reference's datasets"
        )
    return arr


def load_image_uint8(cfg: MAMLConfig, image_path: str) -> np.ndarray:
    """One image in its integer (uint8 HWC) form, before the cast and
    scale ``decode_cached`` applies: the JAX package's ``load_image_uint8``
    bit for bit. A PNG at the target size goes through ``data/png.py``;
    anything else through PIL (see the module docstring)."""
    decoded = png.decode_file(image_path)
    if decoded is not None:
        mode, arr = decoded
        # PIL's size is (width, height) and the JAX decode resizes to
        # (image_height, image_width): at that size the resize is a copy
        if (arr.shape[1], arr.shape[0]) == (cfg.image_height,
                                            cfg.image_width):
            return _as_uint8(cfg, mode, arr)
    return _load_with_pil(cfg, image_path)


def load_image(cfg: MAMLConfig, image_path: str) -> np.ndarray:
    """One image as the reference's float32 HWC values."""
    return decode_cached(cfg, load_image_uint8(cfg, image_path))


def decode_cached(cfg: MAMLConfig, arr: np.ndarray) -> np.ndarray:
    """uint8 pixels -> the reference's float values: a plain float32 cast
    for Omniglot, ``/255`` otherwise, then the RGB -> BGR flip under
    ``reverse_channels``."""
    if "omniglot" in cfg.dataset_name:
        out = arr.astype(np.float32)
    else:
        out = arr.astype(np.float32) / 255.0
    if cfg.reverse_channels:
        out = np.ascontiguousarray(out[..., ::-1])
    return out


def augment_stack(cfg: MAMLConfig, images: np.ndarray, k: int,
                  augment: bool) -> np.ndarray:
    """The rng-free transform rules on an (n, h, w, c) stack: rot90 by k
    for train-time Omniglot, the ImageNet normalization for the ImageNet
    family, nothing otherwise."""
    name = cfg.dataset_name
    if "omniglot" in name:
        if augment:
            images = np.rot90(images, k=k, axes=(1, 2))
        return np.ascontiguousarray(images)
    if "imagenet" in name:
        return (images - IMAGENET_MEAN) / IMAGENET_STD
    return images


def _draw_classes(cfg: MAMLConfig, class_keys: np.ndarray, seed: int):
    """Draws 1-3 of the RNG sequence; returns (rng, classes, k per class)."""
    rng = np.random.RandomState(seed)
    selected = rng.choice(class_keys, size=cfg.num_classes_per_set,
                          replace=False)
    rng.shuffle(selected)
    k_list = rng.randint(0, 4, size=cfg.num_classes_per_set)
    return rng, selected, k_list


def sample_episode_indices(cfg: MAMLConfig, offsets: Dict[str, int],
                           sizes: Dict[str, int], class_keys: np.ndarray,
                           seed: int) -> IndexEpisode:
    """One task as gather rows into a flat store: the same four draws as
    ``sample_episode``, so ``store.data[gather]`` is the pixel path's
    gather before decode, for any seed."""
    rng, selected, k_list = _draw_classes(cfg, class_keys, seed)
    spc, nts = cfg.num_samples_per_class, cfg.num_target_samples
    rows = np.empty((cfg.num_classes_per_set, spc + nts), np.int32)
    for episode_label, class_key in enumerate(selected):
        sample_idx = rng.choice(sizes[class_key], size=spc + nts,
                                replace=False)
        rows[episode_label] = offsets[class_key] + sample_idx
    return IndexEpisode(gather=rows, rot_k=k_list.astype(np.int32),
                        seed=seed)


ClassStore = Dict[str, Union[List[str], np.ndarray]]


def sample_episode(cfg: MAMLConfig, classes: ClassStore,
                   class_keys: np.ndarray, seed: int,
                   augment: bool) -> Episode:
    """One task from per-class (n, h, w, c) arrays (uint8 store views are
    decoded with ``decode_cached``) or per-class image paths, decoded here
    one image at a time (``load_image``) with the same transform rules.

    :param class_keys: the class keys in the reference's order; the order
        decides which classes ``choice`` draws.
    """
    if "cifar" in cfg.dataset_name:
        raise NotImplementedError(
            "CIFAR's per-image crop and flip (augment_image) are not ported"
        )
    rng, selected, k_list = _draw_classes(cfg, class_keys, seed)
    spc, nts = cfg.num_samples_per_class, cfg.num_target_samples
    x_images, y_labels = [], []
    for episode_label, class_key in enumerate(selected):
        store = classes[class_key]
        sample_idx = rng.choice(len(store), size=spc + nts, replace=False)
        if isinstance(store, np.ndarray):
            imgs = store[sample_idx]
            if imgs.dtype == np.uint8:
                imgs = decode_cached(cfg, imgs)
        else:
            imgs = np.stack([load_image(cfg, store[i]) for i in sample_idx])
        x_images.append(np.ascontiguousarray(augment_stack(
            cfg, imgs, int(k_list[episode_label]), augment)))
        y_labels.append(np.full(spc + nts, episode_label, np.int32))
    x = np.stack(x_images).astype(np.float32)  # (n, spc+nts, h, w, c)
    y = np.stack(y_labels)
    return Episode(x_support=x[:, :spc], x_target=x[:, spc:],
                   y_support=y[:, :spc], y_target=y[:, spc:], seed=seed)
