"""Dataset indexing, caching, splitting and in-RAM preloading.

The port of the JAX package's ``data/datasets.py``: ``draw_stream_seeds``
(:42), ``scan_dataset`` (:80), ``load_class_index`` (:101, with its JSON
cache of the path index under ``cache_dir``), ``split_classes`` (:124) and
``preload_to_memory`` (:165). The cache files and the class order are the
JAX package's, so either package reads an index the other wrote and both
draw the same tasks.

The corrupt-image screen opens each file as the JAX package does with
``PIL.Image.open``, except that a PNG is screened by its header
(``png.read_header``) so a PNG dataset needs no PIL.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from ..config import MAMLConfig
from . import png
from .episodes import load_image

ClassIndex = Dict[str, List[str]]  # class key -> image file paths


def draw_stream_seeds(cfg: MAMLConfig) -> Dict[str, int]:
    """Initial per-set task-stream seeds; test shares val's seed, as the
    reference builds both from ``val_seed``."""
    val_seed = int(np.random.RandomState(cfg.val_seed).randint(1, 999999))
    train_seed = int(np.random.RandomState(cfg.train_seed).randint(1, 999999))
    return {"train": train_seed, "val": val_seed, "test": val_seed}


def _cache_paths(cfg: MAMLConfig, cache_dir: str) -> Tuple[str, str, str]:
    os.makedirs(cache_dir, exist_ok=True)
    return (
        os.path.join(cache_dir, f"{cfg.dataset_name}.json"),
        os.path.join(cache_dir, f"map_to_label_name_{cfg.dataset_name}.json"),
        os.path.join(cache_dir, f"label_name_to_map_{cfg.dataset_name}.json"),
    )


def _label_from_path(cfg: MAMLConfig, filepath: str):
    """Class label from the folder structure."""
    bits = filepath.split("/")
    label = "/".join(bits[idx] for idx in cfg.indexes_of_folders_indicating_class)
    return int(label) if cfg.labels_as_int else label


def _screen_image(filepath: str):
    """Corrupt-image check: a file that opens is kept."""
    try:
        png.read_header(filepath)
        return filepath
    except (OSError, ValueError):
        pass
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"screening {filepath!r} needs PIL (it is not a readable PNG); "
            "PIL is not installed"
        ) from e
    try:
        Image.open(filepath)
        return filepath
    except Exception:
        return None


def scan_dataset(cfg: MAMLConfig) -> Tuple[Dict[str, List[str]], Dict, Dict]:
    """Walk the dataset dir and build the class index."""
    raw_paths: List[str] = []
    labels = set()
    for subdir, _, files in os.walk(cfg.dataset_path):
        for file in files:
            if file.lower().endswith((".jpeg", ".png", ".jpg")):
                filepath = os.path.abspath(os.path.join(subdir, file))
                raw_paths.append(filepath)
                labels.add(_label_from_path(cfg, filepath))
    labels = sorted(labels)
    idx_to_label = {idx: label for idx, label in enumerate(labels)}
    label_to_idx = {label: idx for idx, label in enumerate(labels)}
    index: Dict[str, List[str]] = {str(idx): [] for idx in idx_to_label}
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        for ok in ex.map(_screen_image, raw_paths, chunksize=256):
            if ok is not None:
                index[str(label_to_idx[_label_from_path(cfg, ok)])].append(ok)
    return index, idx_to_label, label_to_idx


def load_class_index(cfg: MAMLConfig, cache_dir: str):
    """The class index, JSON-cached under ``cache_dir``."""
    index_file, i2l_file, l2i_file = _cache_paths(cfg, cache_dir)
    if cfg.reset_stored_filepaths and os.path.exists(index_file):
        os.remove(index_file)
    if os.path.exists(index_file):
        with open(index_file) as f:
            index = json.load(f)
        with open(i2l_file) as f:
            idx_to_label = {int(k): v for k, v in json.load(f).items()}
        with open(l2i_file) as f:
            label_to_idx = json.load(f)
        return index, idx_to_label, label_to_idx
    index, idx_to_label, label_to_idx = scan_dataset(cfg)
    with open(index_file, "w") as f:
        json.dump(index, f)
    with open(i2l_file, "w") as f:
        json.dump(idx_to_label, f)
    with open(l2i_file, "w") as f:
        json.dump({str(k): v for k, v in label_to_idx.items()}, f)
    return index, idx_to_label, label_to_idx


def split_classes(cfg: MAMLConfig, index: ClassIndex,
                  idx_to_label: Dict[int, str], val_stream_seed: int
                  ) -> Dict[str, ClassIndex]:
    """Train/val/test class partition: by the first path component of the
    label when the sets are pre-split, else the classes shuffled with the
    drawn val seed and cut at the cumulative split fractions."""
    if cfg.sets_are_pre_split:
        splits: Dict[str, ClassIndex] = {}
        for key, paths in index.items():
            label = idx_to_label[int(key)]
            set_name, class_label = label.split("/")[0], label.split("/")[1]
            splits.setdefault(set_name, {})[class_label] = paths
        return splits
    rng = np.random.RandomState(seed=val_stream_seed)
    keys = list(index.keys())
    order = np.arange(len(keys), dtype=np.int32)
    rng.shuffle(order)
    keys = [keys[i] for i in order]
    total = len(keys)
    n_train = int(cfg.train_val_test_split[0] * total)
    n_val = int(sum(cfg.train_val_test_split[:2]) * total)
    return {
        "train": {k: index[k] for k in keys[:n_train]},
        "val": {k: index[k] for k in keys[n_train:n_val]},
        "test": {k: index[k] for k in keys[n_val:]},
    }


def _load_class(args) -> Tuple[str, np.ndarray]:
    cfg, class_key, paths = args
    images = np.stack([load_image(cfg, p) for p in paths]).astype(np.float32)
    return class_key, images


def preload_to_memory(cfg: MAMLConfig, splits: Dict[str, ClassIndex]
                      ) -> Dict[str, Dict[str, np.ndarray]]:
    """Decode every image once into float32 arrays."""
    loaded: Dict[str, Dict[str, np.ndarray]] = {}
    for set_name, classes in splits.items():
        loaded[set_name] = {}
        jobs = [(cfg, k, v) for k, v in classes.items()]
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
            for class_key, images in ex.map(_load_class, jobs):
                loaded[set_name][class_key] = images
    return loaded
