"""Dataset bootstrap: unpack and validate before training starts.

The port of the JAX package's ``utils/dataset_tools.py``: if the dataset
directory is missing, extract ``$DATASET_DIR/<name>.tar.bz2`` with
``tarfile``; then hold the known datasets to their image-file counts
(Omniglot 1623 x 20, mini-ImageNet 100 x 600, the pickled mini-ImageNet's 3
files) and delete and re-extract once on a mismatch, never deleting a
folder that has no archive to come back from. A dataset of any other name
has no count.
"""

from __future__ import annotations

import os
import shutil
import tarfile

EXPECTED_COUNTS = {
    "omniglot_dataset": 1623 * 20,
    "mini_imagenet": 100 * 600,
    "mini_imagenet_pkl": 3,
}

_IMAGE_EXTS = (".jpeg", ".jpg", ".png", ".pkl")


def count_dataset_files(dataset_path: str) -> int:
    total = 0
    for _, _, files in os.walk(dataset_path):
        total += sum(1 for f in files if f.lower().endswith(_IMAGE_EXTS))
    return total


def expected_count(dataset_name: str):
    """The known dataset's file count, or None for a user dataset."""
    if dataset_name == "omniglot_dataset":
        return EXPECTED_COUNTS["omniglot_dataset"]
    if "mini_imagenet_pkl" in dataset_name:
        return EXPECTED_COUNTS["mini_imagenet_pkl"]
    if "mini_imagenet" in dataset_name:
        return EXPECTED_COUNTS["mini_imagenet"]
    return None


def unzip_file(archive_path: str, dest_dir: str) -> None:
    """Extract a .tar.bz2 archive."""
    with tarfile.open(archive_path, "r:bz2") as tf:
        tf.extractall(dest_dir, filter="data")


def maybe_unzip_dataset(cfg) -> None:
    """Ensure ``cfg.dataset_path`` exists with the right file count.

    Sets ``cfg.reset_stored_filepaths`` after a fresh extraction, so the
    cached path index is rebuilt.
    """
    dataset_path = cfg.dataset_path.rstrip("/")
    dataset_dir = os.environ.get(
        "DATASET_DIR", os.path.dirname(dataset_path) or "."
    )
    archive = os.path.join(dataset_dir, f"{cfg.dataset_name}.tar.bz2")
    expected = expected_count(cfg.dataset_name)
    for _ in range(2):
        if not os.path.exists(dataset_path):
            if not os.path.exists(archive):
                raise FileNotFoundError(
                    f"dataset folder {dataset_path!r} missing and no archive "
                    f"at {os.path.abspath(archive)}; place the dataset as "
                    f"explained in README.md"
                )
            print(f"[dataset] extracting {archive} -> {dataset_dir}",
                  flush=True)
            unzip_file(archive, dataset_dir)
            cfg.reset_stored_filepaths = True
            if not os.path.exists(dataset_path):
                raise RuntimeError(
                    f"extracted {archive} but {dataset_path!r} still does not "
                    f"exist — the archive's top-level folder must be named "
                    f"{os.path.basename(dataset_path)!r}"
                )
        if expected is None:
            return
        total = count_dataset_files(dataset_path)
        if total == expected:
            return
        if not os.path.exists(archive):
            raise RuntimeError(
                f"dataset {cfg.dataset_name!r} has {total} files, expected "
                f"{expected}, and no archive exists at "
                f"{os.path.abspath(archive)} to re-extract from; refusing to "
                f"delete the existing folder"
            )
        print(f"[dataset] file count {total} != expected {expected}; "
              f"removing and re-extracting", flush=True)
        shutil.rmtree(dataset_path, ignore_errors=True)
    raise RuntimeError(
        f"dataset {cfg.dataset_name!r} failed count validation after "
        f"re-extraction (expected {expected})"
    )
