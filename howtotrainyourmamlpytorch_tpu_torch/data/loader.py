"""Per-task builders of the three data tiers over a flat store, and the
batch forms they stack into.

The port of the JAX package's ``data/loader.py`` pieces that the tiers
share: ``IndexBatch`` and the task builders of ``FewShotEpisodicDataset``
(``episode``, ``episode_indices``, ``episode_uint8``) as functions of a
``FlatStore``, its class keys and a task seed, plus ``_stack``. For one
seed the three draw the same task:

* ``episode`` (``data_placement='host'``): float32 pixels decoded and
  rotated on the host;
* ``episode_uint8`` (``'uint8_stream'``): uint8 pixels gathered and rotated
  on the host, decoded on the card;
* ``episode_indices`` (``'device'``): flat rows and rot90 draws only; the
  store lives on the card.

Not ported yet (ROADMAP Queue A7): the threaded ``MetaLearningDataLoader``
with its prefetch queue, seed streams and resume cursor.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np

from ..config import MAMLConfig
from .episodes import (
    Episode,
    IndexEpisode,
    sample_episode,
    sample_episode_indices,
)
from .preprocess import FlatStore

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


class IndexBatch(NamedTuple):
    """A stacked batch of ``IndexEpisode``s, the device tier's H2D form:
    ``gather`` (tasks, n_way, spc + nts) int32 flat-store rows, ``rot_k``
    (tasks, n_way) int32, ``seeds`` (tasks,) int64. Labels are implicit
    (sample (t, i, j) has label i)."""

    gather: np.ndarray
    rot_k: np.ndarray
    seeds: np.ndarray
    set_name: str
    augment: bool

    def target_labels(self, num_target_samples: int) -> np.ndarray:
        """(tasks, n_way, nts) int32, the host-side ``y_target``."""
        tasks, n, _ = self.gather.shape
        return np.tile(
            np.arange(n, dtype=np.int32)[None, :, None],
            (tasks, 1, num_target_samples),
        )


def class_keys_of(store: FlatStore) -> np.ndarray:
    """The store's class keys in insertion order (the order ``choice``
    draws from)."""
    return np.array(list(store.offsets.keys()))


def episode(cfg: MAMLConfig, store: FlatStore, class_keys: np.ndarray,
            seed: int, augment: bool) -> Episode:
    """One task's float32 pixels, decoded and rotated on the host."""
    return sample_episode(cfg, store.views(), class_keys, seed=seed,
                          augment=augment)


def episode_indices(cfg: MAMLConfig, store: FlatStore,
                    class_keys: np.ndarray, seed: int) -> IndexEpisode:
    """One task as flat rows and rot90 draws (no pixels)."""
    return sample_episode_indices(cfg, store.offsets, store.sizes,
                                  class_keys, seed=seed)


def episode_uint8(cfg: MAMLConfig, store: FlatStore, class_keys: np.ndarray,
                  seed: int, augment: bool) -> Episode:
    """One task's raw uint8 pixels, gathered and rotated on the host, the
    decode left to the card. rot90 of integer pixels commutes with the
    elementwise decode, so decoding this gives ``episode``'s values."""
    ie = episode_indices(cfg, store, class_keys, seed)
    x = store.data[ie.gather]  # (n, spc+nts, h, w, c)
    if augment and "omniglot" in cfg.dataset_name:
        x = np.stack([np.rot90(x[i], k=int(k), axes=(1, 2))
                      for i, k in enumerate(ie.rot_k)])
    x = np.ascontiguousarray(x)
    spc, nts = cfg.num_samples_per_class, cfg.num_target_samples
    y = np.tile(np.arange(cfg.num_classes_per_set, dtype=np.int32)[:, None],
                (1, spc + nts))
    return Episode(x_support=x[:, :spc], x_target=x[:, spc:],
                   y_support=y[:, :spc], y_target=y[:, spc:], seed=ie.seed)


def stack(episodes: Sequence[Episode]) -> Batch:
    """``(x_s, x_t, y_s, y_t, seeds)`` with a leading task axis."""
    return (
        np.stack([e.x_support for e in episodes]),
        np.stack([e.x_target for e in episodes]),
        np.stack([e.y_support for e in episodes]),
        np.stack([e.y_target for e in episodes]),
        np.array([e.seed for e in episodes], np.int64),
    )


def stack_indices(episodes: Sequence[IndexEpisode], set_name: str,
                  augment: bool) -> IndexBatch:
    """An ``IndexBatch`` of index episodes."""
    return IndexBatch(
        gather=np.stack([e.gather for e in episodes]),
        rot_k=np.stack([e.rot_k for e in episodes]),
        seeds=np.array([e.seed for e in episodes], np.int64),
        set_name=set_name, augment=augment,
    )
