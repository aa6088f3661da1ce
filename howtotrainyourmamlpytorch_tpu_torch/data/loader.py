"""The batched, prefetching, resume-exact episodic data loader.

The port of the JAX package's ``data/loader.py``: ``ProducerCrashedError``
(:41), ``IndexBatch``, ``FewShotEpisodicDataset`` (:80) and
``MetaLearningDataLoader`` (:185). A batch is ``global_tasks_per_batch``
tasks stacked on a leading task axis; task ``i`` of a set's stream has
seed ``seed[set] + i``. A background thread builds each batch over a pool
of ``num_dataprovider_workers`` threads into a queue of
``prefetch_batches``; a producer's death is latched and re-raised from
every later pull. ``continue_from_iter`` and the checkpointed
``episode_cursor`` continue the train stream at the next unseen task after
a resume, and the val and test streams restart from their fixed seed on
every call (so validation tasks repeat every epoch and the test stream is
the val stream). ``shard_id`` / ``num_shards`` default to 0 / 1: one
process builds every task.

The task builders of the three tiers are also functions of a
``FlatStore``, its class keys and a task seed (``episode``,
``episode_indices``, ``episode_uint8``), which ``train-bench`` calls
directly. For one seed the three draw the same task:

* ``episode`` (``data_placement='host'``): float32 pixels decoded and
  rotated on the host;
* ``episode_uint8`` (``'uint8_stream'``): uint8 pixels gathered and rotated
  on the host, decoded on the card;
* ``episode_indices`` (``'device'``): flat rows and rot90 draws only; the
  store lives on the card.

The producer's fault-injection seam and tracing spans wait for ROADMAP
Queue A (``parallel/`` and ``resilience/``; telemetry).
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
import time
from typing import Dict, Iterator, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np

from ..config import MAMLConfig
from ..resilience import elastic
from . import datasets as ds
from .episodes import (
    Episode,
    IndexEpisode,
    sample_episode,
    sample_episode_indices,
)
from .preprocess import FlatStore

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


class ProducerCrashedError(RuntimeError):
    """The background episode-producer thread died with an exception. The
    original exception is chained (``__cause__``); every later
    ``get_*_batches`` pull re-raises, so a run never trains on a starved
    stream."""


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


AnyBatch = Union[Batch, IndexBatch]


class FewShotEpisodicDataset:
    """The class index, the splits and the per-set seed state; the task
    builders of the three tiers over them."""

    def __init__(self, cfg: MAMLConfig, cache_dir: Optional[str] = None):
        self.cfg = cfg
        cache_dir = cache_dir or cfg.cache_dir or "."
        self.init_seed = ds.draw_stream_seeds(cfg)
        self.seed = dict(self.init_seed)
        index, idx_to_label, _ = ds.load_class_index(cfg, cache_dir)
        self.splits = ds.split_classes(cfg, index, idx_to_label,
                                       self.seed["val"])
        # the flat uint8 stores back the uint8 and device tiers; the pixel
        # path's per-class views are slices of the same memmap, so every
        # tier reads the same bytes
        self.flat_stores: Dict[str, FlatStore] = {}
        if cfg.use_mmap_cache:
            from .preprocess import build_mmap_cache_flat

            self.flat_stores = build_mmap_cache_flat(cfg, self.splits,
                                                     cache_dir)
            self.splits = {name: fs.views()
                           for name, fs in self.flat_stores.items()}
        elif cfg.load_into_memory:
            self.splits = ds.preload_to_memory(cfg, self.splits)
        # a set's class order is its dict's insertion order: the order
        # rng.choice draws from in the reference
        self.class_keys = {name: np.array(list(classes.keys()))
                           for name, classes in self.splits.items()}
        for name, keys in self.class_keys.items():
            if len(keys) < cfg.num_classes_per_set:
                raise ValueError(
                    f"set {name!r} has {len(keys)} classes < "
                    f"num_classes_per_set={cfg.num_classes_per_set}"
                )

    def update_train_seed(self, current_iter: int) -> None:
        """The train stream's seed after ``current_iter`` tasks."""
        self.seed["train"] = self.init_seed["train"] + current_iter

    def episode(self, set_name: str, idx: int, augment: bool) -> Episode:
        return sample_episode(self.cfg, self.splits[set_name],
                              self.class_keys[set_name],
                              seed=self.seed[set_name] + idx, augment=augment)

    def episode_indices(self, set_name: str, idx: int) -> IndexEpisode:
        return episode_indices(self.cfg, self.flat_stores[set_name],
                               self.class_keys[set_name],
                               self.seed[set_name] + idx)

    def episode_uint8(self, set_name: str, idx: int, augment: bool
                      ) -> Episode:
        return episode_uint8(self.cfg, self.flat_stores[set_name],
                             self.class_keys[set_name],
                             self.seed[set_name] + idx, augment)


class MetaLearningDataLoader:
    """Batch generators with a background prefetch thread.

    ``shard_id`` / ``num_shards`` pick this process's contiguous block of
    every global batch (``elastic.shard_slice``); seeds come from global
    task indices, so the blocks of all processes make up a one-process
    run's batch. ``episode_cursor`` (from a checkpoint) is the global
    cursor of the next unseen task; it must equal ``current_iter *
    tasks_per_batch``, or the batch size changed since the checkpoint.
    """

    def __init__(self, cfg: MAMLConfig, current_iter: int = 0,
                 cache_dir: Optional[str] = None, shard_id: int = 0,
                 num_shards: int = 1, episode_cursor: Optional[int] = None):
        self.cfg = cfg
        self.tasks_per_batch = cfg.global_tasks_per_batch
        self.shard_id = shard_id
        self.num_shards = max(1, num_shards)
        self._shard_lo, self._shard_hi = elastic.shard_slice(
            self.tasks_per_batch, self.shard_id, self.num_shards)
        self.tasks_per_shard = self._shard_hi - self._shard_lo
        self.dataset = FewShotEpisodicDataset(cfg, cache_dir)
        self.total_train_iters_produced = 0
        # the producer's cumulative episode-assembly seconds, seconds
        # blocked on a full queue, queue depth after each put and batches
        # (the epoch summary's stream_* columns); train and val producers
        # may overlap, hence the lock
        self._stats_lock = threading.Lock()
        self.stream_stats = {
            "assembly_s": 0.0, "stall_s": 0.0, "depth_sum": 0.0, "batches": 0,
        }
        self._last_producer_thread: Optional[threading.Thread] = None
        # a producer's death, re-raised from every later pull
        self._producer_error: Optional[BaseException] = None
        if episode_cursor is not None:
            derived = elastic.episode_cursor_for_iter(current_iter,
                                                      self.tasks_per_batch)
            if int(episode_cursor) != derived:
                raise ValueError(
                    f"checkpointed episode cursor {int(episode_cursor)} does "
                    f"not equal current_iter * tasks_per_batch = "
                    f"{current_iter} * {self.tasks_per_batch} = {derived}; "
                    "the global meta-batch size changed since the "
                    "checkpoint was written, which breaks deterministic "
                    "episode-stream resume (restore the original "
                    "batch_size/num_of_gpus/samples_per_iter, or restart "
                    "from_scratch)"
                )
            self.total_train_iters_produced += int(episode_cursor)
        else:
            self.continue_from_iter(current_iter)

    def pop_stream_stats(self) -> Dict[str, float]:
        """Return and reset the producer's cumulative statistics."""
        with self._stats_lock:
            out = dict(self.stream_stats)
            self.stream_stats = {
                "assembly_s": 0.0, "stall_s": 0.0, "depth_sum": 0.0,
                "batches": 0,
            }
        return out

    def continue_from_iter(self, current_iter: int) -> None:
        """Fast-forward the train stream after a resume."""
        self.total_train_iters_produced += current_iter * self.tasks_per_batch

    def _episode_builder(self, set_name: str, augment: bool):
        """(build, stack) of the configured tier: host float32 pixels, raw
        uint8 pixels (decoded on the card) or index-only batches."""
        placement = self.cfg.data_placement
        dataset = self.dataset
        if placement == "device":
            return (lambda i: dataset.episode_indices(set_name, i),
                    lambda eps: stack_indices(eps, set_name, augment))
        if placement == "uint8_stream":
            return lambda i: dataset.episode_uint8(set_name, i, augment), stack
        return lambda i: dataset.episode(set_name, i, augment), stack

    def _batches(self, set_name: str, total_batches: int, augment: bool
                 ) -> Iterator[AnyBatch]:
        tpb = self.tasks_per_batch
        workers = max(1, self.cfg.num_dataprovider_workers)
        out: "queue.Queue" = queue.Queue(
            maxsize=max(1, self.cfg.prefetch_batches))
        stop = threading.Event()
        build, stack_fn = self._episode_builder(set_name, augment)
        lo, hi = self._shard_lo, self._shard_hi

        def put(item) -> bool:
            # a polling put, so an abandoned generator's stop is seen even
            # while the queue is full
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with concurrent.futures.ThreadPoolExecutor(workers) as pool:
                    for b in range(total_batches):
                        if stop.is_set():
                            return
                        t0 = time.perf_counter()
                        batch = stack_fn(list(pool.map(
                            build, range(b * tpb + lo, b * tpb + hi))))
                        t1 = time.perf_counter()
                        if not put(batch):
                            return
                        t2 = time.perf_counter()
                        with self._stats_lock:
                            self.stream_stats["assembly_s"] += t1 - t0
                            self.stream_stats["stall_s"] += t2 - t1
                            self.stream_stats["depth_sum"] += out.qsize()
                            self.stream_stats["batches"] += 1
                put(None)
            except BaseException as exc:  # handed to the consumer
                # latched first: the next pull of any stream sees it even
                # if the enqueue below never lands
                self._producer_error = exc
                put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        self._last_producer_thread = thread
        thread.start()
        try:
            while True:
                while True:
                    try:
                        # a timed poll: a producer that died between puts
                        # never parks the consumer for good
                        item = out.get(timeout=0.2)
                        break
                    except queue.Empty:
                        if self._producer_error is not None:
                            self._raise_producer_error()
                        if not thread.is_alive():
                            raise ProducerCrashedError(
                                f"episode producer thread for set "
                                f"{set_name!r} died without delivering a "
                                "batch or an error"
                            )
                if item is None:
                    return
                if isinstance(item, BaseException):
                    self._producer_error = item
                    self._raise_producer_error()
                yield item
        finally:
            stop.set()

    def _raise_producer_error(self):
        exc = self._producer_error
        raise ProducerCrashedError(
            f"episode producer thread crashed: {exc!r}") from exc

    def _check_producer(self) -> None:
        if self._producer_error is not None:
            self._raise_producer_error()

    def get_train_batches(self, total_batches: int,
                          augment_images: bool = False
                          ) -> Iterator[AnyBatch]:
        self._check_producer()
        self.dataset.update_train_seed(self.total_train_iters_produced)
        # advanced once a call, not a batch: the reference's quirk, which
        # the resume arithmetic depends on
        self.total_train_iters_produced += self.tasks_per_batch
        return self._batches("train", total_batches, augment_images)

    def get_val_batches(self, total_batches: int,
                        augment_images: bool = False) -> Iterator[AnyBatch]:
        self._check_producer()
        return self._batches("val", total_batches, augment_images)

    def get_test_batches(self, total_batches: int,
                         augment_images: bool = False) -> Iterator[AnyBatch]:
        self._check_producer()
        return self._batches("test", total_batches, augment_images)
