"""The flat uint8 store and the memory-mapped image cache behind it.

The port of the JAX package's ``data/preprocess.py``: ``FlatStore``, one
set's images as a single (N, h, w, c) array, and the cache that decodes a
dataset once into it (``build_set_cache`` :89, ``build_set_cache_flat``
:97, ``build_mmap_cache`` :243, ``build_mmap_cache_flat`` :256). The
device tier uploads ``data`` to the card once; episode sampling then
needs only ``offsets`` and ``sizes`` to turn per-class draws into flat
rows.

The on-disk layout is the JAX package's, so a cache either package writes
is read by the other:

  ``<cache_dir>/<dataset>_<set>_<h>x<w>x<c>.u8``    raw (n, h, w, c) uint8
  ``<cache_dir>/<dataset>_<set>_<h>x<w>x<c>.json``  class order/counts + done flag

A build writes pid-suffixed temps and ``os.replace``s them into place, the
data file before the done-flagged meta, and first sweeps the temps that a
dead builder left: a killed or truncated build is rebuilt, never served
half-written, and concurrent builders each land a complete identical file.
A corrupt or truncated meta reads as no cache. Pixels come from
``episodes.load_image_uint8``, the decode every tier shares, so the cache
is bit-identical to the direct path.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import glob
import json
import os
import time
from typing import Dict, List, NamedTuple

import numpy as np

from ..config import MAMLConfig
from .datasets import ClassIndex
from .episodes import load_image_uint8

# temps older than this are swept even if their embedded pid looks alive:
# the pid may be reused by an unrelated process, or belong to another host
# on shared storage. Active builders rewrite their memmap continuously, so
# hours-old mtime means abandoned. Overridable for tests.
_STALE_TEMP_AGE_S = float(os.environ.get("MAML_STALE_TEMP_AGE_S", 6 * 3600))


class FlatStore(NamedTuple):
    """``data`` (N, h, w, c) uint8; ``offsets[key] + j`` is the row of
    class ``key``'s j-th image, ``sizes[key]`` its image count."""

    data: np.ndarray
    offsets: Dict[str, int]
    sizes: Dict[str, int]

    def views(self) -> Dict[str, np.ndarray]:
        """Per-class array views of ``data`` (the pixel path's store)."""
        return {
            key: self.data[off: off + self.sizes[key]]
            for key, off in self.offsets.items()
        }


def _cache_base(cfg: MAMLConfig, cache_dir: str, set_name: str) -> str:
    h, w, c = cfg.im_shape
    return os.path.join(
        cache_dir, f"{cfg.dataset_name}_{set_name}_{h}x{w}x{c}"
    )


def build_set_cache(
    cfg: MAMLConfig, classes: ClassIndex, cache_dir: str, set_name: str,
    workers: int = 8,
) -> Dict[str, np.ndarray]:
    """Build (or reuse) one set's memmap cache; return class -> uint8 view."""
    return build_set_cache_flat(cfg, classes, cache_dir, set_name, workers).views()


def build_set_cache_flat(
    cfg: MAMLConfig, classes: ClassIndex, cache_dir: str, set_name: str,
    workers: int = 8,
) -> FlatStore:
    """Build (or reuse) one set's memmap cache; return its ``FlatStore``.

    Class order and per-class counts are recorded so a cache is only reused
    when it matches the current split exactly.
    """
    base = _cache_base(cfg, cache_dir, set_name)
    data_path, meta_path = base + ".u8", base + ".json"
    h, w, c = cfg.im_shape
    order: List[str] = list(classes.keys())
    counts = [len(classes[k]) for k in order]
    total = sum(counts)

    meta = None
    if os.path.exists(meta_path):
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (json.JSONDecodeError, OSError):
            meta = None  # truncated/corrupt meta == no meta: rebuild
    fresh = not (
        meta
        and meta.get("done")
        and meta.get("classes") == order
        and meta.get("counts") == counts
        and os.path.exists(data_path)
        and os.path.getsize(data_path) == total * h * w * c
    )
    if fresh:
        os.makedirs(cache_dir, exist_ok=True)
        # invalidate any stale meta BEFORE touching the data file: a rebuild
        # killed mid-decode must never be servable under the old meta.
        # A concurrent builder may have removed it first — that's fine.
        with contextlib.suppress(FileNotFoundError):
            os.remove(meta_path)
        # build into pid-suffixed temps and os.replace into place: a killed
        # build leaves only temps (never a half-written live file), and two
        # processes racing on the same cache each land a complete, identical
        # (deterministic decode) file instead of interleaving writes
        # disk hygiene: a SIGKILLed builder leaves its pid-suffixed temps
        # behind forever (finally never ran); sweep stale ones for this cache
        # base before building. A concurrent builder's temp is LIVE, not
        # stale — deleting it would unlink the file under its memmap and
        # crash its os.replace — so only remove temps whose pid is provably
        # dead (ProcessLookupError). EPERM means the pid EXISTS under another
        # uid: treat as alive. Pid liveness is host-local and pids get
        # reused, so additionally remove temps untouched for
        # _STALE_TEMP_AGE_S regardless of pid — covers remote builders on
        # shared storage and pid-reuse leaks; a live builder's memmap writes
        # keep refreshing its temp's mtime long before that threshold.
        now = time.time()  # compared with the files' mtime: wall clock
        for path_base in (data_path, meta_path):
            for stale in glob.glob(f"{path_base}.tmp.*"):
                try:
                    pid = int(stale.rsplit(".", 1)[-1])
                except ValueError:
                    continue  # unrecognized suffix: leave it alone
                dead = False
                try:
                    os.kill(pid, 0)
                except ProcessLookupError:
                    dead = True
                except OSError:  # EPERM et al.: process exists
                    pass
                if not dead:
                    try:
                        age = now - os.path.getmtime(stale)
                    except OSError:
                        continue  # vanished under us: nothing to clean
                    dead = age > _STALE_TEMP_AGE_S
                if dead:
                    with contextlib.suppress(OSError):
                        os.remove(stale)
        data_tmp = f"{data_path}.tmp.{os.getpid()}"
        meta_tmp = f"{meta_path}.tmp.{os.getpid()}"
        try:
            mm = np.memmap(
                data_tmp, mode="w+", dtype=np.uint8, shape=(total, h, w, c)
            )
            jobs = []
            offset = 0
            for key, count in zip(order, counts):
                for j, path in enumerate(classes[key]):
                    jobs.append((offset + j, path))
                offset += count
            last_touch = time.monotonic()
            with concurrent.futures.ThreadPoolExecutor(workers) as pool:
                for idx, arr in pool.map(
                    lambda job: (job[0], load_image_uint8(cfg, job[1])),
                    jobs,
                    chunksize=64,
                ):
                    mm[idx] = arr
                    # memmap stores don't reliably refresh mtime (mmap
                    # writes bypass the file API; NFS especially) — touch
                    # explicitly so the age-based stale sweep above sees a
                    # live build as live
                    if time.monotonic() - last_touch > 60:
                        with contextlib.suppress(OSError):
                            os.utime(data_tmp)
                        last_touch = time.monotonic()
            mm.flush()
            del mm
            ours_landed = True
            try:
                os.replace(data_tmp, data_path)
            except FileNotFoundError:
                # our temp was swept as stale (e.g. this process sat
                # SIGSTOPped past the age threshold while another builder
                # rebuilt the cache). If a right-sized data file is in
                # place, serve it for THIS call only — but do NOT stamp the
                # done meta for a file we didn't write: that would bless a
                # size-matching-but-garbage file forever. The concurrent
                # builder stamps its own meta; absent that, the next call
                # revalidates and rebuilds.
                ours_landed = False
                if not (
                    os.path.exists(data_path)
                    and os.path.getsize(data_path) == total * h * w * c
                ):
                    raise
            if ours_landed:
                with open(meta_tmp, "w") as f:
                    json.dump(
                        {"classes": order, "counts": counts, "done": True}, f
                    )
                os.replace(meta_tmp, meta_path)
        finally:
            for tmp in (data_tmp, meta_tmp):
                with contextlib.suppress(FileNotFoundError):
                    os.remove(tmp)

    mm = np.memmap(data_path, mode="r", dtype=np.uint8, shape=(total, h, w, c))
    offsets: Dict[str, int] = {}
    sizes: Dict[str, int] = {}
    offset = 0
    for key, count in zip(order, counts):
        offsets[key] = offset
        sizes[key] = count
        offset += count
    return FlatStore(data=mm, offsets=offsets, sizes=sizes)


def build_mmap_cache(
    cfg: MAMLConfig,
    splits: Dict[str, ClassIndex],
    cache_dir: str,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Memmap-cache every set of the split (the drop-in alternative to
    ``datasets.preload_to_memory``)."""
    return {
        set_name: store.views()
        for set_name, store in build_mmap_cache_flat(cfg, splits, cache_dir).items()
    }


def build_mmap_cache_flat(
    cfg: MAMLConfig,
    splits: Dict[str, ClassIndex],
    cache_dir: str,
) -> Dict[str, FlatStore]:
    """Memmap-cache every set of the split, keeping the flat form the
    device-resident pipeline needs (set -> ``FlatStore``)."""
    return {
        set_name: build_set_cache_flat(cfg, classes, cache_dir, set_name)
        for set_name, classes in splits.items()
    }
