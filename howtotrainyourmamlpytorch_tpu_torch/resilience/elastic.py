"""The topology-invariant episode schedule: the two pure functions of the
JAX package's ``resilience/elastic.py`` that the loader and the runner
call. Episode seeds are a function of (base seed, global episode index),
so what a checkpoint must carry is the global cursor, and what a process
builds is its contiguous block of each global batch. The coordinated drain
of that module comes with ``parallel/`` (ROADMAP Queue A).
"""

from __future__ import annotations

from typing import Tuple


def episode_cursor_for_iter(current_iter: int, tasks_per_batch: int) -> int:
    """The global episode cursor after ``current_iter`` completed
    iterations: the index of the next unconsumed episode."""
    return int(current_iter) * int(tasks_per_batch)


def shard_slice(tasks_per_batch: int, shard_id: int, num_shards: int
                ) -> Tuple[int, int]:
    """Process ``shard_id``'s contiguous block ``[lo, hi)`` of each global
    batch's task indices; ``num_shards`` must divide ``tasks_per_batch``."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if not 0 <= shard_id < num_shards:
        raise ValueError(
            f"shard_id {shard_id} out of range for {num_shards} shards"
        )
    if tasks_per_batch % num_shards != 0:
        raise ValueError(
            f"global batch of {tasks_per_batch} tasks not divisible by "
            f"{num_shards} processes, so it cannot re-partition; elastic "
            "resume requires every anticipated process count to divide the "
            "global batch"
        )
    per = tasks_per_batch // num_shards
    return shard_id * per, (shard_id + 1) * per
