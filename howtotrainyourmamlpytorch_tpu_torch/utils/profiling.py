"""The runner's step timer: the port of ``StepTimer`` from the JAX
package's ``utils/profiling.py`` (:332), host-side wall-clock statistics
per training dispatch, surfaced as the ``train_step_time_*_ms`` and
``train_iters_per_sec`` columns of the epoch summary. The scheduled and
on-demand profilers of that module wait for ROADMAP Queue A (telemetry,
profiling, health).
"""

from __future__ import annotations

import random
import time
from typing import Dict, Optional


class StepTimer:
    """Rolling per-step wall-time statistics (host-side, negligible cost).

    Keeps a bounded reservoir of per-step durations for percentiles: the
    first ``RESERVOIR`` steps of an epoch are stored exactly (epochs are
    100-500 iterations, so in practice every step), later ones replace a
    random slot — p50/p95/p99 stay representative at any epoch length.
    """

    RESERVOIR = 4096

    def __init__(self) -> None:
        self._last: Optional[float] = None
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0
        self._samples: list = []
        self._rng = random.Random(0)

    def tick(self) -> None:
        """Call once per completed step."""
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.count += 1
            self.total += dt
            self.min = min(self.min, dt)
            self.max = max(self.max, dt)
            if len(self._samples) < self.RESERVOIR:
                self._samples.append(dt)
            else:  # reservoir sampling: replace slot j only if j lands in it
                j = self._rng.randrange(self.count)
                if j < self.RESERVOIR:
                    self._samples[j] = dt
        self._last = now

    def reset(self) -> None:
        self.__init__()

    def _percentile(self, sorted_samples, q: float) -> float:
        idx = min(
            len(sorted_samples) - 1, int(round(q * (len(sorted_samples) - 1)))
        )
        return sorted_samples[idx]

    def summary(self, prefix: str = "train") -> Dict[str, float]:
        if self.count == 0:
            return {}
        mean = self.total / self.count
        out = {
            f"{prefix}_step_time_ms": mean * 1e3,
            f"{prefix}_step_time_min_ms": self.min * 1e3,
            f"{prefix}_step_time_max_ms": self.max * 1e3,
            f"{prefix}_iters_per_sec": 1.0 / mean if mean > 0 else 0.0,
        }
        if self._samples:
            s = sorted(self._samples)
            for q, name in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                out[f"{prefix}_step_time_{name}_ms"] = (
                    self._percentile(s, q) * 1e3
                )
        return out
