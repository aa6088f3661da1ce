"""ServingEngine: multi-tenant adapt-then-predict over one snapshot.

The port of the JAX package's ``serving/engine.py`` core for the f32
ingest: the tenant bucket ladder (every dispatch is padded up to the
smallest ``serving_bucket_ladder`` entry that holds it), shots buckets
(one per configured support-shot count; shots are never padded), request
validation, zero pad tenants masked out of the metrics by ``valid``,
``serve_group``, ``warmup`` and the latency/throughput ``rollup``.

Pad tenants are all zeros: their conv output is constant, their batch
variance 0, and ``rsqrt(eps)`` keeps them finite. Each tenant's batch
statistics cover its own images only, so per-tenant outputs do not depend
on the bucket.

Not ported yet: the uint8/index ingests, the adapted-params cache and its
predict-only program, AOT export, telemetry sinks and tracing spans.
PyTorch runs eagerly, so there is no program table or retrace detector;
``warmup`` runs every (bucket, shots) shape once so the kernels are built
and the Triton kernels compiled before the first request.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import state as state_lib
from ..config import MAMLConfig
from ..core import maml
from ..device import DeviceLike, resolve_device, synchronize
from ..models import vgg


@dataclass
class TenantResult:
    """One tenant's outcome: ``preds`` (way * targets, classes) softmax in
    class-major query order; ``loss`` / ``accuracy`` None when the request
    shipped no query labels."""

    tenant_id: Optional[str]
    preds: np.ndarray
    loss: Optional[float]
    accuracy: Optional[float]


@dataclass
class DispatchResult:
    """One group's results and latency: ``adapt_ms`` covers the upload,
    the device work and the host fetch of every output; ``metrics`` are
    the masked tenant means over the labeled tenants."""

    results: List[TenantResult]
    tenants: int
    bucket: int
    shots: int
    adapt_ms: float
    metrics: Dict[str, float]


def _bucket_for(n: int, ladder: Sequence[int]) -> int:
    for b in ladder:
        if n <= b:
            return b
    raise ValueError(
        f"{n} tenants exceed the serving bucket ladder {list(ladder)}; "
        "the batcher must cap groups at serving_max_tenants_per_dispatch"
    )


class ServingEngine:
    """Adapt-on-request inference over one servable snapshot.

    :param cfg: the task geometry and the serving knobs.
    :param state: a ``state.MetaState`` of tensors, or a host state with
        numpy leaves (``state.from_numpy`` converts it); the engine keeps a
        private copy on its device.
    :param shots_buckets: support-shot counts to serve (default: the
        config's ``num_samples_per_class``).
    :param device: ``cuda:0`` unless named (``'cpu'`` runs the plain ops).
    :param block: the block implementation handed to ``vgg.apply``;
        default the kernel-dispatching ``conv_bn_act_pool``. A reference
        engine on the card passes ``ops.functional.conv_bn_act_pool``.
    """

    LATENCY_WINDOW = 4096

    def __init__(self, cfg: MAMLConfig, state, shots_buckets:
                 Optional[Sequence[int]] = None, device: DeviceLike = None,
                 block: Optional[vgg.BlockFn] = None):
        self.device = resolve_device(device)
        vgg.check_supported(cfg)
        if cfg.serving_ingest != "f32":
            raise NotImplementedError(
                f"serving_ingest={cfg.serving_ingest!r}: only 'f32' is ported"
            )
        self.cfg = cfg
        self.buckets: Tuple[int, ...] = tuple(cfg.serving_bucket_ladder)
        self.max_tenants: int = cfg.serving_max_tenants_per_dispatch
        self.shots_buckets: Tuple[int, ...] = tuple(
            shots_buckets if shots_buckets is not None
            else (cfg.num_samples_per_class,)
        )
        if any(s < 1 for s in self.shots_buckets):
            raise ValueError(
                f"shots buckets must be >= 1, got {self.shots_buckets}"
            )
        if isinstance(state, state_lib.MetaState) and all(
            isinstance(v, torch.Tensor)
            for part in (state.net, state.lslr, state.bn)
            for v in part.values()
        ):
            self._state = state_lib.to_device(state, self.device)
        else:
            self._state = state_lib.from_numpy(state, self.device)
        self._step = maml.make_serve_step(cfg, block=block)
        self.warmup_stats: Dict[str, Any] = {}
        self._adapt_ms: Deque[float] = deque(maxlen=self.LATENCY_WINDOW)
        self._tenants_served = 0
        self._span_start: Optional[float] = None
        self._span_end: Optional[float] = None

    # -- shapes ------------------------------------------------------------

    def _zeros_batch(self, bucket: int, shots: int):
        n = self.cfg.num_classes_per_set
        t = self.cfg.num_target_samples
        h, w, c = self.cfg.im_shape
        return (
            np.zeros((bucket, n, shots, h, w, c), np.float32),
            np.zeros((bucket, n, shots), np.int64),
            np.zeros((bucket, n, t, h, w, c), np.float32),
            np.zeros((bucket, n, t), np.int64),
        )

    def _validate(self, req) -> int:
        """Check one request against the engine geometry; returns its
        shots count."""
        n = self.cfg.num_classes_per_set
        t = self.cfg.num_target_samples
        h, w, c = self.cfg.im_shape
        sx = np.asarray(req.support_x)
        if sx.ndim != 5 or sx.shape[0] != n or sx.shape[2:] != (h, w, c):
            raise ValueError(
                f"support_x must be ({n}, shots, {h}, {w}, {c}), got "
                f"{sx.shape}"
            )
        shots = int(sx.shape[1])
        if shots not in self.shots_buckets:
            raise ValueError(
                f"request shots={shots} not in the engine's shots buckets "
                f"{self.shots_buckets} (shots are never padded — they "
                "enter the adaptation loss)"
            )
        if tuple(np.asarray(req.support_y).shape) != (n, shots):
            raise ValueError(
                f"support_y must be ({n}, {shots}), got "
                f"{np.asarray(req.support_y).shape}"
            )
        qx = np.asarray(req.query_x)
        if qx.shape != (n, t, h, w, c):
            raise ValueError(
                f"query_x must be ({n}, {t}, {h}, {w}, {c}), got {qx.shape}"
            )
        if req.query_y is not None and tuple(
                np.asarray(req.query_y).shape) != (n, t):
            raise ValueError(
                f"query_y must be ({n}, {t}) or None, got "
                f"{np.asarray(req.query_y).shape}"
            )
        return shots

    def _adapt_args(self, requests, bucket: int, shots: int):
        """One dispatch's host batch: real tenants first, zero pad tenants
        after; ``valid`` admits LABELED tenants only."""
        valid = np.zeros(bucket, np.float32)
        x_s, y_s, x_t, y_t = self._zeros_batch(bucket, shots)
        for i, req in enumerate(requests):
            x_s[i] = np.asarray(req.support_x, np.float32)
            y_s[i] = np.asarray(req.support_y, np.int64)
            x_t[i] = np.asarray(req.query_x, np.float32)
            if req.query_y is not None:
                y_t[i] = np.asarray(req.query_y, np.int64)
                valid[i] = 1.0
        return x_s, y_s, x_t, y_t, valid

    # -- dispatch ----------------------------------------------------------

    def _raw_dispatch(self, host_args):
        """Upload, run the serve step, and fetch every output to the host
        (the fetch waits for the device). Returns ``(out, adapt_ms)``."""
        start = time.perf_counter()
        args = [torch.from_numpy(a).to(self.device) for a in host_args]
        _, out = self._step(self._state, *args)
        fetched = {
            "preds": out["preds"].cpu().numpy(),
            "loss": out["loss"].cpu().numpy(),
            "accuracy": out["accuracy"].cpu().numpy(),
            "metrics": {k: float(v) for k, v in out["metrics"].items()},
        }
        return fetched, (time.perf_counter() - start) * 1e3

    def warmup(self) -> float:
        """Run every (bucket, shots) shape once on zeros: builds the CUDA
        kernels and compiles the Triton kernels before real traffic.
        Returns the wall seconds spent."""
        start = time.perf_counter()
        for shots in self.shots_buckets:
            for bucket in self.buckets:
                x_s, y_s, x_t, y_t = self._zeros_batch(bucket, shots)
                self._raw_dispatch(
                    (x_s, y_s, x_t, y_t, np.zeros(bucket, np.float32))
                )
        synchronize(self.device)
        seconds = time.perf_counter() - start
        self.warmup_stats = {
            "seconds": round(seconds, 3),
            "dispatches": len(self.buckets) * len(self.shots_buckets),
        }
        return seconds

    def serve_group(self, requests: Sequence[Any]) -> DispatchResult:
        """Serve one group of same-shots requests in one dispatch, padded
        up to its bucket."""
        if not requests:
            raise ValueError("serve_group needs at least one request")
        if len(requests) > self.max_tenants:
            raise ValueError(
                f"{len(requests)} requests exceed "
                f"serving_max_tenants_per_dispatch={self.max_tenants}"
            )
        shots_set = {self._validate(r) for r in requests}
        if len(shots_set) != 1:
            raise ValueError(
                f"one dispatch must carry one shots bucket, got {shots_set}"
            )
        shots = shots_set.pop()
        if self._span_start is None:
            self._span_start = time.perf_counter()
        bucket = _bucket_for(len(requests), self.buckets)
        out, adapt_ms = self._raw_dispatch(
            self._adapt_args(requests, bucket, shots))
        results = []
        for j, req in enumerate(requests):
            labeled = req.query_y is not None
            results.append(TenantResult(
                tenant_id=req.tenant_id,
                preds=out["preds"][j],
                loss=float(out["loss"][j]) if labeled else None,
                accuracy=float(out["accuracy"][j]) if labeled else None,
            ))
        self._adapt_ms.append(adapt_ms)
        self._tenants_served += len(requests)
        self._span_end = time.perf_counter()
        return DispatchResult(
            results=results, tenants=len(requests), bucket=bucket,
            shots=shots, adapt_ms=adapt_ms, metrics=out["metrics"],
        )

    def rollup(self) -> Dict[str, Any]:
        """Dispatches, tenants, adapt_ms p50/p95 over the last
        ``LATENCY_WINDOW`` dispatches, and ``tenants_per_sec``: tenants
        over the wall-clock span from the first dispatch's start to the
        last one's end (warmup excluded)."""
        adapt = np.asarray(self._adapt_ms, np.float64)
        span_s = (
            self._span_end - self._span_start
            if self._span_start is not None and self._span_end is not None
            else 0.0
        )
        return {
            "dispatches": int(adapt.size),
            "tenants": int(self._tenants_served),
            "adapt_ms_p50": (float(np.percentile(adapt, 50))
                             if adapt.size else None),
            "adapt_ms_p95": (float(np.percentile(adapt, 95))
                             if adapt.size else None),
            "tenants_per_sec": (self._tenants_served / span_s
                                if span_s > 0 else None),
        }
