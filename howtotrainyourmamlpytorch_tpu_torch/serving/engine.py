"""ServingEngine: multi-tenant adapt-then-predict over one snapshot.

The port of the JAX package's ``serving/engine.py`` core: the three
ingests, the tenant bucket ladder (every dispatch is padded up to the
smallest ``serving_bucket_ladder`` entry that holds it), shots buckets
(one per configured support-shot count; shots are never padded), request
validation, zero pad tenants masked out of the metrics by ``valid``,
``serve_group``, ``warmup`` and the latency/throughput ``rollup``.

Pad tenants are all zeros: their conv output is constant, their batch
variance 0, and ``rsqrt(eps)`` keeps them finite. Each tenant's batch
statistics cover its own images only, so per-tenant outputs do not depend
on the bucket.

Ingests (``ingest`` or ``cfg.serving_ingest``), each with the f32 path's
numbers on the same pixels:

* ``'f32'``: ``AdaptRequest`` float32 pixels, uploaded per dispatch;
* ``'uint8'``: ``AdaptRequest`` raw uint8 pixels, a quarter of the bytes,
  decoded on the card (``episode_expand``, one launch each for the
  support and the query batch);
* ``'index'``: ``IndexRequest`` rows of a registered uint8 store that goes
  to the card once at construction; a dispatch uploads only the int32
  gather and the mask, and one ``episode_expand`` launch gathers and
  decodes. Rows are checked against the store on the host.

Every ``DispatchResult`` carries the bytes its upload moved
(``ingest_bytes``); ``rollup`` reports their mean
(``h2d_bytes_per_dispatch``). Not ported yet: the adapted-params cache and
its predict-only program, AOT export, telemetry sinks and tracing spans.
PyTorch runs eagerly, so there is no program table or retrace detector;
``warmup`` runs every (bucket, shots) shape once so the kernels are built
and loaded before the first request.
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
    ingest_bytes: int = 0  # the host arrays this dispatch uploaded


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
    :param block: the block implementation handed to ``vgg.apply``, of
        the config's block order; default the kernel-dispatching block of
        ``vgg.blocks_for(cfg)``. A reference engine on the card passes the
        plain one, ``vgg.blocks_for(cfg)[1]``.
    :param ingest: ``'f32'``, ``'uint8'`` or ``'index'`` (default
        ``cfg.serving_ingest``).
    :param store: for ``ingest='index'`` only, and required there: a
        ``data.preprocess.FlatStore`` or an (N, h, w, c) uint8 array whose
        rows the requests name; uploaded once.
    """

    LATENCY_WINDOW = 4096

    def __init__(self, cfg: MAMLConfig, state, shots_buckets:
                 Optional[Sequence[int]] = None, device: DeviceLike = None,
                 block: Optional[vgg.BlockFn] = None,
                 ingest: Optional[str] = None, store=None):
        self.device = resolve_device(device)
        vgg.check_supported(cfg)
        self.ingest: str = cfg.serving_ingest if ingest is None else ingest
        if self.ingest not in ("f32", "uint8", "index"):
            raise ValueError(
                f"ingest must be 'f32', 'uint8' or 'index', got "
                f"{self.ingest!r}"
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
        self._store: Optional[torch.Tensor] = None
        self._store_rows = 0
        if self.ingest == "index":
            if store is None:
                raise ValueError(
                    "ingest='index' requires a registered store (a "
                    "data.preprocess.FlatStore or a (N, h, w, c) uint8 "
                    "array): index requests reference its rows"
                )
            data = np.asarray(getattr(store, "data", store))
            if data.dtype != np.uint8 or data.ndim != 4 \
                    or data.shape[1:] != cfg.im_shape or not len(data):
                raise ValueError(
                    f"registered store must be (N, {cfg.im_shape[0]}, "
                    f"{cfg.im_shape[1]}, {cfg.im_shape[2]}) uint8, got "
                    f"{data.shape} {data.dtype}"
                )
            self._store_rows = int(data.shape[0])
            self._store = torch.from_numpy(
                np.ascontiguousarray(data)).to(self.device)
            self._steps = {
                s: maml.make_serve_step_indexed(cfg, s, block=block)
                for s in self.shots_buckets
            }
        elif store is not None:
            raise ValueError(
                f"a registered store only applies to ingest='index' "
                f"(this engine is ingest={self.ingest!r})"
            )
        else:
            step = maml.make_serve_step(cfg, self.ingest, block=block)
            self._steps = {s: step for s in self.shots_buckets}
        self.warmup_stats: Dict[str, Any] = {}
        self._adapt_ms: Deque[float] = deque(maxlen=self.LATENCY_WINDOW)
        self._h2d_bytes: Deque[int] = deque(maxlen=self.LATENCY_WINDOW)
        self._tenants_served = 0
        self._span_start: Optional[float] = None
        self._span_end: Optional[float] = None

    # -- shapes ------------------------------------------------------------

    @property
    def _pixel_dtype(self):
        return np.uint8 if self.ingest == "uint8" else np.float32

    def _zeros_batch(self, bucket: int, shots: int):
        """A dispatch's host arrays, all zeros: ``(gather, valid)`` for the
        index ingest, else ``(x_s, y_s, x_t, y_t, valid)`` (int32 labels,
        as the JAX engine ships them)."""
        n = self.cfg.num_classes_per_set
        t = self.cfg.num_target_samples
        valid = np.zeros(bucket, np.float32)
        if self.ingest == "index":
            return np.zeros((bucket, n, shots + t), np.int32), valid
        h, w, c = self.cfg.im_shape
        return (
            np.zeros((bucket, n, shots, h, w, c), self._pixel_dtype),
            np.zeros((bucket, n, shots), np.int32),
            np.zeros((bucket, n, t, h, w, c), self._pixel_dtype),
            np.zeros((bucket, n, t), np.int32),
            valid,
        )

    def _check_shots(self, shots: int) -> None:
        if shots not in self.shots_buckets:
            raise ValueError(
                f"request shots={shots} not in the engine's shots buckets "
                f"{self.shots_buckets} (shots are never padded — they "
                "enter the adaptation loss)"
            )

    def _validate_index(self, req, n: int, t: int) -> int:
        si = np.asarray(getattr(req, "support_idx", None))
        qi = np.asarray(getattr(req, "query_idx", None))
        if si.dtype == object or si.ndim != 2 or si.shape[0] != n:
            raise ValueError(
                f"ingest='index' requires IndexRequest support_idx of "
                f"shape ({n}, shots), got {getattr(req, 'support_idx', None)!r}"
            )
        shots = int(si.shape[1])
        self._check_shots(shots)
        if qi.dtype == object or qi.shape != (n, t):
            raise ValueError(
                f"query_idx must be ({n}, {t}), got "
                f"{getattr(req, 'query_idx', None)!r}"
            )
        for name, arr in (("support_idx", si), ("query_idx", qi)):
            if not np.issubdtype(arr.dtype, np.integer):
                raise ValueError(f"{name} must be integer store rows")
            if arr.size and (
                int(arr.min()) < 0 or int(arr.max()) >= self._store_rows
            ):
                raise ValueError(
                    f"{name} rows out of range [0, {self._store_rows}) "
                    f"for the registered store"
                )
        return shots

    def _validate(self, req) -> int:
        """Check one request against the engine geometry and ingest;
        returns its shots count."""
        n = self.cfg.num_classes_per_set
        t = self.cfg.num_target_samples
        if self.ingest == "index":
            return self._validate_index(req, n, t)
        h, w, c = self.cfg.im_shape
        sx = np.asarray(req.support_x)
        if sx.ndim != 5 or sx.shape[0] != n or sx.shape[2:] != (h, w, c):
            raise ValueError(
                f"support_x must be ({n}, shots, {h}, {w}, {c}), got "
                f"{sx.shape}"
            )
        qx = np.asarray(req.query_x)
        if self.ingest == "uint8" and not (
                sx.dtype == np.uint8 and qx.dtype == np.uint8):
            # a silent float -> uint8 cast would corrupt pixels
            raise ValueError(
                f"ingest='uint8' requires uint8 support_x/query_x, got "
                f"{sx.dtype}/{qx.dtype}"
            )
        shots = int(sx.shape[1])
        self._check_shots(shots)
        if tuple(np.asarray(req.support_y).shape) != (n, shots):
            raise ValueError(
                f"support_y must be ({n}, {shots}), got "
                f"{np.asarray(req.support_y).shape}"
            )
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

    def _labeled_of(self, req) -> bool:
        if self.ingest == "index":
            return bool(req.labeled)
        return req.query_y is not None

    def _adapt_args(self, requests, bucket: int, shots: int):
        """One dispatch's host arrays (``_zeros_batch``'s layout): real
        tenants first, pad tenants after (zero pixels, or row 0 of the
        store); ``valid`` admits LABELED tenants only."""
        args = self._zeros_batch(bucket, shots)
        valid = args[-1]
        if self.ingest == "index":
            gather = args[0]
            for i, req in enumerate(requests):
                gather[i, :, :shots] = np.asarray(req.support_idx, np.int32)
                gather[i, :, shots:] = np.asarray(req.query_idx, np.int32)
        else:
            x_s, y_s, x_t, y_t, _ = args
            for i, req in enumerate(requests):
                x_s[i] = np.asarray(req.support_x, self._pixel_dtype)
                y_s[i] = np.asarray(req.support_y, np.int32)
                x_t[i] = np.asarray(req.query_x, self._pixel_dtype)
                if req.query_y is not None:
                    y_t[i] = np.asarray(req.query_y, np.int32)
        for i, req in enumerate(requests):
            if self._labeled_of(req):
                valid[i] = 1.0
        return args

    # -- dispatch ----------------------------------------------------------

    def _raw_dispatch(self, host_args, shots: int):
        """Upload the host arrays, run the serve step, and fetch every
        output to the host (the fetch waits for the device). Returns
        ``(out, adapt_ms)``."""
        start = time.perf_counter()
        args = [torch.from_numpy(a).to(self.device) for a in host_args]
        if self._store is not None:
            args.insert(0, self._store)
        _, out = self._steps[shots](self._state, *args)
        fetched = {
            "preds": out["preds"].cpu().numpy(),
            "loss": out["loss"].cpu().numpy(),
            "accuracy": out["accuracy"].cpu().numpy(),
            "metrics": {k: float(v) for k, v in out["metrics"].items()},
        }
        return fetched, (time.perf_counter() - start) * 1e3

    def warmup(self) -> float:
        """Run every (bucket, shots) shape once on zeros: builds and loads
        the CUDA kernels before real traffic.
        Returns the wall seconds spent."""
        start = time.perf_counter()
        for shots in self.shots_buckets:
            for bucket in self.buckets:
                self._raw_dispatch(self._zeros_batch(bucket, shots), shots)
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
        host_args = self._adapt_args(requests, bucket, shots)
        h2d = sum(int(a.nbytes) for a in host_args)
        out, adapt_ms = self._raw_dispatch(host_args, shots)
        results = []
        for j, req in enumerate(requests):
            labeled = self._labeled_of(req)
            results.append(TenantResult(
                tenant_id=req.tenant_id,
                preds=out["preds"][j],
                loss=float(out["loss"][j]) if labeled else None,
                accuracy=float(out["accuracy"][j]) if labeled else None,
            ))
        self._adapt_ms.append(adapt_ms)
        self._h2d_bytes.append(h2d)
        self._tenants_served += len(requests)
        self._span_end = time.perf_counter()
        return DispatchResult(
            results=results, tenants=len(requests), bucket=bucket,
            shots=shots, adapt_ms=adapt_ms, metrics=out["metrics"],
            ingest_bytes=h2d,
        )

    def rollup(self) -> Dict[str, Any]:
        """Dispatches, tenants, the ``ingest``, adapt_ms p50/p95 and
        ``h2d_bytes_per_dispatch`` (the mean upload, rounded to 0.1 B as the
        JAX engine rounds it) over the last ``LATENCY_WINDOW`` dispatches,
        and ``tenants_per_sec``: tenants over the wall-clock span from the
        first dispatch's start to the last one's end (warmup excluded)."""
        adapt = np.asarray(self._adapt_ms, np.float64)
        h2d = np.asarray(self._h2d_bytes, np.float64)
        span_s = (
            self._span_end - self._span_start
            if self._span_start is not None and self._span_end is not None
            else 0.0
        )
        return {
            "dispatches": int(adapt.size),
            "tenants": int(self._tenants_served),
            "ingest": self.ingest,
            "adapt_ms_p50": (float(np.percentile(adapt, 50))
                             if adapt.size else None),
            "adapt_ms_p95": (float(np.percentile(adapt, 95))
                             if adapt.size else None),
            "tenants_per_sec": (self._tenants_served / span_s
                                if span_s > 0 else None),
            "h2d_bytes_per_dispatch": (round(float(np.mean(h2d)), 1)
                                       if h2d.size else None),
        }
