"""Request types and the synchronous grouping front end of the serving
engine: the port of the JAX package's ``serving/batcher.py``
(``AdaptRequest``, ``IndexRequest``, ``group_requests``,
``serve_requests``). The online ``MicroBatcher`` thread is not ported yet.

Shots are a bucket KEY, never a padding axis: requests with different
support-shot counts go to different dispatches (pad support samples would
enter the adaptation loss). Tenant count is padded up to the bucket ladder
with masked zeros.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


@dataclass
class AdaptRequest:
    """One tenant's adapt-then-predict request, NHWC pixels (float32, or
    uint8 for an engine with ``ingest='uint8'``): ``support_x`` (way,
    shots, h, w, c), ``support_y`` (way, shots), ``query_x`` (way, targets,
    h, w, c), optionally ``query_y`` (way, targets) when the caller wants
    query loss/accuracy back."""

    support_x: np.ndarray
    support_y: np.ndarray
    query_x: np.ndarray
    query_y: Optional[np.ndarray] = None
    tenant_id: Optional[str] = None

    @property
    def shots(self) -> int:
        return int(np.asarray(self.support_x).shape[1])


@dataclass
class IndexRequest:
    """One tenant's request as rows of the engine's registered store
    (``ingest='index'``): ``support_idx`` (way, shots) and ``query_idx``
    (way, targets) integer rows, a few hundred bytes. Labels never cross
    H2D: sample (i, j) carries label i (rows grouped by class slot).
    ``labeled=False`` marks a tenant whose query grouping is not truthful:
    its predictions are served, its loss and accuracy masked out."""

    support_idx: np.ndarray
    query_idx: np.ndarray
    labeled: bool = True
    tenant_id: Optional[str] = None

    @property
    def shots(self) -> int:
        return int(np.asarray(self.support_idx).shape[1])


def group_requests(requests: Sequence[Any],
                   max_tenants: int) -> List[List[int]]:
    """Stable-partition request INDICES by shots, then chunk each
    partition at ``max_tenants``; order is preserved within a bucket."""
    if max_tenants < 1:
        raise ValueError(f"max_tenants must be >= 1, got {max_tenants}")
    by_shots: Dict[int, List[int]] = {}
    for i, req in enumerate(requests):
        by_shots.setdefault(req.shots, []).append(i)
    groups: List[List[int]] = []
    for shots in sorted(by_shots):
        idxs = by_shots[shots]
        for at in range(0, len(idxs), max_tenants):
            groups.append(idxs[at:at + max_tenants])
    return groups


def serve_requests(engine, requests: Sequence[Any],
                   max_tenants: Optional[int] = None):
    """Serve a request list synchronously; returns ``(results,
    dispatches)``: ``results[i]`` is request i's ``TenantResult``,
    ``dispatches`` the per-dispatch ``DispatchResult`` list."""
    cap = engine.max_tenants if max_tenants is None else min(
        int(max_tenants), engine.max_tenants
    )
    results: List[Any] = [None] * len(requests)
    dispatches = []
    for idxs in group_requests(requests, cap):
        dr = engine.serve_group([requests[i] for i in idxs])
        dispatches.append(dr)
        for i, res in zip(idxs, dr.results):
            results[i] = res
    return results, dispatches
