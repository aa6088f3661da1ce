"""On-card episode assembly: gather -> decode -> rot90 of uint8 pixels.

The port of the JAX package's ``ops/device_pipeline.py``. The host ships
either raw uint8 pixels (the uint8 ingest, ``data_placement=
'uint8_stream'``: the card decodes) or int32 rows of a uint8 store that
lives on the card (the index ingest, ``data_placement='device'``: the card
gathers, decodes and rotates). Both run on the ``episode_expand`` kernel
(``kernels/episode_expand.py``); this module holds the decode table, the
kernel's plain twins and the expander factories.

Bit-exactness with the host path holds by construction: the decode is a
lookup in a table that the host pipeline itself filled
(``decode_lut``), and rot90 of integer pixels commutes with the
elementwise decode. Not ported yet: ``make_sharded_gather``, the gather
from a store sharded over hosts, which comes with ``parallel/`` (ROADMAP
Queue A).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import MAMLConfig
from ..data.episodes import augment_stack, decode_cached
from ..kernels import episode_expand

Tensor = torch.Tensor
Expanded = Tuple[Tensor, Tensor, Tensor, Tensor]


def decode_lut(cfg: MAMLConfig) -> np.ndarray:
    """(256, c) float32: ``lut[v, ch]`` is the host decode of uint8 value v
    in channel ch, made by running the host pipeline (``decode_cached`` and
    ``augment_stack``'s normalization) over all 256 values. The channel
    flip of ``reverse_channels`` is left out: the expanders apply it to
    the uint8 pixels before the lookup."""
    c = cfg.image_channels
    vals = np.tile(np.arange(256, dtype=np.uint8)[:, None, None, None],
                   (1, 1, 1, c))
    cfg_noflip = cfg.replace(reverse_channels=False)
    out = decode_cached(cfg_noflip, vals)
    out = augment_stack(cfg_noflip, out, k=0, augment=False)
    return np.ascontiguousarray(out.reshape(256, c))


def _lookup(x: Tensor, lut: Tensor, reverse_channels: bool) -> Tensor:
    if reverse_channels:
        x = x.flip(-1)
    chan = torch.arange(lut.shape[1], device=x.device)
    return lut[x.long(), chan]


def clamp_rows(rows: Tensor, n: int) -> Tensor:
    """``jnp``'s ``store[rows]`` row rule on the CPU: a negative row wraps
    once (+ n), then every row is clamped into [0, n)."""
    rows = rows.long()
    return torch.where(rows < 0, rows + n, rows).clamp(0, n - 1)


def expand_plain(store: Tensor, rows: Tensor, rot_k: Optional[Tensor],
                 lut: Tensor, spc: int, reverse_channels: bool = False
                 ) -> Tuple[Tensor, Tensor]:
    """The plain twin of ``episode_expand`` modes (a)/(b): ``store[rows]``
    -> channel flip -> ``lut[x, chan]`` -> ``torch.rot90`` of each
    (task, class) stack by its k (clamped to [0, 3], as ``lax.switch``
    clamps). Returns the contiguous support and target halves."""
    x = _lookup(store[clamp_rows(rows, store.shape[0])], lut,
                reverse_channels)  # (..., S, h, w, c)
    if rot_k is not None:
        lead = x.shape[:-4]
        flat = x.reshape(-1, *x.shape[-4:])
        ks = rot_k.reshape(-1).long().clamp(0, 3)
        flat = torch.stack([torch.rot90(img, int(k), dims=(1, 2))
                            for img, k in zip(flat, ks)])
        x = flat.reshape(*lead, *flat.shape[1:])
    return (x[..., :spc, :, :, :].contiguous(),
            x[..., spc:, :, :, :].contiguous())


def decode_plain(pixels: Tensor, lut: Tensor, reverse_channels: bool = False
                 ) -> Tensor:
    """The plain twin of ``episode_expand`` mode (c)."""
    return _lookup(pixels, lut, reverse_channels).contiguous()


class _Lut:
    """The config's decode table, copied to each device on first use."""

    def __init__(self, cfg: MAMLConfig):
        self.host = torch.from_numpy(decode_lut(cfg))
        self._on: Dict[torch.device, Tensor] = {}

    def on(self, device: torch.device) -> Tensor:
        if device not in self._on:
            self._on[device] = self.host.to(device)
        return self._on[device]


def _slot_labels(lead: Tuple[int, ...], n_way: int, cols: int,
                 device: torch.device) -> Tensor:
    """(*lead, n_way, cols) int32 where sample (i, j) carries label i,
    made on ``device`` (labels never cross H2D)."""
    y = torch.arange(n_way, dtype=torch.int32, device=device)
    return y.view(*([1] * len(lead)), n_way, 1).expand(*lead, n_way, cols)


def make_decoder(cfg: MAMLConfig) -> Callable[[Tensor], Tensor]:
    """uint8 pixels -> the host pipeline's float32 values (no rotation):
    one ``episode_expand`` launch (mode (c)) per call on the card."""
    lut = _Lut(cfg)

    def decode(x: Tensor) -> Tensor:
        return episode_expand.decode(x, lut.on(x.device),
                                     cfg.reverse_channels)

    return decode


def make_serve_expander(cfg: MAMLConfig, shots: int
                        ) -> Callable[[Tensor, Tensor], Expanded]:
    """(store, gather) -> (x_s, y_s, x_t, y_t) for serving's index ingest:
    ``store`` the resident (N, h, w, c) uint8 store, ``gather`` the
    (tenants, n_way, shots + targets) int32 rows of each tenant's support
    then query. No rotation: serving never augments. One launch (mode
    (a))."""
    lut = _Lut(cfg)

    def expand(store: Tensor, gather: Tensor) -> Expanded:
        x_s, x_t = episode_expand.gather_decode(
            store, gather, None, lut.on(store.device), shots,
            cfg.reverse_channels)
        lead, n = tuple(gather.shape[:-2]), gather.shape[-2]
        return (x_s, _slot_labels(lead, n, shots, store.device), x_t,
                _slot_labels(lead, n, gather.shape[-1] - shots,
                             store.device))

    return expand


def make_index_expander(cfg: MAMLConfig, augment: bool, store_mesh=None
                        ) -> Callable[[Tensor, Tensor, Tensor], Expanded]:
    """(store, gather, rot_k) -> (x_s, y_s, x_t, y_t), all on the card:
    ``gather`` (tasks, n_way, spc + nts) int32 rows, ``rot_k`` (tasks,
    n_way) int32 rot90 draws, applied only for train-time Omniglot (the
    ``augment_stack`` rule; rotation needs square images). One launch
    (mode (b) when rotating, else (a))."""
    if store_mesh is not None:
        raise NotImplementedError(
            "a store sharded over hosts (make_sharded_gather) is not ported "
            "yet: it comes with parallel/ (ROADMAP Queue A)"
        )
    rotate = augment and "omniglot" in cfg.dataset_name
    if rotate and cfg.image_height != cfg.image_width:
        raise ValueError(
            "on-device rot90 augmentation requires square images "
            f"(got {cfg.image_height}x{cfg.image_width})"
        )
    spc = cfg.num_samples_per_class
    lut = _Lut(cfg)

    def expand(store: Tensor, gather: Tensor, rot_k: Tensor) -> Expanded:
        x_s, x_t = episode_expand.gather_decode(
            store, gather, rot_k if rotate else None, lut.on(store.device),
            spc, cfg.reverse_channels)
        lead, n = tuple(gather.shape[:-2]), gather.shape[-2]
        return (x_s, _slot_labels(lead, n, spc, store.device), x_t,
                _slot_labels(lead, n, gather.shape[-1] - spc, store.device))

    return expand
