"""Wrapper and launch counter of ``episode_expand``, the ingest kernel.

========================  ======  ============================  =============
kernel                    route   source                        launches/call
========================  ======  ============================  =============
``episode_expand``        CUDA    csrc/episode_expand.cu (B6)   1
========================  ======  ============================  =============

Gather of flat-store rows, the decode lookup and a per-(task, class) rot90,
in one launch (see the source for the three modes and the bound). Both
entry points take the plain twin (``ops.device_pipeline.expand_plain`` /
``decode_plain``) for a tensor on the CPU; for a CUDA tensor they launch the
kernel or raise, after checking device, dtype, shape and contiguity, and
add one to the counter per launch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ..ops import device_pipeline as dp
from . import build

Tensor = torch.Tensor

KERNELS = ("episode_expand",)

#: launches per kernel since the last ``reset_launches()`` (CUDA only)
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

#: the kernel keeps the LUT (256 x C floats) in shared memory
MAX_CHANNELS = 32

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = (_P, _L, _P, _P, _P, _P, _P, _L) + (_I,) * 6 + (_P,)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"episode_expand: {what}")


def _check_common(pixels: Tensor, lut: Tensor) -> None:
    _require(pixels.device.type == "cuda",
             f"expected a CUDA tensor, got {pixels.device}")
    _require(pixels.dtype == torch.uint8,
             f"pixels must be uint8, got {pixels.dtype}")
    _require(pixels.is_contiguous(), "pixels must be contiguous")
    c = pixels.shape[-1]
    _require(1 <= c <= MAX_CHANNELS,
             f"{c} channels (at most {MAX_CHANNELS}: the LUT lives in "
             "shared memory)")
    _require(lut.device == pixels.device and lut.dtype == torch.float32
             and tuple(lut.shape) == (256, c) and lut.is_contiguous(),
             f"lut must be a contiguous (256, {c}) float32 tensor on "
             f"{pixels.device}, got {tuple(lut.shape)} {lut.dtype} on "
             f"{lut.device}")


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(src, n_src, rows, rot_k, lut, out_s, out_t, n_images, S, spc,
            reverse: bool) -> None:
    """One launch over ``n_images`` images of ``src`` (``n_src`` rows of
    (h, w, c) uint8)."""
    h, w, c = src.shape[-3:]
    fn = build.function("episode_expand", "episode_expand", _ARGTYPES)
    with torch.cuda.device(src.device):
        rc = fn(src.data_ptr(), n_src, _ptr(rows), _ptr(rot_k),
                lut.data_ptr(), out_s.data_ptr(), _ptr(out_t), n_images, S,
                spc, h, w, c, int(reverse),
                torch.cuda.current_stream(src.device).cuda_stream)
    build.check(rc, "episode_expand")
    LAUNCHES["episode_expand"] += 1


def gather_decode(store: Tensor, rows: Tensor, rot_k: Optional[Tensor],
                  lut: Tensor, spc: int, reverse_channels: bool = False
                  ) -> Tuple[Tensor, Tensor]:
    """Modes (a) and (b): ``store`` (N, h, w, c) uint8, ``rows`` (..., S)
    int32 flat rows, ``rot_k`` (...) int32 or None, ``lut`` (256, c) f32.
    Returns the decoded (and rotated) support ``(..., spc, h, w, c)`` and
    target ``(..., S - spc, h, w, c)`` f32, each contiguous."""
    if store.device.type == "cpu":
        return dp.expand_plain(store, rows, rot_k, lut, spc,
                               reverse_channels)
    _check_common(store, lut)
    _require(store.dim() == 4 and store.shape[0] >= 1,
             f"store must be (N >= 1, h, w, c), got {tuple(store.shape)}")
    _require(rows.device == store.device and rows.dtype == torch.int32
             and rows.dim() >= 1 and rows.is_contiguous(),
             "rows must be a contiguous int32 tensor on the store's device")
    lead, S = tuple(rows.shape[:-1]), rows.shape[-1]
    _require(0 <= spc <= S, f"spc={spc} outside [0, {S}]")
    _, h, w, c = store.shape
    if rot_k is not None:
        _require(rot_k.device == store.device and rot_k.dtype == torch.int32
                 and tuple(rot_k.shape) == lead and rot_k.is_contiguous(),
                 f"rot_k must be a contiguous int32 {lead} tensor on the "
                 "store's device")
        _require(h == w, f"rot90 needs square images, got {h}x{w}")
    x_s = torch.empty(lead + (spc, h, w, c), device=store.device)
    x_t = torch.empty(lead + (S - spc, h, w, c), device=store.device)
    if rows.numel():
        _launch(store, store.shape[0], rows, rot_k, lut, x_s,
                x_t if S > spc else None, rows.numel(), S, spc,
                reverse_channels)
    return x_s, x_t


def decode(pixels: Tensor, lut: Tensor, reverse_channels: bool = False
           ) -> Tensor:
    """Mode (c): uint8 pixels ``(..., h, w, c)`` -> their f32 decode, same
    shape, contiguous."""
    if pixels.device.type == "cpu":
        return dp.decode_plain(pixels, lut, reverse_channels)
    _check_common(pixels, lut)
    _require(pixels.dim() >= 3, f"pixels must be (..., h, w, c), got "
                                f"{tuple(pixels.shape)}")
    out = torch.empty(pixels.shape, device=pixels.device)
    n_images = pixels.numel() // max(1, pixels.shape[-3:].numel())
    if n_images:
        _launch(pixels, n_images, None, None, lut, out, None, n_images, 1, 1,
                reverse_channels)
    return out
