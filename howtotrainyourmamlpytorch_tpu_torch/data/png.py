"""A PNG reader and writer in ``zlib`` and numpy, for the images the
runner's datasets hold.

The JAX package decodes every image with PIL (its ``data/episodes.py::
load_image_uint8``). The port reads the PNGs whose decode PIL would leave
untouched itself, so a dataset of such files needs no PIL: non-interlaced,
filter types 0-4, 8-bit grey, RGB and RGBA and 1-bit grey, no ``tRNS``
chunk. ``decode`` returns None for any other PNG (a palette, 16 bits, grey
with alpha, interlacing, transparency), and the caller hands the file to
PIL. ``encode`` writes the 8-bit forms with filter 0 on every row, which is
what the card's procedural datasets are made with.

Modes follow PIL's names and array forms: ``'1'`` (h, w) of 0/1, ``'L'``
(h, w), ``'RGB'`` (h, w, 3), ``'RGBA'`` (h, w, 4), all uint8.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: (color type, bit depth) -> (mode, channels) of the PNGs decoded here
_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (2, 8): ("RGB", 3),
          (6, 8): ("RGBA", 4)}
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> color type, for encode


class Header(NamedTuple):
    width: int
    height: int
    bit_depth: int
    color_type: int
    interlace: int


def _chunks(data: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """(type, body) of each chunk after the signature, CRCs checked, up to
    and including IEND."""
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {ctype!r}")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"bad CRC in PNG chunk {ctype!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends before its IEND chunk")


def _header(body: bytes) -> Header:
    if len(body) != 13:
        raise ValueError("malformed PNG IHDR chunk")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
    if w == 0 or h == 0:
        raise ValueError("PNG of zero size")
    return Header(w, h, depth, ctype, interlace)


def read_header(path: str) -> Header:
    """The IHDR of a PNG file; raises ValueError if it is not one."""
    with open(path, "rb") as f:
        data = f.read(64)
    if not data.startswith(SIGNATURE) or data[12:16] != b"IHDR":
        raise ValueError(f"{path!r} is not a PNG file")
    return _header(data[16:29])


def _unfilter_row(ftype: int, line: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    """One scanline's bytes with its filter undone (all int64, mod 256)."""
    if ftype == 0:
        return line
    if ftype == 1:  # Sub: a running sum over the pixels, per byte lane
        return np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
    if ftype == 2:  # Up
        return (line + prev) & 255
    if ftype not in (3, 4):
        raise ValueError(f"unknown PNG filter type {ftype}")
    # Average and Paeth depend on the byte just decoded: byte by byte
    cur = [0] * len(line)
    raw, up = line.tolist(), prev.tolist()
    for i, x in enumerate(raw):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            cur[i] = (x + ((a + b) >> 1)) & 255
            continue
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (x + pred) & 255
    return np.asarray(cur, np.int64)


def decode(data: bytes) -> Optional[Tuple[str, np.ndarray]]:
    """``(mode, pixels)`` of a PNG held in ``data``, or None for a PNG of a
    form this reader leaves to PIL. Raises ValueError for bytes that are
    not a well-formed PNG."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = _header(body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"tRNS":
            return None
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    form = _MODES.get((header.color_type, header.bit_depth))
    if form is None or header.interlace != 0:
        return None
    mode, channels = form
    w, h = header.width, header.height
    bits = channels * header.bit_depth
    stride, bpp = (w * bits + 7) // 8, max(1, bits // 8)
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1).astype(np.int64)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        prev = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
        out[y] = prev
    if header.bit_depth == 1:
        return mode, np.unpackbits(out, axis=1)[:, :w]
    pixels = out.reshape(h, w, channels)
    return mode, pixels[:, :, 0] if channels == 1 else pixels


def decode_file(path: str) -> Optional[Tuple[str, np.ndarray]]:
    """``decode`` of a file: None also when the file is not a PNG at all."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        return None
    try:
        return decode(data)
    except (ValueError, zlib.error) as e:
        raise ValueError(f"{path!r}: {e}") from e


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def encode(pixels: np.ndarray) -> bytes:
    """An 8-bit PNG of ``pixels``: (h, w) or (h, w, 1) grey, (h, w, 3) RGB
    or (h, w, 4) RGBA uint8, every row with filter 0."""
    a = np.asarray(pixels)
    if a.dtype != np.uint8:
        raise ValueError(f"encode takes uint8 pixels, got {a.dtype}")
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3 or a.shape[2] not in _COLOR_TYPES:
        raise ValueError(f"encode takes (h, w[, 1|3|4]) pixels, got "
                         f"{a.shape}")
    h, w, c = a.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(a).reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write(path: str, pixels: np.ndarray) -> None:
    """``encode`` into a file."""
    with open(path, "wb") as f:
        f.write(encode(pixels))
