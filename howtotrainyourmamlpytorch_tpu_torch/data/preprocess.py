"""The flat uint8 store: one set's images as a single (N, h, w, c) array.

The port of ``FlatStore`` from the JAX package's ``data/preprocess.py``.
The device tier uploads ``data`` to the card once; episode sampling then
needs only ``offsets`` and ``sizes`` to turn per-class draws into flat
rows. Building the memory-mapped cache from image files is not ported yet
(ROADMAP Queue A7).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np


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
