"""Hand-written Hopper kernels of the port and their wrappers.

CUDA C++ sources live in ``csrc/`` and are built at first use by
``build.py``; the wrappers, launch counters and the
``autograd.Function``s of the blocks live in ``conv_block.py``, those of
the ingest kernel in ``episode_expand.py``.
Importing this package imports no compiler and needs no card.
"""

from typing import Dict


def launches() -> Dict[str, int]:
    """Every kernel's launch count since its last reset."""
    from . import conv_block, episode_expand

    return {**conv_block.launches(), **episode_expand.launches()}


def reset_launches() -> None:
    from . import conv_block, episode_expand

    conv_block.reset_launches()
    episode_expand.reset_launches()
