"""Command line of the PyTorch port.

    python -m howtotrainyourmamlpytorch_tpu_torch.cli serve-bench [options]
    python -m howtotrainyourmamlpytorch_tpu_torch.cli train-bench [options]

``serve-bench`` (``serving/bench.py``) drives the serving engine,
``train-bench`` (``bench.py``) times the meta-training step; ``--help``
lists each one's options. Both run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import sys
from typing import List, Optional

COMMANDS = ("serve-bench", "train-bench")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m howtotrainyourmamlpytorch_tpu_torch.cli "
              f"{{{','.join(COMMANDS)}}} [options]", file=sys.stderr)
        return 2
    if argv[0] == "train-bench":
        from . import bench
    else:
        from .serving import bench
    return bench.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
