"""Command line of the PyTorch port.

    python -m howtotrainyourmamlpytorch_tpu_torch.cli serve-bench [options]

``serve-bench`` is the only command ported so far (``serving/bench.py``;
``--help`` lists its options). Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import sys
from typing import List, Optional

COMMANDS = ("serve-bench",)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m howtotrainyourmamlpytorch_tpu_torch.cli "
              f"{{{','.join(COMMANDS)}}} [options]", file=sys.stderr)
        return 2
    from .serving import bench

    return bench.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
