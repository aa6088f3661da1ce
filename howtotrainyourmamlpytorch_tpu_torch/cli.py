"""Command line of the PyTorch port.

    python -m howtotrainyourmamlpytorch_tpu_torch.cli train \\
        [--name_of_args_json_file F] [--<any MAMLConfig field> V ...] \\
        [--device cpu]
    python -m howtotrainyourmamlpytorch_tpu_torch.cli serve-bench [options]
    python -m howtotrainyourmamlpytorch_tpu_torch.cli train-bench [options]

``train`` is the JAX package's training entry point (its ``cli.py``
``get_args`` :127 and ``main`` :171-264 in one process): a JSON config
(reference format) supplies the fields, any ``MAMLConfig`` field given on
the command line overrides it (booleans as ``true``/``false``, lists as
JSON), the dataset is unpacked and checked (``maybe_unzip_dataset``), and
``ExperimentBuilder.run_experiment`` trains, validates, checkpoints,
resumes from ``latest`` and tests the top-5 ensemble under
``experiment_name``. ``serve-bench`` (``serving/bench.py``) drives the
serving engine, ``train-bench`` (``bench.py``) times the meta-training
step; ``--help`` lists each one's options. Every command runs on the card
unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional, Tuple

from .config import MAMLConfig, _coerce_bool

COMMANDS = ("train", "serve-bench", "train-bench")


def get_args(argv=None) -> Tuple[MAMLConfig, Optional[str]]:
    """The config of a ``train`` command line, and its ``--device``."""
    parser = argparse.ArgumentParser(
        prog="train", description="Train MAML++ with the PyTorch port")
    parser.add_argument("--name_of_args_json_file", type=str, default="None")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda:0; 'cpu' runs the "
                             "plain PyTorch ops)")
    for f in dataclasses.fields(MAMLConfig):
        if f.name == "name_of_args_json_file":
            continue
        parser.add_argument(f"--{f.name}", type=str, default=None)
    ns = parser.parse_args(argv)
    overrides = {
        k: v for k, v in vars(ns).items()
        if v is not None and k not in ("name_of_args_json_file", "device")
    }
    # strings to the declared field types: the reference's "true"/"false"
    # booleans, JSON lists
    types = {f.name: f.type for f in dataclasses.fields(MAMLConfig)}
    for k, v in list(overrides.items()):
        t = str(types.get(k, "str"))
        if t == "int" or t.startswith("Optional[int"):
            overrides[k] = int(v)
        elif t == "float":
            overrides[k] = float(v)
        elif t == "bool":
            coerced = _coerce_bool(v)
            if not isinstance(coerced, bool):
                parser.error(f"--{k} expects 'true' or 'false', got {v!r}")
            overrides[k] = coerced
        elif t.startswith("List[") or t.startswith("Tuple["):
            try:
                parsed = json.loads(v)
            except json.JSONDecodeError:
                parsed = None
            if not isinstance(parsed, list):
                parser.error(
                    f"--{k} expects a JSON list (e.g. \"[0.7, 0.2, 0.1]\"), "
                    f"got {v!r}"
                )
            overrides[k] = parsed
    if ns.name_of_args_json_file != "None":
        cfg = MAMLConfig.from_json_file(ns.name_of_args_json_file,
                                        **overrides)
    else:
        cfg = MAMLConfig(**overrides)
    return cfg, ns.device


def train(argv: Optional[List[str]] = None):
    """``train``: returns the test ensemble's ``{test_accuracy_mean,
    test_accuracy_std}``."""
    from .data.loader import MetaLearningDataLoader
    from .experiment.builder import ExperimentBuilder
    from .experiment.system import MAMLFewShotClassifier
    from .utils.dataset_tools import maybe_unzip_dataset

    cfg, device = get_args(argv)
    # fail on the dataset before paying for the model
    maybe_unzip_dataset(cfg)
    model = MAMLFewShotClassifier(cfg, device)
    builder = ExperimentBuilder(cfg, model, MetaLearningDataLoader)
    return builder.run_experiment()


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: python -m howtotrainyourmamlpytorch_tpu_torch.cli "
              f"{{{','.join(COMMANDS)}}} [options]", file=sys.stderr)
        return 2
    if argv[0] == "train":
        train(argv[1:])
        return 0
    if argv[0] == "train-bench":
        from . import bench
    else:
        from .serving import bench
    return bench.main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
