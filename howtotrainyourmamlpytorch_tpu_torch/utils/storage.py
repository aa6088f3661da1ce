"""Experiment folders, CSV/JSON metrics storage.

The port of the JAX package's ``utils/storage.py``:
``build_experiment_folder`` (:20) creates ``saved_models/ logs/
visual_outputs/``; ``save_statistics`` (:31) appends rows to a summary
CSV and ``load_statistics`` (:47) reads it back; ``save_to_json`` (:69,
atomic) and ``load_from_json`` (:87) hold the JSON metrics dump. The files
are byte for byte the JAX package's, so a run's logs read the same under
either package. The fault-injection seams wait for ``resilience/`` (ROADMAP
Queue A).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, Iterable, List, Tuple


def build_experiment_folder(experiment_name: str) -> Tuple[str, str, str]:
    """Create <name>/{saved_models,logs,visual_outputs}."""
    base = os.path.abspath(experiment_name)
    saved_models = os.path.join(base, "saved_models")
    logs = os.path.join(base, "logs")
    samples = os.path.join(base, "visual_outputs")
    for d in (saved_models, logs, samples):
        os.makedirs(d, exist_ok=True)
    return saved_models, logs, samples


def save_statistics(log_dir: str, line_to_add: Iterable,
                    filename: str = "summary_statistics.csv",
                    create: bool = False) -> str:
    """Append one row (the header row when ``create``) to the stats CSV."""
    summary_filename = os.path.join(log_dir, filename)
    with open(summary_filename, "w" if create else "a") as f:
        csv.writer(f).writerow(list(line_to_add))
    return summary_filename


def load_statistics(log_dir: str, filename: str = "summary_statistics.csv"
                    ) -> Dict[str, List[str]]:
    """Read the stats CSV back into {column: [values]}."""
    path = os.path.join(log_dir, filename)
    with open(path) as f:
        rows = list(csv.reader(f))
    if not rows or not rows[0]:
        raise ValueError(
            f"stats CSV {path} is empty or has no header row — it was "
            "likely truncated by a crash mid-write; delete it (or resume "
            "with continue_from_epoch='from_scratch') to regenerate"
        )
    keys = rows[0]
    data: Dict[str, List[str]] = {k: [] for k in keys}
    for row in rows[1:]:
        for k, v in zip(keys, row):
            data[k].append(v)
    return data


def save_to_json(filename: str, dict_to_store: dict) -> None:
    """Atomic JSON dump: a sibling tmp file, fsync, ``os.replace``, so a
    reader only ever sees the old or the new complete file."""
    path = os.path.abspath(filename)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(dict_to_store, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_from_json(filename: str) -> dict:
    with open(filename) as f:
        return json.load(f)
