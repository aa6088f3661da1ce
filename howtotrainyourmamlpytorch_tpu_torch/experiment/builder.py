"""The experiment runner: the epoch loop of one process.

The port of the JAX package's ``experiment/builder.py::ExperimentBuilder``
(:67) on one process: an iteration-counted train loop with

* chunked dispatch (``steps_per_dispatch``), flushed at every epoch
  boundary, since the LR, the MSL weights and the order are functions of
  the epoch (``_train_loop`` :1579);
* validation every ``total_iter_per_epoch`` iterations over
  ``num_evaluation_tasks`` fixed tasks, in ``eval_batches_per_dispatch``
  chunks, with the train summary read while the last eval chunk runs
  (``run_validation_epoch`` :1323);
* best-val tracking, the epoch's CSV row and JSON dump written before its
  checkpoint (``pack_and_save_metrics`` :1405; the order :1649-1657
  explains), and per-epoch plus ``latest`` checkpoints, pruned to the
  ``max_models_to_save`` best (``_prune_saved_models`` :1744);
* resume from ``latest`` (default), ``from_scratch`` or an epoch index,
  the episode stream continued at the checkpointed cursor and the CSV cut
  back to the checkpoint (``_truncate_stats_to_resume_point`` :549);
* a pause after ``total_epochs_before_pause`` epochs of this run;
* the final test: the top-5 validation epochs' checkpoints, their softmax
  predictions averaged over the test stream, -> ``test_summary.csv``
  (``evaluated_test_set_using_the_best_models`` :1834, ``_ensemble_predict``
  :1889).

Left out, each with its ROADMAP Queue A item, and refused rather than
skipped where a config asks for it (``_refuse_unported``): signals, the
preemption drain with its ``emergency`` checkpoint and the in-epoch
history that checkpoint carries (``_pick_latest_resume_point`` :467,
``_serialize_total_losses`` :519), retries and fault injection
(``parallel/`` and ``resilience/``); telemetry, tracing, the watchdog, the health probes and
the profilers (telemetry, profiling, health); the analysis and retrace
audit (``analysis/``). The interactive progress bars are not ported: the
run prints the per-epoch summary lines the JAX package prints in a batch
log.
"""

from __future__ import annotations

import csv
import os
import re
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import MAMLConfig
from ..resilience import elastic
from ..utils.profiling import StepTimer
from ..utils.storage import (
    build_experiment_folder,
    save_statistics,
    save_to_json,
)
from .checkpoint import (
    checkpoint_exists,
    remove_checkpoint,
    wait_for_pending,
)
from .system import MAMLFewShotClassifier

#: (field, its value that asks for nothing, the ROADMAP item it waits for)
UNPORTED = (
    ("tracing_level", "off", "Queue A 6 (telemetry, profiling, health)"),
    ("telemetry_level", "off", "Queue A 6 (telemetry, profiling, health)"),
    ("health_level", "off", "Queue A 6 (telemetry, profiling, health)"),
    ("watchdog_timeout_s", 0.0, "Queue A 6 (telemetry, profiling, health)"),
    ("profile_trace_dir", "", "Queue A 6 (telemetry, profiling, health)"),
    ("fault_spec", "", "Queue A 5 (parallel/ + resilience/)"),
    ("analysis_level", "off", "Queue A 7 (analysis/)"),
)


def _refuse_unported(cfg: MAMLConfig) -> None:
    for field, off, item in UNPORTED:
        if getattr(cfg, field) != off:
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r}: the port's runner does "
                f"not have this yet (ROADMAP {item}); set {field}={off!r}")


def _host(v) -> np.ndarray:
    """A metric entry on the host: a tensor (on the card) copied, a list
    of entries (a chunk's, per iteration) concatenated."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, (list, tuple)):
        return np.concatenate([np.atleast_1d(_host(x)) for x in v])
    return np.asarray(v)


class ExperimentBuilder:
    def __init__(self, cfg: MAMLConfig, model: MAMLFewShotClassifier,
                 data_loader_cls, verbose: bool = True):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.model = model
        self.verbose = verbose
        (self.saved_models_filepath, self.logs_filepath,
         self.samples_filepath) = build_experiment_folder(
            cfg.experiment_name)
        self.total_losses: Dict[str, List[Any]] = {}
        self.state: Dict = {"best_val_acc": 0.0, "best_val_iter": 0,
                            "current_iter": 0}
        self.start_epoch = 0
        self.create_summary_csv = False
        # the summary CSV's column order: set when its header is written,
        # or read back from the file on resume
        self._csv_keys: Optional[List[str]] = None

        cont = str(cfg.continue_from_epoch)
        if cont == "from_scratch":
            self.create_summary_csv = True
        elif cont == "latest":
            if checkpoint_exists(self.saved_models_filepath, "train_model",
                                 "latest"):
                self.state = self.model.load_model(
                    self.saved_models_filepath, "latest")
                self.start_epoch = int(
                    self.state["current_iter"] // cfg.total_iter_per_epoch)
            else:
                self.create_summary_csv = True
        elif int(cont) >= 0:
            if not checkpoint_exists(self.saved_models_filepath,
                                     "train_model", int(cont)):
                raise FileNotFoundError(
                    f"checkpoint train_model_{int(cont)} not found in "
                    f"{self.saved_models_filepath}; it was most likely "
                    f"deleted by max_models_to_save="
                    f"{cfg.max_models_to_save} pruning (only the top-K "
                    "epochs by validation accuracy are kept). Resume with "
                    "continue_from_epoch='latest' or from a surviving "
                    "epoch checkpoint.")
            self.state = self.model.load_model(self.saved_models_filepath,
                                               int(cont))
            self.start_epoch = int(
                self.state["current_iter"] // cfg.total_iter_per_epoch)
        # the episode stream continues at the checkpoint's cursor, which
        # the loader holds to the iteration count
        self.data = data_loader_cls(
            cfg, current_iter=self.state["current_iter"],
            cache_dir=cfg.cache_dir or self.logs_filepath,
            episode_cursor=self.state.get("episode_cursor"))
        if cfg.data_placement == "device":
            self.model.register_flat_stores(
                {name: fs.data
                 for name, fs in self.data.dataset.flat_stores.items()})
        self.epoch = int(self.state["current_iter"]
                         // cfg.total_iter_per_epoch)
        self.state["best_epoch"] = int(
            self.state.get("best_val_iter", 0) // cfg.total_iter_per_epoch)
        # train-time augmentation only for Omniglot
        self.augment_flag = "omniglot" in cfg.dataset_name.lower()
        self.start_time = time.perf_counter()
        self.epochs_done_in_this_run = 0
        self.step_timer = StepTimer()
        self._pre_summary_result: Optional[Dict[str, float]] = None
        if not self.create_summary_csv:
            self._truncate_stats_to_resume_point()

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def build_summary_dict(total_losses, phase):
        """Per-phase mean and std of every accumulated metric; the one
        read of the card's metrics, at summary time."""
        summary_losses = {}
        for key in total_losses:
            # entries are per-dispatch scalars or (k,) chunk stacks
            vals = np.concatenate(
                [np.atleast_1d(_host(v)) for v in total_losses[key]])
            summary_losses[f"{phase}_{key}_mean"] = float(np.mean(vals))
            summary_losses[f"{phase}_{key}_std"] = float(np.std(vals))
        return summary_losses

    def _log(self, msg: str):
        if self.verbose:
            print(msg, flush=True)

    @staticmethod
    def _accumulate(losses: Dict[str, Any], total_losses):
        for key, value in losses.items():
            total_losses.setdefault(key, []).append(value)

    # -- resume ---------------------------------------------------------------

    def _truncate_stats_to_resume_point(self) -> None:
        """Keep only the summary CSV rows of epochs the resumed checkpoint
        covers: a killed run may have appended the row of an epoch whose
        checkpoint never landed, which the resumed run trains again. Atomic
        and line-based, so the kept rows keep their bytes."""
        path = os.path.join(self.logs_filepath, "summary_statistics.csv")
        if not os.path.isfile(path):
            return
        epochs_done = (int(self.state["current_iter"])
                       // self.cfg.total_iter_per_epoch)
        with open(path) as f:
            lines = f.readlines()
        if not lines:
            return
        header = lines[0].rstrip("\n").split(",")
        try:
            epoch_col = header.index("epoch")
        except ValueError:
            return
        kept = [lines[0]]
        dropped = 0
        for line in lines[1:]:
            fields = line.rstrip("\n").split(",")
            try:
                row_epoch = int(float(fields[epoch_col]))
            except (IndexError, ValueError):
                dropped += 1  # a torn write at the kill
                continue
            if row_epoch <= epochs_done:
                kept.append(line)
            else:
                dropped += 1
        if not dropped:
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.writelines(kept)
        os.replace(tmp, path)
        self._log(f"[resilience] dropped {dropped} summary CSV row(s) "
                  f"beyond the resumed checkpoint (epoch > {epochs_done})")

    def _stamp_elastic_state(self) -> None:
        """The global episode cursor and the writing process count, in the
        experiment state of every checkpoint."""
        self.state["episode_cursor"] = elastic.episode_cursor_for_iter(
            int(self.state["current_iter"]), self.cfg.global_tasks_per_batch)
        self.state["process_count"] = 1

    # -- phases -----------------------------------------------------------------

    def train_iterations(self, train_samples, epoch_idx):
        """len(train_samples) updates in one dispatch; the metrics are
        accumulated once a dispatch, (k,)-stacked, and the step timer ticks
        once a dispatch."""
        if len(train_samples) == 1:
            losses = self.model.run_train_iter(train_samples[0],
                                               epoch=epoch_idx)
        else:
            losses = self.model.run_train_iters(list(train_samples),
                                                epoch=epoch_idx)
        self._accumulate(losses, self.total_losses)
        self.state["current_iter"] += len(train_samples)
        self.step_timer.tick()

    def evaluation_iterations(self, val_samples, total_losses):
        if len(val_samples) == 1:
            losses, _ = self.model.run_validation_iter(val_samples[0])
        else:
            losses, _ = self.model.run_validation_iters(list(val_samples))
        self._accumulate(losses, total_losses)

    def run_validation_epoch(self, pre_summary_fn=None) -> Dict[str, float]:
        """The validation sweep in ``eval_batches_per_dispatch`` chunks.
        ``pre_summary_fn`` (the train summary) runs after the last chunk is
        enqueued and before its metrics are read, so its reads overlap the
        chunk's work; its result lands in ``_pre_summary_result``."""
        total_losses: Dict[str, List[Any]] = {}
        n_batches = int(self.cfg.num_evaluation_tasks / self.cfg.batch_size)
        chunk_k = max(1, int(self.cfg.eval_batches_per_dispatch))
        pending: List = []
        for val_sample in self.data.get_val_batches(total_batches=n_batches):
            pending.append(val_sample)
            if len(pending) < chunk_k:
                continue
            self.evaluation_iterations(pending, total_losses)
            pending = []
        if pending:
            self.evaluation_iterations(pending, total_losses)
        self._pre_summary_result = None
        if pre_summary_fn is not None:
            self._pre_summary_result = pre_summary_fn()
        return self.build_summary_dict(total_losses, "val")

    def _stream_metrics(self) -> Dict[str, float]:
        """The producer's statistics over the epoch, per batch."""
        stream = self.data.pop_stream_stats()
        denom = max(1, int(stream["batches"]))
        return {
            "stream_assembly_ms_per_batch": stream["assembly_s"] / denom * 1e3,
            "stream_stall_ms_per_batch": stream["stall_s"] / denom * 1e3,
            "stream_queue_depth_mean": stream["depth_sum"] / denom,
        }

    def pack_and_save_metrics(self, train_losses, val_losses):
        """The epoch's summary: the experiment state's per-epoch lists, the
        CSV row (the header first on a fresh run) and the log line."""
        timing = self.step_timer.summary()
        epoch_summary = {**train_losses, **val_losses, **timing,
                         **self._stream_metrics()}
        self.step_timer.reset()
        self.state.setdefault("per_epoch_statistics", {})
        for key, value in epoch_summary.items():
            self.state["per_epoch_statistics"].setdefault(key, []).append(
                value)
        epoch_summary["epoch"] = self.epoch
        epoch_summary["epoch_run_time"] = time.perf_counter() - self.start_time
        if self.create_summary_csv:
            self._csv_keys = list(epoch_summary.keys())
            save_statistics(self.logs_filepath, self._csv_keys, create=True)
            self.create_summary_csv = False
        if self._csv_keys is None:
            # resumed: rows follow the header on disk
            self._csv_keys = (self._existing_csv_header()
                              or list(epoch_summary.keys()))
            if set(self._csv_keys) != set(epoch_summary):
                self._log(
                    "[builder] resumed summary CSV has a different column "
                    "set than this build produces; rows stay aligned to "
                    "the existing header, extra metrics appear in "
                    "summary_statistics.json only")
        self.start_time = time.perf_counter()
        self._log(f"epoch {self.epoch} -> " + ", ".join(
            f"{k}: {v:.4f}" for k, v in epoch_summary.items()
            if "loss" in k or "accuracy" in k))
        save_statistics(self.logs_filepath,
                        [epoch_summary.get(k, "") for k in self._csv_keys])

    # -- the loop ------------------------------------------------------------------

    def run_experiment(self):
        try:
            return self._train_loop()
        finally:
            # every save on disk before the caller (or the pause's exit)
            # goes on; a failed write re-raises here
            wait_for_pending()

    def _train_loop(self):
        cfg = self.cfg
        total_iters = cfg.total_epochs * cfg.total_iter_per_epoch
        while (self.state["current_iter"] < total_iters
               and not cfg.evaluate_on_test_set_only):
            remaining = total_iters - self.state["current_iter"]
            # chunks of steps_per_dispatch, flushed at every epoch boundary
            dispatch_k = max(1, int(cfg.steps_per_dispatch))
            pending: List = []
            for train_sample in self.data.get_train_batches(
                    total_batches=remaining,
                    augment_images=self.augment_flag):
                pending.append(train_sample)
                at_boundary = (self.state["current_iter"] + len(pending)
                               ) % cfg.total_iter_per_epoch == 0
                if len(pending) < dispatch_k and not at_boundary:
                    continue
                epoch_idx = self.state["current_iter"] / cfg.total_iter_per_epoch
                self.train_iterations(pending, epoch_idx)
                pending = []
                if self.state["current_iter"] % cfg.total_iter_per_epoch == 0:
                    self._end_epoch(total_iters)
            if pending:
                # the loader ends at an epoch boundary; a shorter stream
                # must not drop trained-sample work
                self.train_iterations(
                    pending,
                    self.state["current_iter"] / cfg.total_iter_per_epoch)
        return self.evaluated_test_set_using_the_best_models(top_n_models=5)

    def _end_epoch(self, total_iters: int) -> None:
        cfg = self.cfg
        # the eval chunks are enqueued first; the train summary reads the
        # epoch's metrics while they run
        val_losses = self.run_validation_epoch(
            pre_summary_fn=lambda: self.build_summary_dict(
                self.total_losses, "train"))
        train_losses = self._pre_summary_result
        if val_losses["val_accuracy_mean"] > self.state["best_val_acc"]:
            self._log(f"Best validation accuracy "
                      f"{val_losses['val_accuracy_mean']:.4f}")
            self.state["best_val_acc"] = val_losses["val_accuracy_mean"]
            self.state["best_val_iter"] = self.state["current_iter"]
            self.state["best_epoch"] = int(
                self.state["best_val_iter"] // cfg.total_iter_per_epoch)
        self.epoch += 1
        self.state.update(train_losses)
        self.state.update(val_losses)
        # metrics before the checkpoint: the epoch-N checkpoint carries its
        # own epoch's per_epoch_statistics row, so a resumed run's rows and
        # checkpoints stay in register (the ensemble and pruning rank them)
        self.pack_and_save_metrics(train_losses, val_losses)
        # a previous epoch's failed write surfaces here, before this save
        wait_for_pending()
        self._stamp_elastic_state()
        self.model.save_model(self.saved_models_filepath, int(self.epoch),
                              self.state, also_latest=True)
        self._prune_saved_models()
        self.total_losses = {}
        self.epochs_done_in_this_run += 1
        save_to_json(os.path.join(self.logs_filepath,
                                  "summary_statistics.json"),
                     self.state["per_epoch_statistics"])
        if self.epochs_done_in_this_run >= cfg.total_epochs_before_pause:
            self._log(f"pause after {self.epochs_done_in_this_run} epochs")
            sys.exit()

    def _prune_saved_models(self) -> None:
        """Keep ``latest`` and the ``max_models_to_save`` best epochs by
        validation accuracy, ranked as the final ensemble ranks them (a
        stable sort, ties to the later epoch), so pruning never deletes a
        checkpoint the ensemble asks for. K <= 0 keeps every epoch."""
        k = int(self.cfg.max_models_to_save)
        if k <= 0:
            return
        val_acc = np.asarray(
            self.state["per_epoch_statistics"]["val_accuracy_mean"],
            dtype=float)
        if not self._stats_cover_on_disk_checkpoints(len(val_acc),
                                                     "skipping pruning"):
            return
        # stat row i is checkpoint i + 1 (the epoch counter is 1-based at
        # the save)
        keep = {int(i) + 1
                for i in np.argsort(val_acc, kind="stable")[::-1][:k]}
        for epoch_idx in range(1, len(val_acc) + 1):
            if epoch_idx not in keep:
                remove_checkpoint(self.saved_models_filepath, "train_model",
                                  epoch_idx)

    def _existing_csv_header(self) -> Optional[List[str]]:
        path = os.path.join(self.logs_filepath, "summary_statistics.csv")
        try:
            with open(path) as f:
                header = next(csv.reader(f))
        except (OSError, StopIteration):
            return None
        return header or None

    def _highest_epoch_checkpoint_index(self) -> int:
        """The largest N with a finalized ``train_model_N`` (0 if none)."""
        highest = 0
        try:
            names = os.listdir(self.saved_models_filepath)
        except OSError:
            return 0
        for name in names:
            m = re.fullmatch(r"train_model_(\d+)", name)
            if m and os.path.isdir(os.path.join(self.saved_models_filepath,
                                                name)):
                highest = max(highest, int(m.group(1)))
        return highest

    def _stats_cover_on_disk_checkpoints(self, n_rows: int, what: str
                                         ) -> bool:
        """Check 'stat row i <-> checkpoint i + 1' before ranking on it."""
        highest = self._highest_epoch_checkpoint_index()
        if highest <= n_rows:
            return True
        self._log(
            f"[builder] WARNING: {what}: on-disk epoch checkpoints reach "
            f"train_model_{highest} but per_epoch_statistics has only "
            f"{n_rows} val rows — the stat-row/checkpoint register is off; "
            "ranking it could target the wrong epoch's checkpoint")
        return False

    # -- the final test ensemble -----------------------------------------------------

    def evaluated_test_set_using_the_best_models(self, top_n_models: int = 5):
        if self.cfg.max_models_to_save > 0:
            top_n_models = min(top_n_models, int(self.cfg.max_models_to_save))
        val_acc = np.copy(
            self.state["per_epoch_statistics"]["val_accuracy_mean"])
        self._stats_cover_on_disk_checkpoints(len(val_acc),
                                              "ensembling anyway")
        # a stable sort, as in _prune_saved_models
        sorted_idx = np.argsort(val_acc, axis=0, kind="stable").astype(
            np.int32)[::-1][:top_n_models]
        self._log(f"top-{top_n_models} val epochs {sorted_idx} acc "
                  f"{val_acc[sorted_idx]}")
        n_batches = int(self.cfg.num_evaluation_tasks / self.cfg.batch_size)
        per_model_preds, all_targets = self._ensemble_predict(sorted_idx,
                                                              n_batches)
        # mean softmax over the models -> argmax
        per_batch_preds = np.mean(np.array(per_model_preds), axis=0)
        per_batch_max = np.argmax(per_batch_preds, axis=2)
        per_batch_targets = np.array(all_targets).reshape(per_batch_max.shape)
        hits = np.equal(per_batch_targets, per_batch_max)
        test_losses = {"test_accuracy_mean": float(np.mean(hits)),
                       "test_accuracy_std": float(np.std(hits))}
        save_statistics(self.logs_filepath, list(test_losses.keys()),
                        create=True, filename="test_summary.csv")
        save_statistics(self.logs_filepath, list(test_losses.values()),
                        filename="test_summary.csv")
        self._log(str(test_losses))
        return test_losses

    def _ensemble_predict(self, sorted_idx, n_batches):
        """Each top checkpoint's softmax predictions over the test stream,
        in ``eval_batches_per_dispatch`` chunks, and (once) the targets."""
        from ..data.loader import IndexBatch

        chunk_k = max(1, int(self.cfg.eval_batches_per_dispatch))
        per_model_preds: List[List[np.ndarray]] = [[] for _ in sorted_idx]
        all_targets: List[np.ndarray] = []

        def flush(idx, samples):
            _, preds = self.model.run_validation_iters(list(samples),
                                                       return_preds=True)
            for j, sample in enumerate(samples):
                per_model_preds[idx].extend(list(preds[j]))
                if idx == 0:
                    # the test stream repeats every call: targets once
                    if isinstance(sample, IndexBatch):
                        t = sample.target_labels(self.cfg.num_target_samples)
                    else:
                        t = np.asarray(sample[3])
                    all_targets.extend(list(t.reshape(t.shape[0], -1)))

        for idx, model_idx in enumerate(sorted_idx):
            # stat row i is the checkpoint of epoch i + 1
            self.state = self.model.load_model(self.saved_models_filepath,
                                               int(model_idx) + 1)
            pending: List = []
            for test_sample in self.data.get_test_batches(
                    total_batches=n_batches):
                pending.append(test_sample)
                if len(pending) < chunk_k:
                    continue
                flush(idx, pending)
                pending = []
            if pending:
                flush(idx, pending)
        return per_model_preds, all_targets
