"""The meta-learning system: the host side of the train and eval steps.

The port of the JAX package's ``experiment/system.py::
MAMLFewShotClassifier`` (:83) on one card: ``run_train_iter`` (:557),
``run_train_iters`` (:615, ``steps_per_dispatch``), ``run_validation_iter``
(:688), ``run_validation_iters`` (:741, ``eval_batches_per_dispatch``),
the device tier's stores (``register_flat_stores``, ``_device_store``
:361-394), the batch conversion and upload (``_convert_batch``, and
``_stage`` for ``_prepare_batch`` and its stacked and index forms
:420-530), ``save_model`` (:896), ``load_model`` (:931) and
``device_memory_stats`` (:839, from ``torch.cuda``'s allocator). Per
iteration the host computes the epoch's schedule (cosine LR, MSL weights,
first or second order: ``_epoch_schedule``); the steps are
``core/maml.py``'s.

The step is enqueued one dispatch ahead: before each dispatch the host
waits for the one before it (a CUDA event recorded after it), so it never
runs more than a step ahead of the card and never blocks on the step it
just enqueued; at a switch between train and eval it does not wait at all.
Metrics stay tensors on the card until the epoch summary reads them.

Runs on ``cuda:0`` unless ``device`` names another device. A mesh, a
store sharded over hosts and more than one process come with ``parallel/``
(ROADMAP Queue A).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import MAMLConfig
from ..core import maml, msl
from ..data.loader import IndexBatch
from ..device import DeviceLike, resolve_device
from ..state import init_state
from . import checkpoint as ckpt


def _to_nhwc(x: np.ndarray, layout: str = "auto",
             im_shape: Optional[Tuple[int, int, int]] = None) -> np.ndarray:
    """Reference-layout (..., c, h, w) batches to NHWC: ``'nhwc'`` and
    ``'nchw'`` never guess; ``'auto'`` matches the trailing dims against
    the config's (h, w, c), then takes channels from whichever of dims -1
    and -3 is 1 or 3, and refuses an ambiguous or unknown shape."""
    if layout == "nhwc":
        return x
    if layout == "nchw":
        return np.moveaxis(x, -3, -1)
    if im_shape is not None:
        h, w, c = im_shape
        if x.shape[-3:] == (h, w, c):
            return x
        if x.shape[-3:] == (c, h, w) and (h, w, c) != (c, h, w):
            return np.moveaxis(x, -3, -1)
    nhwc_like = x.shape[-1] in (1, 3)
    nchw_like = x.shape[-3] in (1, 3)
    if nhwc_like and nchw_like:
        raise ValueError(
            f"batch shape {x.shape} is ambiguous between NHWC and NCHW; "
            "set input_layout='nhwc' or 'nchw' in the config"
        )
    if nhwc_like:
        return x
    if nchw_like:
        return np.moveaxis(x, -3, -1)
    raise ValueError(
        f"cannot infer layout of batch with shape {x.shape}; "
        "set input_layout='nhwc' or 'nchw' in the config"
    )


def _sorted(metrics) -> Dict[str, Any]:
    """The metrics in key order, the order of a JAX program's output dict
    and so of the JAX package's CSV columns."""
    return dict(sorted(metrics.items()))


def _schedule_losses(metrics, anneal, lr) -> Dict[str, Any]:
    """The metrics (tensors) plus the per-step MSL weights and the LR
    (host floats), under the reference's keys."""
    losses: Dict[str, Any] = _sorted(metrics)
    for i, w in enumerate(anneal):
        losses[f"loss_importance_vector_{i}"] = float(w)
    losses["learning_rate"] = float(lr)
    return losses


class MAMLFewShotClassifier:
    """The meta-state and the steps that train and evaluate it."""

    def __init__(self, cfg: MAMLConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.current_epoch = 0
        self.state = init_state(cfg, device=self.device, with_opt=True)
        if cfg.store_sharding == "hosts":
            print("[system] store_sharding='hosts' requested but there is "
                  "one process; resident stores stay replicated", flush=True)
        self._train_steps: Dict[Any, Any] = {}
        self._eval_steps: Dict[Any, Any] = {}
        # the device tier: host uint8 stores, uploaded on first use
        self._host_stores: Dict[str, np.ndarray] = {}
        self._device_stores: Dict[str, torch.Tensor] = {}
        # the one-step lag: an event after the last dispatch, and its phase
        self._pending_sync: Optional[torch.cuda.Event] = None
        self._pending_phase: Optional[str] = None

    # -- steps -------------------------------------------------------------

    def _train_step(self, second_order: bool, k: int, indexed: bool,
                    augment: bool = False):
        key = (second_order, k > 1, indexed, augment)
        if key not in self._train_steps:
            cfg = self.cfg
            if indexed:
                make = (maml.make_train_multi_step_indexed if k > 1
                        else maml.make_train_step_indexed)
                self._train_steps[key] = make(cfg, second_order, augment)
            else:
                make = (maml.make_train_multi_step if k > 1
                        else maml.make_train_step)
                self._train_steps[key] = make(cfg, second_order)
        return self._train_steps[key]

    def _eval_step(self, k: int, with_preds: bool, indexed: bool,
                   augment: bool = False):
        key = (k > 1, with_preds, indexed, augment)
        if key not in self._eval_steps:
            cfg = self.cfg
            if k == 1:
                self._eval_steps[key] = (
                    maml.make_eval_step_indexed(cfg, augment) if indexed
                    else maml.make_eval_step(cfg))
            elif indexed:
                self._eval_steps[key] = maml.make_eval_multi_step_indexed(
                    cfg, with_preds, augment)
            else:
                self._eval_steps[key] = maml.make_eval_multi_step(
                    cfg, with_preds)
        return self._eval_steps[key]

    def _sync_before_dispatch(self, phase: str) -> None:
        """Wait for the previous dispatch, except where the phase changes
        (train <-> eval): there the next dispatch's inputs are ready and
        the stream orders the work."""
        if (self._pending_sync is not None
                and self._pending_phase in (None, phase)):
            self._pending_sync.synchronize()
        self._pending_phase = phase

    def _mark_dispatched(self) -> None:
        if self.device.type == "cuda":
            self._pending_sync = torch.cuda.Event()
            self._pending_sync.record()

    # -- the device tier's stores --------------------------------------------

    def register_flat_stores(self, stores: Dict[str, np.ndarray]) -> None:
        """Per-set host uint8 stores (``FlatStore.data``) for
        ``data_placement='device'``; each goes to the card at its set's
        first batch, so a set never evaluated costs no device memory."""
        self._host_stores.update(stores)
        self._device_stores.clear()

    def _device_store(self, set_name: str) -> torch.Tensor:
        if set_name not in self._device_stores:
            if set_name not in self._host_stores:
                raise ValueError(
                    f"data_placement='device' but no flat store registered "
                    f"for set {set_name!r}; call register_flat_stores with "
                    "the dataset's FlatStore data (the experiment builder "
                    "does this automatically)"
                )
            host = np.array(self._host_stores[set_name])  # off the memmap
            self._device_stores[set_name] = torch.from_numpy(host).to(
                self.device)
        return self._device_stores[set_name]

    # -- batches ---------------------------------------------------------------

    def _upload(self, *arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device) for a in arrays)

    def _convert_batch(self, data_batch):
        """Layout and dtype only: (x_s, y_s, x_t, y_t) host arrays."""
        x_s, x_t, y_s, y_t = data_batch[:4]
        layout, shape = self.cfg.input_layout, self.cfg.im_shape
        if self.cfg.data_placement == "uint8_stream":
            # raw pixels go up and the step decodes them; a float batch
            # here would be truncated by a uint8 cast, so refuse it
            for a in (x_s, x_t):
                if np.asarray(a).dtype != np.uint8:
                    raise ValueError(
                        "data_placement='uint8_stream' expects uint8 image "
                        f"batches from the loader, got {np.asarray(a).dtype}"
                    )
            x_s = _to_nhwc(np.asarray(x_s), layout, shape)
            x_t = _to_nhwc(np.asarray(x_t), layout, shape)
        else:
            x_s = _to_nhwc(np.asarray(x_s, np.float32), layout, shape)
            x_t = _to_nhwc(np.asarray(x_t, np.float32), layout, shape)
        return x_s, np.asarray(y_s, np.int32), x_t, np.asarray(y_t, np.int32)

    def _stage(self, batches, phase: str):
        """Upload one batch (k of them: stacked on a leading axis) and take
        the one-step lag, the upload enqueued before the wait. Returns the
        step's batch arguments (an index batch's with the resident store
        first), whether they are index batches, and their augment flag."""
        first = batches[0]
        indexed = isinstance(first, IndexBatch)
        if indexed:
            parts = [(b.gather, b.rot_k) for b in batches]
        else:
            parts = [self._convert_batch(b) for b in batches]
        arrays = ([np.stack(p) for p in zip(*parts)] if len(batches) > 1
                  else parts[0])
        placed = self._upload(*arrays)
        if indexed:
            placed = (self._device_store(first.set_name), *placed)
        self._sync_before_dispatch(phase)
        return placed, indexed, indexed and first.augment

    # -- the reference's interface ------------------------------------------

    def _epoch_schedule(self, epoch: int):
        """(lr, MSL weights, second order, the per-step anneal values to
        log): the one definition of the epoch's schedule."""
        lr, weights, second_order = maml.epoch_schedule(self.cfg, epoch)
        anneal = msl.per_step_loss_importance(
            self.cfg.number_of_training_steps_per_iter,
            self.cfg.multi_step_loss_num_epochs, epoch)
        return lr, weights, second_order, anneal

    def _train(self, data_batches: List, epoch) -> Dict[str, Any]:
        epoch = int(epoch)
        self.current_epoch = epoch
        lr, weights, second_order, anneal = self._epoch_schedule(epoch)
        k = len(data_batches)
        args, indexed, augment = self._stage(data_batches, "train")
        step = self._train_step(second_order, k, indexed, augment)
        self.state, metrics = step(self.state, *args, weights, lr)
        self._mark_dispatched()
        return _schedule_losses(metrics, anneal, lr)

    def run_train_iter(self, data_batch, epoch) -> Dict[str, Any]:
        """One outer update. Returns the reference's keys (loss, accuracy,
        loss_importance_vector_i, learning_rate): loss and accuracy are
        tensors on the card, the schedule's entries host floats."""
        return self._train([data_batch], epoch)

    def run_train_iters(self, data_batches, epoch) -> Dict[str, Any]:
        """len(data_batches) outer updates in one dispatch, the same math
        as that many ``run_train_iter`` calls at the epoch; the metrics
        come back stacked (k,)."""
        if len(data_batches) == 1:
            per_iter = self.run_train_iter(data_batches[0], epoch)
            return {key: v if np.isscalar(v) else [v]
                    for key, v in per_iter.items()}
        return self._train(list(data_batches), epoch)

    def _evaluate(self, data_batches: List, return_preds: bool):
        k = len(data_batches)
        args, indexed, augment = self._stage(data_batches, "eval")
        step = self._eval_step(k, return_preds, indexed, augment)
        metrics, preds = step(self.state, *args)
        self._mark_dispatched()
        out = preds.cpu().numpy() if return_preds else None
        return _sorted(metrics), out

    def run_validation_iter(self, data_batch, return_preds: bool = False
                            ) -> Tuple[Dict[str, Any], Optional[np.ndarray]]:
        """One evaluation pass: (metrics on the card, host softmax preds
        when ``return_preds``, for the test ensemble)."""
        return self._evaluate([data_batch], return_preds)

    def run_validation_iters(self, data_batches, return_preds: bool = False
                             ) -> Tuple[Dict[str, Any], Optional[np.ndarray]]:
        """len(data_batches) evaluation passes in one dispatch: metrics
        stacked (k,), preds (k, tasks, targets, classes)."""
        if len(data_batches) == 1:
            metrics, preds = self.run_validation_iter(data_batches[0],
                                                      return_preds)
            return ({key: [v] for key, v in metrics.items()},
                    preds[None] if return_preds else None)
        return self._evaluate(list(data_batches), return_preds)

    def device_memory_stats(self) -> Dict[str, Any]:
        """The resident stores' bytes beside the allocator's figures on
        the card (none on the CPU)."""
        out: Dict[str, Any] = {
            "store_bytes_expected": sum(
                int(self._host_stores[name].nbytes)
                for name in self._device_stores),
            "stores_resident": sorted(self._device_stores),
            "store_sharding": "replicated",
        }
        if self.device.type == "cuda":
            stats = torch.cuda.memory_stats(self.device)
            out["bytes_in_use"] = int(stats["allocated_bytes.all.current"])
            out["peak_bytes_in_use"] = int(stats["allocated_bytes.all.peak"])
            out["bytes_reserved"] = int(stats["reserved_bytes.all.current"])
            out["bytes_limit"] = int(
                torch.cuda.get_device_properties(self.device).total_memory)
        return out

    # -- checkpoints -------------------------------------------------------------

    def save_model(self, model_save_dir: str, model_idx,
                   experiment_state: Dict[str, Any],
                   also_latest: bool = False) -> str:
        """Checkpoint the state as ``train_model_<model_idx>``, and with
        ``also_latest`` as ``train_model_latest`` from the same write."""
        return ckpt.save_checkpoint_async(
            model_save_dir, "train_model", model_idx, self.state,
            experiment_state, clone_to="latest" if also_latest else None)

    def load_model(self, model_save_dir: str, model_idx) -> Dict[str, Any]:
        self.state, experiment_state = ckpt.load_checkpoint(
            model_save_dir, "train_model", model_idx, self.state)
        return experiment_state
