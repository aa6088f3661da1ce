"""Checkpoint save and restore: ``torch.save`` for the meta-state, JSON for
the experiment state.

The port of the JAX package's ``experiment/checkpoint.py`` on a one-process
run, with ``torch.save`` / ``torch.load(weights_only=True)`` in place of
orbax. A checkpoint is the directory ``<saved_models>/<name>_<idx>``
holding

* ``state.pt``: the ``MetaState`` as the port's ``state.to_numpy`` form
  keeps it, host tensors under the JAX pytree's keys — ``{"net": {...},
  "lslr": {...}, "bn": {...}, "opt": {"count": ..., "mu": {"net": ...,
  "lslr": ...}, "nu": ...}}`` (``opt`` None for a state without Adam);
* ``experiment_state.json``: best_val_acc, best_val_iter, current_iter,
  episode_cursor, per_epoch_statistics, ...

Each epoch's save writes ``train_model_<epoch>`` and, from that finished
directory, ``train_model_latest`` (``save_checkpoint_async``): the state is
copied to the host before the call returns, so the next step may go on,
and one background writer thread writes it, swaps ``<ckpt>.tmp`` into
place and clones ``latest``. ``wait_for_pending`` is the barrier, taken
before every later save, load, existence check and prune of the path in
flight, and at interpreter exit; it re-raises the writer's error. A swap
renames the old directory aside to ``<ckpt>.old`` before the new one goes
in, so a kill between the two renames leaves a complete checkpoint that
the next load moves back (``_recover_interrupted_swap``).

The multi-host barriers of the JAX module come with ``parallel/`` (ROADMAP
Queue A).
"""

from __future__ import annotations

import atexit
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.adam import AdamState
from ..state import MetaState

_STATE_FILE = "state.pt"
_EXPERIMENT_STATE_FILE = "experiment_state.json"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory exists but cannot be restored (a partial
    write that survived a crash, bit rot, a foreign directory under
    ``saved_models/``). The message names the path, the cause and the
    surviving sibling checkpoints to fall back to."""

    def __init__(self, path: str, cause: BaseException,
                 fallbacks: List[str]):
        self.path = path
        self.fallbacks = list(fallbacks)
        hint = (
            "surviving checkpoints in the same directory: "
            + ", ".join(self.fallbacks)
            if self.fallbacks
            else "no other checkpoints survive in that directory"
        )
        super().__init__(
            f"checkpoint at {path} is corrupt or partially written "
            f"({cause!r}); {hint}. Resume with continue_from_epoch="
            "'latest' (or a surviving epoch index), or delete the corrupt "
            "directory and restart from_scratch."
        )


def list_checkpoints(model_save_dir: str, model_name: str) -> List[str]:
    """Finalized ``<model_name>_*`` checkpoint directories (suffixes only,
    e.g. ``['3', '5', 'latest']``); ``.tmp`` and ``.old`` siblings
    excluded."""
    try:
        names = os.listdir(model_save_dir)
    except OSError:
        return []
    prefix = model_name + "_"
    return sorted(
        name[len(prefix):]
        for name in names
        if name.startswith(prefix)
        and not name.endswith((".tmp", ".old"))
        and os.path.isdir(os.path.join(model_save_dir, name))
    )


# the one save in flight: (writer thread, paths it creates or replaces,
# error holder)
_pending_save: Optional[Tuple[threading.Thread, Tuple[str, ...], List]] = None


def wait_for_pending(touching: Optional[str] = None) -> None:
    """Barrier for the save in flight: always with ``touching=None``, else
    only when that save creates or replaces ``touching``. Re-raises the
    writer's error."""
    global _pending_save
    if _pending_save is None:
        return
    thread, paths, errors = _pending_save
    if touching is not None and touching not in paths:
        return
    thread.join()
    _pending_save = None
    if errors:
        raise errors[0]


atexit.register(wait_for_pending)


def _ckpt_dir(model_save_dir: str, model_name: str, model_idx) -> str:
    return os.path.join(model_save_dir, f"{model_name}_{model_idx}")


class _NumpyEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, (np.floating, np.integer)):
            return obj.item()
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def _host(v: torch.Tensor) -> torch.Tensor:
    return v.detach().to("cpu", copy=True)


def state_payload(state: MetaState) -> Dict[str, Any]:
    """``state`` as the host-tensor dict ``state.pt`` holds (a copy)."""
    payload: Dict[str, Any] = {
        group: {k: _host(v) for k, v in getattr(state, group).items()}
        for group in ("net", "lslr", "bn")
    }
    opt = state.opt
    payload["opt"] = None if opt is None else {
        "count": _host(opt.count),
        "mu": {g: {k: _host(v) for k, v in leaves.items()}
               for g, leaves in opt.mu.items()},
        "nu": {g: {k: _host(v) for k, v in leaves.items()}
               for g, leaves in opt.nu.items()},
    }
    return payload


def _state_of(payload: Dict[str, Any], device: torch.device) -> MetaState:
    def to(leaves):
        return {k: v.to(device) for k, v in leaves.items()}

    opt = payload.get("opt")
    if opt is not None:
        opt = AdamState(opt["count"].to(device),
                        {g: to(v) for g, v in opt["mu"].items()},
                        {g: to(v) for g, v in opt["nu"].items()})
    return MetaState(to(payload["net"]), to(payload["lslr"]),
                     to(payload["bn"]), opt)


def _write_experiment_state(directory: str,
                            experiment_state: Dict[str, Any]) -> None:
    with open(os.path.join(directory, _EXPERIMENT_STATE_FILE), "w") as f:
        json.dump(experiment_state, f, cls=_NumpyEncoder)


def _write_state(directory: str, payload: Dict[str, Any]) -> None:
    path = os.path.join(directory, _STATE_FILE)
    with open(path, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(model_save_dir: str, model_name: str, model_idx,
                    state: MetaState, experiment_state: Dict[str, Any]
                    ) -> str:
    """Write one checkpoint directory, synchronously."""
    wait_for_pending()
    path = _ckpt_dir(model_save_dir, model_name, model_idx)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    _write_state(tmp, state_payload(state))
    _write_experiment_state(tmp, experiment_state)
    _swap_into_place(tmp, path)
    return path


def _swap_into_place(tmp: str, path: str) -> None:
    """Crash-safe tmp -> final swap: the previous directory is renamed
    aside (atomic) before the new one is renamed in (atomic), then
    deleted, never removed while it is the only copy."""
    old = path + ".old"
    shutil.rmtree(old, ignore_errors=True)
    if os.path.isdir(path):
        os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def _recover_interrupted_swap(path: str) -> None:
    """Finish a swap killed between its two renames: ``path`` gone and
    ``<path>.old`` complete, so move it back."""
    old = path + ".old"
    if not os.path.isdir(path) and os.path.isdir(old):
        try:
            os.replace(old, path)
        except OSError:
            pass


def save_checkpoint_async(model_save_dir: str, model_name: str, model_idx,
                          state: MetaState, experiment_state: Dict[str, Any],
                          clone_to=None) -> str:
    """Start a checkpoint write; returns once the state is copied to the
    host. The writer thread saves it into ``<name>_<idx>.tmp``, swaps that
    into place and, with ``clone_to`` (the runner passes ``'latest'``),
    copies the finished directory to ``<name>_<clone_to>`` through its own
    tmp and swap: ``latest`` is only ever replaced from a complete
    checkpoint."""
    global _pending_save
    wait_for_pending()
    path = _ckpt_dir(model_save_dir, model_name, model_idx)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    payload = state_payload(state)
    _write_experiment_state(tmp, experiment_state)
    clone_path = (_ckpt_dir(model_save_dir, model_name, clone_to)
                  if clone_to is not None else None)
    errors: List = []

    def _finalize():
        try:
            _write_state(tmp, payload)
            _swap_into_place(tmp, path)
            if clone_path is not None:
                clone_tmp = clone_path + ".tmp"
                shutil.rmtree(clone_tmp, ignore_errors=True)
                shutil.copytree(path, clone_tmp)
                _swap_into_place(clone_tmp, clone_path)
        except BaseException as e:  # re-raised at the barrier
            errors.append(e)

    thread = threading.Thread(target=_finalize, name="ckpt-finalize",
                              daemon=True)
    thread.start()
    touched = (path,) if clone_path is None else (path, clone_path)
    _pending_save = (thread, touched, errors)
    return path


def _check_like(target: MetaState, got: MetaState) -> None:
    for group in ("net", "lslr", "bn"):
        want, have = getattr(target, group), getattr(got, group)
        if set(want) != set(have):
            raise ValueError(
                f"checkpoint {group} keys {sorted(have)} differ from the "
                f"model's {sorted(want)}: does the config match the "
                "checkpoint's architecture?")
        for k, v in want.items():
            if tuple(have[k].shape) != tuple(v.shape):
                raise ValueError(
                    f"checkpoint {group}[{k}] has shape "
                    f"{tuple(have[k].shape)}, the model {tuple(v.shape)}")


def load_checkpoint(model_save_dir: str, model_name: str, model_idx,
                    target_state: MetaState
                    ) -> Tuple[MetaState, Dict[str, Any]]:
    """Restore a checkpoint onto ``target_state``'s device, its keys and
    shapes held to ``target_state``'s."""
    wait_for_pending()
    path = _ckpt_dir(model_save_dir, model_name, model_idx)
    _recover_interrupted_swap(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"checkpoint directory {path} does not exist")
    device = next(iter(target_state.net.values())).device
    try:
        payload = torch.load(os.path.join(path, _STATE_FILE),
                             map_location="cpu", weights_only=True)
        state = _state_of(payload, device)
        with open(os.path.join(path, _EXPERIMENT_STATE_FILE)) as f:
            experiment_state = json.load(f)
    except Exception as e:  # torch.load and JSON fail many ways on a
        # partial write; each means the same thing here
        fallbacks = [s for s in list_checkpoints(model_save_dir, model_name)
                     if s != str(model_idx)]
        raise CheckpointCorruptError(path, e, fallbacks) from e
    _check_like(target_state, state)
    return state, experiment_state


def peek_experiment_state(model_save_dir: str, model_name: str, model_idx
                          ) -> Optional[Dict[str, Any]]:
    """A checkpoint's experiment-state dict without loading its tensors
    (None when the checkpoint or its JSON is absent or corrupt)."""
    path = _ckpt_dir(model_save_dir, model_name, model_idx)
    wait_for_pending(touching=path)
    _recover_interrupted_swap(path)
    try:
        with open(os.path.join(path, _EXPERIMENT_STATE_FILE)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def checkpoint_exists(model_save_dir: str, model_name: str, model_idx
                      ) -> bool:
    path = _ckpt_dir(model_save_dir, model_name, model_idx)
    wait_for_pending(touching=path)
    _recover_interrupted_swap(path)
    return os.path.isdir(path)


def remove_checkpoint(model_save_dir: str, model_name: str, model_idx
                      ) -> None:
    """Delete one checkpoint directory (and a ``.old`` sibling, which the
    next load would otherwise bring back); missing is fine. Waits for the
    save in flight only when it targets this path."""
    path = _ckpt_dir(model_save_dir, model_name, model_idx)
    wait_for_pending(touching=path)
    shutil.rmtree(path, ignore_errors=True)
    shutil.rmtree(path + ".old", ignore_errors=True)
