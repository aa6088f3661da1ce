"""The MAML / MAML++ learner: second- and first-order training with MSL,
Adam and merged BN statistics, evaluation, and adapt-then-predict serving.

The port of the JAX package's ``core/maml.py``: ``cosine_lr`` (:90),
``epoch_schedule`` (the JAX package's ``experiment/system.py::
_epoch_schedule`` :533-555 without its anneal log), ``_task_learner``
(:149), ``_merge_bn`` (:286), ``_split_microbatches`` (:319),
``_meta_loss_and_grads`` (:333), ``make_grads_fn`` (:436),
``make_train_step`` (:506, with the uint8 prelude ``_decode_prelude``
:498), ``make_eval_step`` (:675), ``_serve_outputs``, ``make_serve_step``
(:762, f32 and uint8 ingests), ``make_serve_step_indexed`` (:843),
``make_train_step_indexed`` (:1009) and ``make_eval_step_indexed``
(:1065), and the runner's chunked dispatches ``make_train_multi_step``
(:603), ``make_eval_multi_step`` (:641), ``make_train_multi_step_indexed``
(:1041) and ``make_eval_multi_step_indexed`` (:1081): k calls of the
single step at one epoch, each batch argument with a leading k axis, the
metrics stacked (k,). The outer optimizer is ``core/adam.py::
make_optimizer``.

The uint8 and index ingests put ``ops/device_pipeline.py`` in front of the
step: uint8 batches are decoded on the card, index batches expanded from a
uint8 store resident on the card (gather, decode, rot90 in one
``episode_expand`` launch, labels made on the card). What follows is the
f32 step unchanged, so each ingest gives the f32 path's numbers on the
same pixels.

The JAX package maps one task learner over the task axis with ``vmap``;
here the TENANT (task) axis is a batch dimension written out: every
adapted parameter is expanded per tenant, and each tenant's batch-norm
statistics reduce over its own images only.

Per inner step (as ``_task_learner``'s ``inner_step``): the support
forward, the support gradient of the SUM over tenants of each tenant's
mean loss (a mean over tenants would scale every tenant's gradient by
1/T), the LSLR update, then the target forward with the updated weights
at the same BN step. Every step's target loss is kept and weighted by the
loss-weight vector (MSL, or one-hot on the last step).

Whether the learner builds a meta-gradient graph follows PyTorch's grad
mode at the call. Under ``torch.no_grad()`` (serving, evaluation) each
step's fast weights are fresh leaves and the target forwards record
nothing. With grad enabled (training) the fast weights start as the
tenant-expanded meta-parameters, graph kept, and each inner gradient is
taken with ``create_graph=second_order``: first order keeps
``theta_k = theta_{k-1} - alpha * stop_grad(g)`` exactly as the JAX package
does (:201-209), so the LSLR vectors receive meta-gradients in both
orders.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import MAMLConfig
from ..models import vgg
from ..ops import device_pipeline
from ..ops import functional as F
from ..state import MetaState
from . import adam as adam_lib
from . import lslr as lslr_lib
from . import msl as msl_lib
from . import partition

Tensor = torch.Tensor
GROUPS = ("net", "lslr")


def cosine_lr(cfg: MAMLConfig, epoch: int) -> float:
    """CosineAnnealingLR in closed form at the integer epoch:
    ``eta_min + (lr0 - eta_min) * (1 + cos(pi * epoch / T_max)) / 2``."""
    return cfg.min_learning_rate + 0.5 * (
        cfg.meta_learning_rate - cfg.min_learning_rate
    ) * (1.0 + math.cos(math.pi * epoch / cfg.total_epochs))


def epoch_schedule(cfg: MAMLConfig, epoch: int
                   ) -> Tuple[float, np.ndarray, bool]:
    """What the outer step takes from the epoch: ``(lr, msl_weights,
    second_order)``."""
    lr = cosine_lr(cfg, epoch)
    weights = msl_lib.loss_weights_for(
        cfg.number_of_training_steps_per_iter,
        cfg.use_multi_step_loss_optimization,
        True,
        epoch,
        cfg.multi_step_loss_num_epochs,
    )
    second_order = bool(
        cfg.second_order and epoch > cfg.first_order_to_second_order_epoch
    )
    return lr, weights, second_order


def _task_learner(cfg: MAMLConfig, num_steps: int, second_order: bool = False,
                  block: Optional[vgg.BlockFn] = None):
    """The tenant-batched task learner (see the module docstring for how
    grad mode decides between serving and training).

    Returns ``learner(net, lslr, bn, x_s, y_s, x_t, y_t, loss_weights) ->
    (loss, correct, bn, preds)`` for batches with a leading tenant axis:
    ``x_s`` (T, way, shots, h, w, c), ``y_s`` (T, way, shots), ``x_t``
    (T, way, targets, h, w, c), ``y_t`` (T, way, targets). ``loss`` (T,) is
    the weighted target loss, ``correct`` (T, way*targets) the final
    step's per-sample correctness, ``preds`` its softmax (class-major
    query order), ``bn`` the per-tenant BN state after the last step.
    """

    def learner(net, lslr_params, bn_state, x_s, y_s, x_t, y_t,
                loss_weights):
        n_tenants = x_s.shape[0]
        x_s = x_s.reshape(n_tenants, -1, *x_s.shape[-3:])
        x_t = x_t.reshape(n_tenants, -1, *x_t.shape[-3:])
        y_s = y_s.reshape(n_tenants, -1)
        y_t = y_t.reshape(n_tenants, -1)
        meta = torch.is_grad_enabled()
        adapted, frozen = partition.split_inner(cfg, net)
        theta = {k: v.unsqueeze(0).expand(n_tenants, *v.shape)
                 for k, v in adapted.items()}
        if not meta:
            theta = {k: v.detach().clone() for k, v in theta.items()}
        bn = bn_state
        t_losses = []
        t_logits = None
        for step in range(num_steps):
            if not meta:
                for v in theta.values():
                    v.requires_grad_(True)
            with torch.enable_grad():
                logits, bn = vgg.apply(cfg, {**frozen, **theta}, bn, x_s,
                                       step, block=block)
                support_loss = F.cross_entropy(logits, y_s).sum()
                grads = torch.autograd.grad(
                    support_loss, list(theta.values()),
                    create_graph=meta and second_order)
            grads = dict(zip(theta.keys(), grads))
            if cfg.inner_loop_optimizer == "sgd":
                theta = lslr_lib.sgd_update_params(theta, grads,
                                                   cfg.inner_lr_init)
            else:
                theta = lslr_lib.update_params(theta, grads, lslr_params,
                                               step)
            t_logits, bn = vgg.apply(cfg, {**frozen, **theta}, bn, x_t, step,
                                     block=block)
            t_losses.append(F.cross_entropy(t_logits, y_t))
        weights = torch.as_tensor(loss_weights, dtype=t_losses[0].dtype,
                                  device=x_s.device)
        loss = torch.stack(t_losses, dim=-1) @ weights
        t_logits = t_logits.detach()
        correct = F.accuracy(t_logits, y_t)
        preds = torch.softmax(t_logits, dim=-1)
        return loss, correct, bn, preds

    return learner


def _merge_bn(bn_batched: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Per-tenant BN running stats merged into one state: the mean over the
    tenant axis (the JAX package's documented deviation from the
    reference's last-task-wins)."""
    return {k: v.mean(dim=0) for k, v in bn_batched.items()}


def _split_microbatches(accum: int, *batches: Tensor) -> Tuple[Tensor, ...]:
    """Reshape each batch's leading task axis b -> (accum, b // accum)."""
    out = []
    for a in batches:
        b = a.shape[0]
        if b % accum != 0:
            raise ValueError(
                f"meta_accum_steps={accum} must divide the task batch "
                f"({b} tasks)"
            )
        out.append(a.reshape(accum, b // accum, *a.shape[1:]))
    return tuple(out)


def _meta_loss_and_grads(learner, state: MetaState, x_s, y_s, x_t, y_t,
                         loss_weights, accum: int = 1):
    """Outer loss and meta-gradients over the task batch.

    Returns ``(loss, correct, bns, grads)``: the task-mean loss, the
    per-sample correctness (b, way*targets), the per-tenant BN states
    (b, ...) and the task-mean meta-gradients ``{"net": {...}, "lslr":
    {...}}``. ``accum > 1`` runs the task axis in ``accum`` microbatches
    of ``b / accum`` tasks one after the other, each differentiated and
    freed before the next (the activation peak shrinks ~accum-fold), and
    adds their gradients in f32 before the one division by ``b`` —
    the same math as one pass, summed in another order.
    """
    leaves = {g: {k: v.detach().requires_grad_(True)
                  for k, v in getattr(state, g).items()} for g in GROUPS}
    flat = [v for g in GROUPS for v in leaves[g].values()]
    sums: List[Tensor] = [torch.zeros_like(v) for v in flat]
    losses, corrects, bns = [], [], []
    for xs, ys, xt, yt in zip(*_split_microbatches(accum, x_s, y_s, x_t,
                                                   y_t)):
        with torch.enable_grad():
            loss, correct, bn, _ = learner(
                leaves["net"], leaves["lslr"], state.bn, xs, ys, xt, yt,
                loss_weights,
            )
            grads = torch.autograd.grad(loss.sum(), flat, allow_unused=True)
        sums = [acc if g is None else acc + g for acc, g in zip(sums, grads)]
        losses.append(loss.detach())
        corrects.append(correct)
        bns.append(bn)
    b = x_s.shape[0]
    it = iter(s / b for s in sums)
    grads = {g: {k: next(it) for k in leaves[g]} for g in GROUPS}
    bns = {k: torch.cat([bn[k] for bn in bns]) for k in bns[0]}
    return torch.cat(losses).mean(), torch.cat(corrects), bns, grads


def make_grads_fn(cfg: MAMLConfig, second_order: bool,
                  block: Optional[vgg.BlockFn] = None):
    """``grads_fn(state, x_s, y_s, x_t, y_t, loss_weights) -> (loss,
    grads)``: the meta-gradient computation alone, no optimizer update —
    the surface the parity tests compare (Adam's normalisation would
    amplify round-off on near-zero gradients)."""
    learner = _task_learner(cfg, cfg.number_of_training_steps_per_iter,
                            second_order, block)

    def grads_fn(state: MetaState, x_s, y_s, x_t, y_t, loss_weights):
        loss, _, _, grads = _meta_loss_and_grads(
            learner, state, x_s, y_s, x_t, y_t, loss_weights,
            cfg.meta_accum_steps,
        )
        return loss, grads

    return grads_fn


def _decode_prelude(cfg: MAMLConfig, decode_uint8: Optional[bool]):
    """The on-card uint8 decode for ``data_placement='uint8_stream'``
    batches (None: follow the config), or None for f32 batches."""
    if decode_uint8 is None:
        decode_uint8 = cfg.data_placement == "uint8_stream"
    return device_pipeline.make_decoder(cfg) if decode_uint8 else None


def make_train_step(cfg: MAMLConfig, second_order: bool,
                    decode_uint8: Optional[bool] = None,
                    block: Optional[vgg.BlockFn] = None):
    """``train_step(state, x_s, y_s, x_t, y_t, loss_weights, lr) ->
    (state, metrics)``: the meta-gradients over the task batch, the +-10
    clamp on the net's gradients (imagenet datasets), Adam with the frozen
    leaves zeroed, ``p + (-lr) * update``, and the BN running stats merged
    over the tasks. ``state.opt`` must hold the Adam state
    (``init_state(..., with_opt=True)`` or a converted JAX state);
    ``metrics`` holds the task-mean ``loss`` and ``accuracy``. Under
    ``data_placement='uint8_stream'`` (or ``decode_uint8=True``) ``x_s`` and
    ``x_t`` arrive as uint8 and are decoded on the card first (one
    ``episode_expand`` launch each). ``block`` is ``vgg.apply``'s. The
    telemetry and health probes are not ported."""
    learner = _task_learner(cfg, cfg.number_of_training_steps_per_iter,
                            second_order, block)
    decode = _decode_prelude(cfg, decode_uint8)

    def train_step(state: MetaState, x_s, y_s, x_t, y_t, loss_weights, lr
                   ) -> Tuple[MetaState, Dict[str, Tensor]]:
        if decode is not None:
            x_s, x_t = decode(x_s), decode(x_t)
        if state.opt is None:
            raise ValueError(
                "train_step needs the Adam state: init_state(..., "
                "with_opt=True) or a converted training state"
            )
        loss, correct, bns, grads = _meta_loss_and_grads(
            learner, state, x_s, y_s, x_t, y_t, loss_weights,
            cfg.meta_accum_steps,
        )
        with torch.no_grad():
            if cfg.clip_grads:
                grads["net"] = {k: g.clamp(-10.0, 10.0)
                                for k, g in grads["net"].items()}
            opt = adam_lib.make_optimizer(cfg, state.net)
            updates, new_opt = opt.update(grads, state.opt)
            new = {g: {k: p + (-lr) * updates[g][k]
                       for k, p in getattr(state, g).items()}
                   for g in GROUPS}
        new_state = MetaState(
            net=new["net"], lslr=new["lslr"],
            bn=_merge_bn(bns) if state.bn else state.bn, opt=new_opt,
        )
        return new_state, {"loss": loss, "accuracy": correct.mean()}

    return train_step


def make_eval_step(cfg: MAMLConfig, decode_uint8: Optional[bool] = None,
                   block: Optional[vgg.BlockFn] = None):
    """``eval_step(state, x_s, y_s, x_t, y_t) -> (metrics, preds)``: first
    order, ``number_of_evaluation_steps_per_iter`` inner steps, only the
    final step's target loss, BN updates discarded. ``metrics`` holds the
    task-mean ``loss`` and ``accuracy``; ``preds`` (tasks, targets,
    classes) the final softmax. ``decode_uint8`` as ``make_train_step``'s."""
    num_steps = cfg.number_of_evaluation_steps_per_iter
    learner = _task_learner(cfg, num_steps, block=block)
    loss_weights = msl_lib.final_step_only(num_steps)
    decode = _decode_prelude(cfg, decode_uint8)

    def eval_step(state: MetaState, x_s, y_s, x_t, y_t):
        if decode is not None:
            x_s, x_t = decode(x_s), decode(x_t)
        with torch.no_grad():
            losses, correct, _, preds = learner(
                state.net, state.lslr, state.bn, x_s, y_s, x_t, y_t,
                loss_weights,
            )
            metrics = {"loss": losses.mean(), "accuracy": correct.mean()}
        return metrics, preds

    return eval_step


def _serve_outputs(losses: Tensor, correct: Tensor, preds: Tensor,
                   valid: Tensor) -> Dict[str, object]:
    """Per-tenant outputs plus the masked tenant-mean metrics: masked-out
    tenants contribute exactly zero, an all-masked dispatch reports 0 by
    the clamped denominator."""
    mask = valid.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    per_tenant_acc = correct.mean(dim=-1)
    return {
        "preds": preds,
        "loss": losses,
        "accuracy": per_tenant_acc,
        "metrics": {
            "loss": (losses.float() * mask).sum() / denom,
            "accuracy": (per_tenant_acc * mask).sum() / denom,
        },
    }


def make_serve_step(cfg: MAMLConfig, ingest: str = "f32",
                    block: Optional[vgg.BlockFn] = None):
    """``serve_step(state, x_s, y_s, x_t, y_t, valid) -> (state, out)``.

    Batches carry a leading tenant axis of the dispatch's bucket width;
    ``valid`` (bucket,) f32 is the metric mask (0 for pad tenants and
    label-free tenants). ``out`` holds ``preds`` (bucket, way*targets,
    classes) softmax in class-major query order, ``loss`` and ``accuracy``
    (bucket,), and the masked ``metrics``. The state passes through
    unchanged. The per-tenant math is ``make_eval_step``'s.

    ``ingest='uint8'`` takes uint8 pixels and decodes them on the card
    first (one ``episode_expand`` launch for ``x_s``, one for ``x_t``); the
    index ingest is ``make_serve_step_indexed``. ``block`` is
    ``vgg.apply``'s.
    """
    if ingest not in ("f32", "uint8"):
        raise ValueError(
            f"make_serve_step ingest must be 'f32' or 'uint8', got "
            f"{ingest!r} (the index ingest is make_serve_step_indexed)"
        )
    num_steps = cfg.number_of_evaluation_steps_per_iter
    learner = _task_learner(cfg, num_steps, block=block)
    loss_weights = msl_lib.final_step_only(num_steps)
    decode = device_pipeline.make_decoder(cfg) if ingest == "uint8" else None

    def serve_step(state: MetaState, x_s, y_s, x_t, y_t, valid
                   ) -> Tuple[MetaState, Dict[str, object]]:
        with torch.no_grad():
            if decode is not None:
                x_s, x_t = decode(x_s), decode(x_t)
            losses, correct, _, preds = learner(
                state.net, state.lslr, state.bn, x_s, y_s, x_t, y_t,
                loss_weights,
            )
            return state, _serve_outputs(losses, correct, preds, valid)

    return serve_step


def make_serve_step_indexed(cfg: MAMLConfig, shots: int,
                            block: Optional[vgg.BlockFn] = None):
    """``serve_step(state, store, gather, valid) -> (state, out)``: the
    index ingest. ``store`` is the registered (N, h, w, c) uint8 store on
    the card, ``gather`` the (bucket, way, shots + targets) int32 rows of
    each tenant's support then query; one ``episode_expand`` launch turns
    them into the f32 batch, labels are the class slots (sample (i, j) has
    label i), and ``out`` is ``make_serve_step``'s."""
    step = make_serve_step(cfg, block=block)
    expand = device_pipeline.make_serve_expander(cfg, shots)

    def serve_step(state: MetaState, store, gather, valid):
        return step(state, *expand(store, gather), valid)

    return serve_step


def make_train_step_indexed(cfg: MAMLConfig, second_order: bool,
                            augment: bool, store_mesh=None,
                            block: Optional[vgg.BlockFn] = None):
    """``train_step(state, store, gather, rot_k, loss_weights, lr) ->
    (state, metrics)``: ``make_train_step`` behind the on-card episode
    expansion (``data_placement='device'``). ``store`` is the split's
    (N, h, w, c) uint8 store on the card, ``gather`` (tasks, way, spc +
    nts) and ``rot_k`` (tasks, way) int32; ``augment`` rotates train-time
    Omniglot. A store sharded over hosts (``store_mesh``) comes with
    ``parallel/`` (ROADMAP Queue A)."""
    step = make_train_step(cfg, second_order, decode_uint8=False,
                           block=block)
    expand = device_pipeline.make_index_expander(cfg, augment, store_mesh)

    def train_step(state: MetaState, store, gather, rot_k, loss_weights, lr):
        return step(state, *expand(store, gather, rot_k), loss_weights, lr)

    return train_step


def make_eval_step_indexed(cfg: MAMLConfig, augment: bool = False,
                           store_mesh=None,
                           block: Optional[vgg.BlockFn] = None):
    """``eval_step(state, store, gather, rot_k) -> (metrics, preds)``: the
    evaluation twin of ``make_train_step_indexed``."""
    step = make_eval_step(cfg, decode_uint8=False, block=block)
    expand = device_pipeline.make_index_expander(cfg, augment, store_mesh)

    def eval_step(state: MetaState, store, gather, rot_k):
        return step(state, *expand(store, gather, rot_k))

    return eval_step


def _stack_metrics(metrics: List[Dict[str, Tensor]]) -> Dict[str, Tensor]:
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def _stack_outputs(outs, with_preds: bool):
    """(stacked metrics, stacked preds or None) of k eval steps."""
    preds = torch.stack([p for _, p in outs]) if with_preds else None
    return _stack_metrics([m for m, _ in outs]), preds


def make_train_multi_step(cfg: MAMLConfig, second_order: bool,
                          block: Optional[vgg.BlockFn] = None):
    """``multi_step(state, x_s, y_s, x_t, y_t, loss_weights, lr) ->
    (state, metrics)``: ``make_train_step`` over the leading k axis of
    every batch argument, in order (``steps_per_dispatch``); the metrics
    come back stacked (k,). The same math as k separate calls."""
    step = make_train_step(cfg, second_order, block=block)

    def multi_step(state, x_s, y_s, x_t, y_t, loss_weights, lr):
        metrics = []
        for batch in zip(x_s, y_s, x_t, y_t):
            state, m = step(state, *batch, loss_weights, lr)
            metrics.append(m)
        return state, _stack_metrics(metrics)

    return multi_step


def make_eval_multi_step(cfg: MAMLConfig, with_preds: bool = False,
                         block: Optional[vgg.BlockFn] = None):
    """``multi_eval(state, x_s, y_s, x_t, y_t) -> (metrics, preds)``:
    ``make_eval_step`` over the leading k axis (``eval_batches_per_
    dispatch``); metrics stacked (k,), preds (k, tasks, targets, classes)
    only ``with_preds`` (the test ensemble), else None."""
    step = make_eval_step(cfg, block=block)

    def multi_eval(state, x_s, y_s, x_t, y_t):
        return _stack_outputs([step(state, *batch) for batch in
                               zip(x_s, y_s, x_t, y_t)], with_preds)

    return multi_eval


def make_train_multi_step_indexed(cfg: MAMLConfig, second_order: bool,
                                  augment: bool, store_mesh=None,
                                  block: Optional[vgg.BlockFn] = None):
    """``multi_step(state, store, gather, rot_k, loss_weights, lr)``: the
    ``steps_per_dispatch`` form of ``make_train_step_indexed`` over a
    leading k axis of ``gather`` and ``rot_k``; the resident store is the
    same for every step."""
    step = make_train_step_indexed(cfg, second_order, augment, store_mesh,
                                   block)

    def multi_step(state, store, gather, rot_k, loss_weights, lr):
        metrics = []
        for g, r in zip(gather, rot_k):
            state, m = step(state, store, g, r, loss_weights, lr)
            metrics.append(m)
        return state, _stack_metrics(metrics)

    return multi_step


def make_eval_multi_step_indexed(cfg: MAMLConfig, with_preds: bool = False,
                                 augment: bool = False, store_mesh=None,
                                 block: Optional[vgg.BlockFn] = None):
    """``multi_eval(state, store, gather, rot_k) -> (metrics, preds)``: the
    ``eval_batches_per_dispatch`` form of ``make_eval_step_indexed`` (the
    stacking of ``make_eval_multi_step``)."""
    step = make_eval_step_indexed(cfg, augment, store_mesh, block)

    def multi_eval(state, store, gather, rot_k):
        return _stack_outputs([step(state, store, g, r) for g, r in
                               zip(gather, rot_k)], with_preds)

    return multi_eval
