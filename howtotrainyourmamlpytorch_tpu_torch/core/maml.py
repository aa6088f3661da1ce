"""The first-order adapt-then-predict learner and the serving/eval steps.

The port of the JAX package's ``core/maml.py`` for the serving slice:
``_task_learner`` (first order), ``make_eval_step``, ``_serve_outputs`` and
``make_serve_step`` (f32 ingest). The JAX package maps one task learner
over the task axis with ``vmap``; here the TENANT axis is a batch
dimension written out: every adapted parameter is cloned per tenant, and
each tenant's batch-norm statistics reduce over its own images only.

Per inner step (as ``_task_learner``'s ``inner_step``): the support
forward, the support gradient of the SUM over tenants of each tenant's
mean loss (a mean over tenants would scale every tenant's gradient by
1/T), the LSLR update with the inner gradient cut from the graph (first
order), then the target forward with the updated weights at the same BN
step. The target forwards run under ``torch.no_grad()``: serving never
differentiates them. Every step's target loss is kept and weighted by
``msl.final_step_only``, exactly as the JAX package does.

The training slice (second order, Adam, MSL, ``_merge_bn``) is not ported
yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import MAMLConfig
from ..models import vgg
from ..ops import functional as F
from ..state import MetaState
from . import lslr as lslr_lib
from . import msl as msl_lib
from . import partition

Tensor = torch.Tensor


def _task_learner(cfg: MAMLConfig, num_steps: int,
                  block: Optional[vgg.BlockFn] = None):
    """The tenant-batched, first-order task learner.

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
        adapted, frozen = partition.split_inner(cfg, net)
        theta = {
            k: v.detach().unsqueeze(0).expand(n_tenants, *v.shape).clone()
            for k, v in adapted.items()
        }
        bn = bn_state
        t_losses = []
        t_logits = None
        for step in range(num_steps):
            for v in theta.values():
                v.requires_grad_(True)
            with torch.enable_grad():
                logits, bn = vgg.apply(cfg, {**frozen, **theta}, bn, x_s,
                                       step, block=block)
                support_loss = F.cross_entropy(logits, y_s).sum()
                grads = torch.autograd.grad(support_loss,
                                            list(theta.values()))
            with torch.no_grad():
                grads = dict(zip(theta.keys(), grads))
                if cfg.inner_loop_optimizer == "sgd":
                    theta = lslr_lib.sgd_update_params(theta, grads,
                                                       cfg.inner_lr_init)
                else:
                    theta = lslr_lib.update_params(theta, grads,
                                                   lslr_params, step)
                t_logits, bn = vgg.apply(cfg, {**frozen, **theta}, bn, x_t,
                                         step, block=block)
                t_losses.append(F.cross_entropy(t_logits, y_t))
        weights = torch.as_tensor(loss_weights, dtype=torch.float32,
                                  device=x_s.device)
        loss = torch.stack(t_losses, dim=-1) @ weights
        correct = F.accuracy(t_logits, y_t)
        preds = torch.softmax(t_logits, dim=-1)
        return loss, correct, bn, preds

    return learner


def make_eval_step(cfg: MAMLConfig, block: Optional[vgg.BlockFn] = None):
    """``eval_step(state, x_s, y_s, x_t, y_t) -> (metrics, preds)``: first
    order, ``number_of_evaluation_steps_per_iter`` inner steps, only the
    final step's target loss, BN updates discarded. ``metrics`` holds the
    task-mean ``loss`` and ``accuracy``; ``preds`` (tasks, targets,
    classes) the final softmax."""
    num_steps = cfg.number_of_evaluation_steps_per_iter
    learner = _task_learner(cfg, num_steps, block)
    loss_weights = msl_lib.final_step_only(num_steps)

    def eval_step(state: MetaState, x_s, y_s, x_t, y_t):
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


def make_serve_step(cfg: MAMLConfig, block: Optional[vgg.BlockFn] = None):
    """``serve_step(state, x_s, y_s, x_t, y_t, valid) -> (state, out)``.

    Batches carry a leading tenant axis of the dispatch's bucket width;
    ``valid`` (bucket,) f32 is the metric mask (0 for pad tenants and
    label-free tenants). ``out`` holds ``preds`` (bucket, way*targets,
    classes) softmax in class-major query order, ``loss`` and ``accuracy``
    (bucket,), and the masked ``metrics``. The state passes through
    unchanged. The per-tenant math is ``make_eval_step``'s.

    Only the f32 ingest is ported (the uint8 decode and index gather are
    ROADMAP Queue B6); ``block`` is ``vgg.apply``'s.
    """
    num_steps = cfg.number_of_evaluation_steps_per_iter
    learner = _task_learner(cfg, num_steps, block)
    loss_weights = msl_lib.final_step_only(num_steps)

    def serve_step(state: MetaState, x_s, y_s, x_t, y_t, valid
                   ) -> Tuple[MetaState, Dict[str, object]]:
        with torch.no_grad():
            losses, correct, _, preds = learner(
                state.net, state.lslr, state.bn, x_s, y_s, x_t, y_t,
                loss_weights,
            )
            return state, _serve_outputs(losses, correct, preds, valid)

    return serve_step
