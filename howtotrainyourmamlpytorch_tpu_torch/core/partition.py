"""Parameter partitioning: inner-loop-adapted vs frozen, trainable vs not.

A copy of the JAX package's ``core/partition.py``: predicates over the
flat parameter names replace the reference's name-string filtering.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import MAMLConfig

Params = Dict[str, torch.Tensor]


def is_norm_param(name: str) -> bool:
    return ".norm." in name


def is_inner_adapted(cfg: MAMLConfig, name: str) -> bool:
    """Whether the inner loop updates a parameter: norm parameters only
    with ``enable_inner_loop_optimizable_bn_params``, and never the frozen
    layer-norm gamma."""
    if not is_norm_param(name):
        return True
    if not cfg.enable_inner_loop_optimizable_bn_params:
        return False
    if cfg.norm_layer == "layer_norm" and name.endswith(".gamma"):
        return False
    return True


def is_trainable(cfg: MAMLConfig, name: str) -> bool:
    """Whether the outer (Adam) optimizer updates a parameter: BN
    gamma/beta by ``learnable_bn_gamma``/``learnable_bn_beta``, layer-norm
    gamma never, layer-norm beta and conv/linear always."""
    if not is_norm_param(name):
        return True
    if name.endswith(".gamma"):
        if cfg.norm_layer == "layer_norm":
            return False
        return cfg.learnable_bn_gamma
    if name.endswith(".beta"):
        if cfg.norm_layer == "layer_norm":
            return True
        return cfg.learnable_bn_beta
    return True


def trainable_labels(cfg: MAMLConfig, params: Params) -> Dict[str, str]:
    """'train'/'freeze' labels over the net params (the outer optimizer's
    partition)."""
    return {
        k: ("train" if is_trainable(cfg, k) else "freeze") for k in params
    }


def split_inner(cfg: MAMLConfig, params: Params) -> Tuple[Params, Params]:
    """Partition net params into (adapted, frozen) flat dicts."""
    adapted = {k: v for k, v in params.items() if is_inner_adapted(cfg, k)}
    frozen = {k: v for k, v in params.items() if not is_inner_adapted(cfg, k)}
    return adapted, frozen
