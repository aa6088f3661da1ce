"""Parameter partitioning: inner-loop-adapted vs frozen.

The part of the JAX package's ``core/partition.py`` that serving needs: a
predicate over the flat parameter names replaces the reference's
name-string filtering. The trainability labels come with training.
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


def split_inner(cfg: MAMLConfig, params: Params) -> Tuple[Params, Params]:
    """Partition net params into (adapted, frozen) flat dicts."""
    adapted = {k: v for k, v in params.items() if is_inner_adapted(cfg, k)}
    frozen = {k: v for k, v in params.items() if not is_inner_adapted(cfg, k)}
    return adapted, frozen
