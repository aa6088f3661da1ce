"""LSLR — per-parameter, per-step learnable inner-loop learning rates.

The JAX package's ``core/lslr.py``: one ``(num_inner_steps + 1,)`` learning
rate vector per inner-adapted parameter, and the update
``theta - lr[name][step] * grad``. The step index is clamped to the vector,
as JAX's gather clamps an out-of-range index (evaluation may run more
inner steps than training sized the vectors for).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

LSLRParams = Dict[str, torch.Tensor]


def init(adapted_param_names: Iterable[str], num_inner_steps: int,
         init_learning_rate: float,
         device: Optional[torch.device] = None) -> LSLRParams:
    """One (num_inner_steps + 1,) f32 LR vector per adapted parameter."""
    return {
        name: torch.full((num_inner_steps + 1,), init_learning_rate,
                         dtype=torch.float32, device=device)
        for name in adapted_param_names
    }


def update_params(weights: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], lslr: LSLRParams,
                  num_step: int) -> Dict[str, torch.Tensor]:
    """theta' = theta - lr[name][step] * g, the step clamped into range."""
    out = {}
    for key, w in weights.items():
        lr = lslr[key]
        out[key] = w - lr[min(max(int(num_step), 0), lr.shape[0] - 1)] * grads[key]
    return out


def sgd_update_params(weights: Dict[str, torch.Tensor],
                      grads: Dict[str, torch.Tensor],
                      learning_rate: float) -> Dict[str, torch.Tensor]:
    """Plain fixed-LR gradient descent: theta' = theta - eta * g."""
    return {key: weights[key] - learning_rate * grads[key] for key in weights}
