"""Multi-Step Loss (MSL) importance schedule — MAML++'s per-step loss
weights. A copy of the JAX package's ``core/msl.py`` (numpy only)."""

from __future__ import annotations

import numpy as np


def per_step_loss_importance(
    num_steps: int, multi_step_loss_num_epochs: int, epoch: int
) -> np.ndarray:
    """The annealed per-step weights at a given (integer) epoch."""
    loss_weights = np.ones(num_steps, dtype=np.float32) / num_steps
    decay_rate = 1.0 / num_steps / multi_step_loss_num_epochs
    min_non_final = 0.03 / num_steps
    for i in range(num_steps - 1):
        loss_weights[i] = np.maximum(
            loss_weights[i] - epoch * decay_rate, min_non_final
        )
    loss_weights[-1] = np.minimum(
        loss_weights[-1] + epoch * (num_steps - 1) * decay_rate,
        1.0 - (num_steps - 1) * min_non_final,
    )
    return loss_weights


def final_step_only(num_steps: int) -> np.ndarray:
    """One-hot on the last step: the non-MSL / eval / serving weights."""
    w = np.zeros(num_steps, dtype=np.float32)
    w[-1] = 1.0
    return w


def loss_weights_for(
    num_steps: int,
    use_msl: bool,
    training: bool,
    epoch: int,
    multi_step_loss_num_epochs: int,
) -> np.ndarray:
    """The weight vector for a given phase/epoch, gate included."""
    if use_msl and training and epoch < multi_step_loss_num_epochs:
        return per_step_loss_importance(num_steps, multi_step_loss_num_epochs, epoch)
    return final_step_only(num_steps)
