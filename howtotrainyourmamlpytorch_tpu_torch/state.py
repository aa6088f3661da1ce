"""The servable meta-state: parameters, LSLR learning rates, BN statistics.

The port of the JAX package's ``MetaState`` (``core/maml.py:52-62``) and
``init_state`` (:100-117) for serving: the same three flat dicts with the
same keys, shapes and dtypes, as tensors. The Adam state comes with the
training slice. ``from_numpy`` takes a JAX package state brought to the
host (``jax.device_get(state)``: the same structure with numpy leaves) or
any object or dict with ``net`` / ``lslr`` / ``bn``, and ``to_numpy``
converts back, so a snapshot crosses between the packages leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from .config import MAMLConfig
from .core import lslr as lslr_lib
from .core import partition
from .device import DeviceLike, resolve_device
from .models import vgg


class MetaState(NamedTuple):
    net: Dict[str, torch.Tensor]
    lslr: Dict[str, torch.Tensor]
    bn: Dict[str, torch.Tensor]


def init_state(cfg: MAMLConfig, seed: Optional[int] = None,
               device: DeviceLike = None) -> MetaState:
    """Fresh parameters, LSLR vectors and BN statistics.

    Seeded like the JAX package: the model seed is drawn from
    ``RandomState(cfg.seed)`` (or ``seed``) and seeds a ``torch.Generator``.
    The streams differ from JAX's, so tests convert JAX states with
    ``from_numpy`` instead of comparing inits. Runs on ``cuda:0`` unless
    ``device`` names another device.
    """
    device = resolve_device(device)
    rng = np.random.RandomState(cfg.seed if seed is None else seed)
    gen = torch.Generator().manual_seed(int(rng.randint(0, 999999)))
    params, bn_state = vgg.init(cfg, gen, device)
    adapted, _ = partition.split_inner(cfg, params)
    lslr_params = lslr_lib.init(
        sorted(adapted.keys()), cfg.number_of_training_steps_per_iter,
        cfg.inner_lr_init, device,
    )
    return MetaState(net=params, lslr=lslr_params, bn=bn_state)


def _field(state: Any, name: str):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def from_numpy(state: Any, device: DeviceLike = None) -> MetaState:
    """A host state (numpy leaves) as a ``MetaState`` of tensors on
    ``device`` (``cuda:0`` unless named): same keys, shapes and dtypes,
    copied. Extra fields of the source (the JAX package's ``opt``) are
    not read."""
    device = resolve_device(device)
    return MetaState(*(
        {k: torch.from_numpy(np.array(v, copy=True)).to(device)
         for k, v in _field(state, name).items()}
        for name in MetaState._fields
    ))


def to_numpy(state: MetaState) -> MetaState:
    """A ``MetaState`` with numpy leaves on the host."""
    return MetaState(*(
        {k: v.detach().cpu().numpy() for k, v in part.items()}
        for part in state
    ))


def to_device(state: MetaState, device: torch.device) -> MetaState:
    """A private copy of ``state`` on ``device``."""
    return MetaState(*(
        {k: v.detach().to(device, copy=True) for k, v in part.items()}
        for part in state
    ))
