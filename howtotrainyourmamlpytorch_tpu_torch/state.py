"""The meta-state: parameters, LSLR learning rates, BN statistics and the
outer optimizer's Adam state.

The port of the JAX package's ``MetaState`` (``core/maml.py:52-62``) and
``init_state`` (:100-117): the same flat dicts with the same keys, shapes
and dtypes, as tensors. ``opt`` is ``None`` for a state that only serves.
``from_numpy`` takes a JAX package state brought to the host
(``jax.device_get(state)``: the same structure with numpy leaves, its Adam
moments inside optax's ``multi_transform`` state), a state that
``to_numpy`` wrote, or any object or dict with ``net`` / ``lslr`` / ``bn``
(and optionally ``opt``), so a snapshot taken mid-training crosses between
the packages leaf by leaf and the training continues.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from .config import MAMLConfig
from .core import adam as adam_lib
from .core import lslr as lslr_lib
from .core import partition
from .device import DeviceLike, resolve_device
from .models import vgg


class MetaState(NamedTuple):
    net: Dict[str, torch.Tensor]
    lslr: Dict[str, torch.Tensor]
    bn: Dict[str, torch.Tensor]
    opt: Optional[adam_lib.AdamState] = None


def init_state(cfg: MAMLConfig, seed: Optional[int] = None,
               device: DeviceLike = None, with_opt: bool = False
               ) -> MetaState:
    """Fresh parameters, LSLR vectors and BN statistics, and with
    ``with_opt`` a fresh Adam state (zero moments, count 0).

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
    opt = None
    if with_opt:
        opt = adam_lib.make_optimizer(cfg, params).init(
            {"net": params, "lslr": lslr_params})
    return MetaState(net=params, lslr=lslr_params, bn=bn_state, opt=opt)


def _field(state: Any, name: str):
    if isinstance(state, dict):
        return state.get(name)
    return getattr(state, name, None)


def _adam_of(opt: Any) -> Optional[Any]:
    """The ``(count, mu, nu)`` holder inside a host Adam state: the port's
    ``AdamState``, or the ``ScaleByAdamState`` inside the JAX package's
    ``multi_transform`` state (its 'train' partition)."""
    if opt is None or hasattr(opt, "mu"):
        return opt
    for inner in getattr(opt, "inner_states", {}).values():
        inner = getattr(inner, "inner_state", inner)
        if hasattr(inner, "mu"):
            return inner
    raise ValueError(f"no Adam moments found in the opt state {type(opt)}")


def _map_state(state: MetaState, fn: Callable[[Any], Any]) -> MetaState:
    """``state`` with ``fn`` applied to every leaf (the Adam state's too)."""
    opt = state.opt
    if opt is not None:
        opt = adam_lib.AdamState(
            fn(opt.count),
            *({g: {k: fn(v) for k, v in leaves.items()}
               for g, leaves in moments.items()}
              for moments in (opt.mu, opt.nu)),
        )
    return MetaState(
        *({k: fn(v) for k, v in part.items()}
          for part in (state.net, state.lslr, state.bn)),
        opt=opt,
    )


def from_numpy(state: Any, device: DeviceLike = None) -> MetaState:
    """A host state (numpy leaves) as a ``MetaState`` of tensors on
    ``device`` (``cuda:0`` unless named): same keys, shapes and dtypes,
    copied. The Adam moments of the leaves the JAX package masks out
    (its frozen leaves) are not carried: the port holds none for them."""
    device = resolve_device(device)
    adam = _adam_of(_field(state, "opt"))
    opt = None
    if adam is not None:
        opt = adam_lib.AdamState(
            adam.count,
            *({g: {k: v for k, v in leaves.items() if hasattr(v, "shape")}
               for g, leaves in moments.items()}
              for moments in (adam.mu, adam.nu)),
        )
    host = MetaState(_field(state, "net"), _field(state, "lslr"),
                     _field(state, "bn"), opt)
    return _map_state(
        host, lambda v: torch.from_numpy(np.array(v, copy=True)).to(device))


def to_numpy(state: MetaState) -> MetaState:
    """A ``MetaState`` with numpy leaves on the host."""
    return _map_state(state, lambda v: v.detach().cpu().numpy())


def to_device(state: MetaState, device: torch.device,
              dtype: Optional[torch.dtype] = None) -> MetaState:
    """A private copy of ``state`` on ``device``, its floating leaves in
    ``dtype`` when one is named (f64 for a reference run)."""
    return _map_state(state, lambda v: v.detach().to(
        device, dtype if dtype and v.is_floating_point() else v.dtype,
        copy=True))
