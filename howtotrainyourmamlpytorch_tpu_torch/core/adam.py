"""The outer optimizer: a functional Adam over the meta-parameters
``{"net": {...}, "lslr": {...}}``.

The JAX package's ``core/maml.py::make_optimizer`` is optax's
``multi_transform`` of ``scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)`` on the
'train' leaves and ``set_to_zero`` on the 'freeze' leaves; the update is
the raw Adam direction, which the train step scales by ``-lr`` and adds.
This module is that transform written out over the port's flat dicts, in
optax's order of operations: ``torch.optim.Adam`` keys its state by
parameter object and folds the learning rate in, whereas here the state is
keyed by parameter name (a JAX state carries over leaf by leaf, see
``state.from_numpy``), frozen leaves hold no moments and get a zero
update, and one shared ``count`` (int32) drives the bias corrections.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from ..config import MAMLConfig
from . import partition

Tensor = torch.Tensor
#: ``{"net": {name: tensor}, "lslr": {name: tensor}}``
Groups = Dict[str, Dict[str, Tensor]]

B1 = 0.9
B2 = 0.999
EPS = 1e-8
_INT32_MAX = 2 ** 31 - 1


class AdamState(NamedTuple):
    count: Tensor  # int32 scalar: updates taken (optax's safe increment)
    mu: Groups     # first moments of the 'train' leaves only
    nu: Groups     # second moments of the 'train' leaves only


class Adam:
    """``init(trainable) -> AdamState`` and ``update(grads, state) ->
    (updates, state)`` for the labels ``{"net": {name: "train" |
    "freeze"}, "lslr": {...}}``."""

    def __init__(self, labels: Dict[str, Dict[str, str]]):
        self.labels = labels

    def _train(self, group: str, name: str) -> bool:
        return self.labels[group][name] == "train"

    def init(self, trainable: Groups) -> AdamState:
        def zeros():
            return {g: {k: torch.zeros_like(v) for k, v in leaves.items()
                        if self._train(g, k)}
                    for g, leaves in trainable.items()}

        device = next(iter(trainable["net"].values())).device
        return AdamState(torch.zeros((), dtype=torch.int32, device=device),
                         zeros(), zeros())

    def update(self, grads: Groups, state: AdamState):
        count = torch.clamp(state.count + 1, max=_INT32_MAX).to(torch.int32)
        one = torch.ones((), dtype=torch.float32, device=count.device)
        corr1 = one - torch.pow(one * B1, count)
        corr2 = one - torch.pow(one * B2, count)
        updates: Groups = {}
        mu: Groups = {}
        nu: Groups = {}
        for group, leaves in grads.items():
            updates[group], mu[group], nu[group] = {}, {}, {}
            for name, g in leaves.items():
                if not self._train(group, name):
                    updates[group][name] = torch.zeros_like(g)
                    continue
                m = (1 - B1) * g + B1 * state.mu[group][name]
                v = (1 - B2) * (g * g) + B2 * state.nu[group][name]
                mu[group][name], nu[group][name] = m, v
                updates[group][name] = (m / corr1) / (torch.sqrt(v / corr2)
                                                      + EPS)
        return updates, AdamState(count, mu, nu)


def make_optimizer(cfg: MAMLConfig, params: Dict[str, Any]) -> Adam:
    """Adam over ``{net, lslr}`` with the frozen leaves zeroed: net leaves
    by ``partition.trainable_labels``, the LSLR vectors trainable when they
    are learnable and the inner optimizer is not plain SGD."""
    lslr_label = (
        "train" if cfg.learnable_per_layer_per_step_inner_loop_learning_rate
        and cfg.inner_loop_optimizer != "sgd" else "freeze"
    )
    return Adam({
        "net": partition.trainable_labels(cfg, params),
        "lslr": {k: lslr_label
                 for k in partition.split_inner(cfg, params)[0]},
    })
