"""Optimizers and epoch-stepped LR schedulers under the torch class names
the configs use (counterpart of waveformml_tpu/optim.py).

``optim.SGD`` is ``torch.optim.SGD`` (its momentum buffer, nesterov and L2
weight decay are what the JAX package's optax chain reproduces).
``lr_scheduler.ExponentialLR`` is ``torch.optim.lr_scheduler.ExponentialLR``;
stepped once per epoch, as the JAX scheduler is, it gives ``lr =
base·γ^epoch``. Other optimizers and schedulers are not ported yet: asking
for one raises.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch
from torch.optim.lr_scheduler import ExponentialLR

from waveformml_tpu_torch.registry import registry


def _sgd(parameters: Iterable[torch.nn.Parameter], lr: float, momentum: float = 0.0,
         weight_decay: float = 0.0, dampening: float = 0.0,
         nesterov: bool = False) -> torch.optim.SGD:
    if nesterov and (dampening or not momentum):
        raise ValueError("nesterov momentum requires a momentum and zero "
                         "dampening (torch.optim.SGD contract)")
    return torch.optim.SGD(parameters, lr=lr, momentum=momentum, dampening=dampening,
                           weight_decay=weight_decay, nesterov=nesterov)


registry.register("optim.SGD", aliases=("SGD",))(_sgd)
registry.register("lr_scheduler.ExponentialLR", aliases=("ExponentialLR",))(ExponentialLR)


def build_optimizer(name: str, parameters: Iterable[torch.nn.Parameter], lr: float,
                    params: Optional[Dict[str, Any]] = None) -> torch.optim.Optimizer:
    """The optimizer of config ``optimizer_class`` over ``parameters``."""
    fn = registry.lookup(name)
    if fn is not _sgd:
        raise KeyError(f"optimizer {name!r} is not ported; the port has optim.SGD")
    return fn(parameters, lr, **dict(params or {}))


def build_scheduler(name: Optional[str], optimizer: torch.optim.Optimizer,
                    params: Optional[Dict[str, Any]] = None) -> Optional[ExponentialLR]:
    """The scheduler of config ``scheduler_class`` over the optimizer's lr,
    or None without one."""
    if not name:
        return None
    if registry.lookup(name) is not ExponentialLR:
        raise KeyError(f"scheduler {name!r} is not ported; the port has "
                       f"lr_scheduler.ExponentialLR")
    return ExponentialLR(optimizer, **dict(params or {}))
