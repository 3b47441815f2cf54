"""Optimizers and epoch-stepped LR schedulers under the torch class names
the configs use (counterpart of waveformml_tpu/optim.py).

The optimizers step as the JAX package's optax chains do
(tests/test_torch_optim.py holds them to it):

* ``optim.SGD`` is ``torch.optim.SGD``: L2 weight decay added to the
  gradient, the momentum buffer undampened on its first step and ``μ·buf +
  (1 - dampening)·g`` after it, nesterov's look-ahead;
* ``optim.Adam`` and ``optim.AdamW`` are ``Adam`` below, optax's
  arithmetic (``torch.optim.Adam``'s bias correction differs): L2 weight
  decay added to the gradient before the moments, or decoupled, ``wd·p``
  added to the update after them;
* ``optim.RMSprop`` is ``torch.optim.RMSprop``: eps outside the square
  root, the momentum buffer traced after the scaling.

The schedulers are the JAX package's own closed forms, stepped once per
epoch by the trainer, which writes ``lr()`` into every parameter group
(``set_learning_rate``); ``torch.optim.lr_scheduler`` differs (a recursive
cosine, an eps rule in its plateau scheduler). ``clip_by_global_norm_`` and
``MultiSteps`` are the optax transforms the JAX ``Trainer`` chains in front
of the optimizer for ``gradient_clip_val`` and ``accumulate_grad_batches``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from waveformml_tpu_torch.registry import registry


# ---------------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------------

def _sgd(parameters: Iterable[torch.nn.Parameter], lr: float, momentum: float = 0.0,
         weight_decay: float = 0.0, dampening: float = 0.0,
         nesterov: bool = False) -> torch.optim.SGD:
    if nesterov and (dampening or not momentum):
        raise ValueError("nesterov momentum requires a momentum and zero "
                         "dampening (torch.optim.SGD contract)")
    return torch.optim.SGD(parameters, lr=lr, momentum=momentum, dampening=dampening,
                           weight_decay=weight_decay, nesterov=nesterov)


class Adam(torch.optim.Optimizer):
    """Adam as optax's ``scale_by_adam`` chain computes it over float32
    parameters: ``mu = (1 - b1)·g + b1·mu``, ``nu = (1 - b2)·g² +
    b2·nu``, each bias-corrected by ``1 - b^t`` taken in float32 (which
    for b2 = 0.999 is 1.3e-5 off the exact value at t = 1, as the JAX
    package's is; ``torch.optim.Adam`` takes it in double), ``u =
    mu_hat / (sqrt(nu_hat) + eps)``, ``p += -lr·u``. ``weight_decay`` is L2
    (``g + wd·p`` before the moments) or, with ``decoupled`` (AdamW),
    ``u + wd·p`` after them."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = False):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, decoupled=decoupled))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            wd, decoupled = group["weight_decay"], group["decoupled"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                if wd and not decoupled:
                    g = g + wd * p
                state["step"] += 1
                mu = state["mu"].copy_((1 - b1) * g + b1 * state["mu"])
                nu = state["nu"].copy_((1 - b2) * (g * g) + b2 * state["nu"])
                # in float32, the parameters' dtype
                t = np.float32(state["step"])
                bc1 = float(np.float32(1) - np.float32(b1) ** t)
                bc2 = float(np.float32(1) - np.float32(b2) ** t)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + group["eps"])
                if wd and decoupled:
                    u = u + wd * p
                p.add_(u * -group["lr"])
        return loss


def _adam(parameters: Iterable[torch.nn.Parameter], lr: float, betas=(0.9, 0.999),
          eps: float = 1e-8, weight_decay: float = 0.0) -> Adam:
    return Adam(parameters, lr, betas, eps, weight_decay)


def _adamw(parameters: Iterable[torch.nn.Parameter], lr: float, betas=(0.9, 0.999),
           eps: float = 1e-8, weight_decay: float = 0.01) -> Adam:
    return Adam(parameters, lr, betas, eps, weight_decay, decoupled=True)


def _rmsprop(parameters: Iterable[torch.nn.Parameter], lr: float, alpha: float = 0.99,
             eps: float = 1e-8, weight_decay: float = 0.0,
             momentum: float = 0.0) -> torch.optim.RMSprop:
    return torch.optim.RMSprop(parameters, lr=lr, alpha=alpha, eps=eps,
                               weight_decay=weight_decay, momentum=momentum)


for _name, _fn in (("SGD", _sgd), ("Adam", _adam), ("AdamW", _adamw), ("RMSprop", _rmsprop)):
    registry.register(f"optim.{_name}", aliases=(_name,))(_fn)
_OPTIMIZERS = (_sgd, _adam, _adamw, _rmsprop)


def build_optimizer(name: str, parameters: Iterable[torch.nn.Parameter], lr: float,
                    params: Optional[Dict[str, Any]] = None) -> torch.optim.Optimizer:
    """The optimizer of config ``optimizer_class`` over ``parameters``."""
    fn = registry.lookup(name)
    if fn not in _OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}")
    return fn(parameters, lr, **dict(params or {}))


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Write ``lr`` into every parameter group (an epoch scheduler step)."""
    for group in optimizer.param_groups:
        group["lr"] = lr


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sharded: Optional[Sequence[bool]] = None,
                         group=None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: ``g / ‖g‖ · max_norm`` for every
    gradient where the global norm ‖g‖ (over all of them) is at least
    ``max_norm``, else ``g`` as it is. Returns the global norm (a device
    scalar: nothing waits for the device).

    Under tensor parallelism ``sharded[i]`` says that ``grads[i]`` is this
    rank's block of a gradient sharded over the model group ``group``: the
    blocks' squares are summed over the group, so that each sharded
    gradient counts once whole, and each replicated one once."""
    if group is None:
        norm = torch.sqrt(sum(g.pow(2).sum() for g in grads))
    else:
        import torch.distributed as dist

        squares = [g.pow(2).sum() for g in grads]
        blocks = torch.stack([s for s, b in zip(squares, sharded) if b] or
                             [grads[0].new_zeros(())]).sum()
        dist.all_reduce(blocks, group=group)
        norm = torch.sqrt(blocks + sum(s for s, b in zip(squares, sharded) if not b))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class MultiSteps:
    """optax.MultiSteps: the running mean of ``k`` micro-steps' gradients,
    ``acc + (g - acc) / (i + 1)`` at micro-step i, handed on at the k-th and
    reset. The count runs on across epochs: a micro-step left over at an
    epoch's end is carried into the next."""

    def __init__(self, parameters: Iterable[torch.nn.Parameter], k: int):
        self.k = k
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in parameters]

    def update(self, grads: List[torch.Tensor]) -> Optional[List[torch.Tensor]]:
        """Fold one micro-step's gradients in; the mean at the k-th, else None."""
        for a, g in zip(self.acc, grads):
            a.add_((g - a) / (self.mini_step + 1))
        if self.mini_step < self.k - 1:
            self.mini_step += 1
            return None
        self.mini_step = 0
        mean = [a.clone() for a in self.acc]
        for a in self.acc:
            a.zero_()
        return mean

    def state_dict(self) -> Dict[str, Any]:
        return {"mini_step": self.mini_step, "acc": [a.clone() for a in self.acc]}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.mini_step = d["mini_step"]
        for a, saved in zip(self.acc, d["acc"]):
            a.copy_(saved)


# ---------------------------------------------------------------------------------
# epoch schedulers
# ---------------------------------------------------------------------------------

class Scheduler:
    """lr as a closed form of the epoch, stepped once per epoch."""

    def __init__(self, base_lr: float, **kwargs):
        self.base_lr = base_lr
        self.epoch = 0

    def step(self, metric: Optional[float] = None) -> float:
        """Advance one epoch; return the new lr."""
        self.epoch += 1
        return self.lr()

    def lr(self) -> float:
        raise NotImplementedError

    def state_dict(self) -> Dict[str, Any]:
        return {"epoch": self.epoch, "base_lr": self.base_lr}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.epoch = d["epoch"]
        self.base_lr = d["base_lr"]


@registry.register("lr_scheduler.ExponentialLR", aliases=("ExponentialLR",))
class ExponentialLR(Scheduler):
    def __init__(self, base_lr: float, gamma: float = 0.9, **kwargs):
        super().__init__(base_lr)
        self.gamma = gamma

    def lr(self) -> float:
        return self.base_lr * (self.gamma ** self.epoch)


@registry.register("lr_scheduler.StepLR", aliases=("StepLR",))
class StepLR(Scheduler):
    def __init__(self, base_lr: float, step_size: int = 10, gamma: float = 0.1, **kwargs):
        super().__init__(base_lr)
        self.step_size = step_size
        self.gamma = gamma

    def lr(self) -> float:
        return self.base_lr * (self.gamma ** (self.epoch // self.step_size))


@registry.register("lr_scheduler.CosineAnnealingLR", aliases=("CosineAnnealingLR",))
class CosineAnnealingLR(Scheduler):
    def __init__(self, base_lr: float, T_max: int = 50, eta_min: float = 0.0, **kwargs):
        super().__init__(base_lr)
        self.T_max = T_max
        self.eta_min = eta_min

    def lr(self) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * \
            (1 + math.cos(math.pi * self.epoch / self.T_max)) / 2


@registry.register("lr_scheduler.ReduceLROnPlateau", aliases=("ReduceLROnPlateau",))
class ReduceLROnPlateau(Scheduler):
    """Cut the lr by ``factor`` (not below ``min_lr``) once the metric has
    not improved for more than ``patience`` epochs; improvement by the
    ``rel`` (``best·(1 ∓ threshold)``) or ``abs`` (``best ∓ threshold``)
    threshold; ``cooldown`` epochs after a cut, which tick down every epoch
    and hold the bad-epoch count at 0. An epoch without a metric (no
    validation) only advances the epoch."""

    def __init__(self, base_lr: float, factor: float = 0.1, patience: int = 10,
                 min_lr: float = 0.0, mode: str = "min", threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0, **kwargs):
        super().__init__(base_lr)
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.mode = mode
        self.threshold = threshold
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(f"threshold_mode must be rel/abs, got {threshold_mode!r}")
        self.threshold_mode = threshold_mode
        self.cooldown = int(cooldown)
        self.cooldown_counter = 0
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.current = base_lr

    def _improved(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.threshold_mode == "rel":
            if self.mode == "min":
                return metric < self.best * (1.0 - self.threshold)
            return metric > self.best * (1.0 + self.threshold)
        if self.mode == "min":
            return metric < self.best - self.threshold
        return metric > self.best + self.threshold

    def step(self, metric: Optional[float] = None) -> float:
        self.epoch += 1
        if metric is None:
            return self.current
        if self._improved(metric):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.bad_epochs = 0
        if self.bad_epochs > self.patience:
            self.current = max(self.min_lr, self.current * self.factor)
            self.bad_epochs = 0
            self.cooldown_counter = self.cooldown
        return self.current

    def lr(self) -> float:
        return self.current

    def state_dict(self) -> Dict[str, Any]:
        d = super().state_dict()
        d.update({"current": self.current, "best": self.best,
                  "bad_epochs": self.bad_epochs, "cooldown_counter": self.cooldown_counter})
        return d

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        super().load_state_dict(d)
        self.current = d.get("current", self.base_lr)
        self.best = d.get("best")
        self.bad_epochs = d.get("bad_epochs", 0)
        self.cooldown_counter = d.get("cooldown_counter", 0)


def build_scheduler(name: Optional[str], base_lr: float,
                    params: Optional[Dict[str, Any]] = None) -> Optional[Scheduler]:
    """The scheduler of config ``scheduler_class`` from ``base_lr``, or None
    without one."""
    if not name:
        return None
    cls = registry.lookup(name)
    if not (isinstance(cls, type) and issubclass(cls, Scheduler)):
        raise KeyError(f"unknown scheduler {name!r}")
    return cls(base_lr, **dict(params or {}))
