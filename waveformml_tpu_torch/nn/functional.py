"""Loss criteria under the torch class names the configs use (counterpart
of waveformml_tpu/nn/functional.py).

A criterion gives the loss of every sample (``elementwise``) and the
sample's term of the 'mean' denominator (``mean_denominator``); tasks
reduce both as masked sums, so that padding never counts.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from waveformml_tpu_torch.registry import registry


class _Criterion:
    """A criterion without parameters: config ``criterion_params`` that it
    would drop would train another objective than the one asked for, so
    it refuses them."""

    def __init__(self, *args, **kwargs):
        if args or kwargs:
            raise ValueError(
                f"{type(self).__name__}: unsupported criterion params "
                f"args={args!r} kwargs={kwargs!r}")

    def elementwise(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def mean_denominator(self, target: torch.Tensor) -> Optional[torch.Tensor]:
        """None: the 'mean' denominator is the sample count."""
        return None


@registry.register("L1Loss", aliases=("nn.L1Loss",))
class L1Loss(_Criterion):
    def elementwise(self, pred, target):
        return (pred - target).abs()


@registry.register("MSELoss", aliases=("nn.MSELoss",))
class MSELoss(_Criterion):
    def elementwise(self, pred, target):
        d = pred - target
        return d * d


@registry.register("SmoothL1Loss", aliases=("nn.SmoothL1Loss",))
class SmoothL1Loss(_Criterion):
    """Quadratic below ``beta``, linear above (the JAX package's, which
    takes ``beta`` by keyword and ignores other arguments)."""

    def __init__(self, *args, beta: float = 1.0, **kwargs):
        self.beta = beta

    def elementwise(self, pred, target):
        d = (pred - target).abs()
        return torch.where(d < self.beta, 0.5 * d * d / self.beta, d - 0.5 * self.beta)


@registry.register("BCELoss", aliases=("nn.BCELoss",))
class BCELoss(_Criterion):
    """Binary cross entropy on probabilities, clipped to [1e-7, 1 - 1e-7]."""

    def elementwise(self, pred, target):
        eps = 1e-7
        p = pred.clamp(eps, 1 - eps)
        t = target.to(p.dtype)
        return -(t * torch.log(p) + (1 - t) * torch.log1p(-p))


@registry.register("BCEWithLogitsLoss", aliases=("nn.BCEWithLogitsLoss",))
class BCEWithLogitsLoss(_Criterion):
    """Binary cross entropy on logits: max(x, 0) - x·t + log(1 + e^-|x|)."""

    def elementwise(self, pred, target):
        t = target.to(pred.dtype)
        return pred.clamp(min=0) - pred * t + torch.log1p(torch.exp(-pred.abs()))


@registry.register("HuberLoss", aliases=("nn.HuberLoss",))
class HuberLoss(_Criterion):
    """Quadratic below ``delta``, linear above (the JAX package's, which
    takes ``delta`` by keyword and ignores other arguments)."""

    def __init__(self, *args, delta: float = 1.0, **kwargs):
        self.delta = delta

    def elementwise(self, pred, target):
        d = (pred - target).abs()
        return torch.where(d < self.delta, 0.5 * d * d, self.delta * (d - 0.5 * self.delta))


class _WeightedNLLBase:
    """A negative log-likelihood over per-class log-probabilities [N, C]
    with integer targets [N]; optional per-class ``weight``, torch's first
    positional argument. Subclasses give the log-probabilities of their
    input (``_logp``)."""

    def __init__(self, weight=None, *args, **kwargs):
        if args or kwargs:
            # config criterion_params that were dropped would train another
            # objective than the one asked for: refuse them
            raise ValueError(
                f"{type(self).__name__}: unsupported criterion params "
                f"args={args!r} kwargs={kwargs!r}")
        self.weight = None if weight is None else torch.as_tensor(weight, dtype=torch.float32)

    def _logp(self, pred: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def elementwise(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        weight = None if self.weight is None else self.weight.to(pred.device, pred.dtype)
        return F.nll_loss(self._logp(pred), target.long(), weight=weight, reduction="none")

    def mean_denominator(self, target: torch.Tensor) -> Optional[torch.Tensor]:
        """Per-sample term of the 'mean' denominator, or None for the sample
        count (torch divides a class-weighted mean by the sum of the
        selected weights)."""
        if self.weight is None:
            return None
        return self.weight.to(target.device)[target.long()]


@registry.register("CrossEntropyLoss", aliases=("nn.CrossEntropyLoss",))
class CrossEntropyLoss(_WeightedNLLBase):
    """Softmax cross entropy on logits [N, C] with integer targets [N]."""

    def _logp(self, pred):
        return torch.log_softmax(pred, dim=-1)


@registry.register("NLLLoss", aliases=("nn.NLLLoss",))
class NLLLoss(_WeightedNLLBase):
    """Negative log likelihood on log-probabilities [N, C]."""

    def _logp(self, pred):
        return pred


def build_criterion(name: str, params=None):
    """A criterion from config ``criterion_class`` and ``criterion_params``
    (positional arguments)."""
    cls = registry.retrieve_class(name)
    return cls(*(list(params) if params else []))
