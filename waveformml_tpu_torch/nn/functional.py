"""Loss criteria under the torch class names the configs use (counterpart
of waveformml_tpu/nn/functional.py).

A criterion gives the loss of every sample (``elementwise``) and the
sample's term of the 'mean' denominator (``mean_denominator``); tasks
reduce both as masked sums, so that padding never counts. Only
``CrossEntropyLoss`` is ported so far.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from waveformml_tpu_torch.registry import registry


@registry.register("CrossEntropyLoss", aliases=("nn.CrossEntropyLoss",))
class CrossEntropyLoss:
    """Softmax cross entropy on logits [N, C] with integer targets [N];
    optional per-class ``weight``, torch's first positional argument."""

    def __init__(self, weight=None, *args, **kwargs):
        if args or kwargs:
            # config criterion_params that were dropped would train another
            # objective than the one asked for: refuse them
            raise ValueError(
                f"{type(self).__name__}: unsupported criterion params "
                f"args={args!r} kwargs={kwargs!r}")
        self.weight = None if weight is None else torch.as_tensor(weight, dtype=torch.float32)

    def elementwise(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        weight = None if self.weight is None else self.weight.to(pred.device, pred.dtype)
        return F.cross_entropy(pred, target.long(), weight=weight, reduction="none")

    def mean_denominator(self, target: torch.Tensor) -> Optional[torch.Tensor]:
        """Per-sample term of the 'mean' denominator, or None for the sample
        count (torch divides a class-weighted mean by the sum of the
        selected weights)."""
        if self.weight is None:
            return None
        return self.weight.to(target.device)[target.long()]


def build_criterion(name: str, params=None):
    """A criterion from config ``criterion_class`` and ``criterion_params``
    (positional arguments)."""
    cls = registry.retrieve_class(name)
    return cls(*(list(params) if params else []))
