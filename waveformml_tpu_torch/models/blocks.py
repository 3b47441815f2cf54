"""Building blocks of the sparse PSD head (counterpart of
waveformml_tpu/models/blocks.py): masked BatchNorm, the site-folded first
Linear layer and the geometric Linear stack."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.ops.site_head import (site_grouped_matmul,
                                                site_grouped_matmul_plain)
from waveformml_tpu_torch.ops.sparse import SparseBatch


def lecun_normal_(tensor: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at ±2σ, rescaled so that
    the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


class MaskedArrayBatchNorm(nn.Module):
    """BatchNorm over rows, some of which are padding, in eval mode: the
    running statistics normalise every row and the caller re-zeroes the
    padding rows. (Train-mode statistics over the real rows only come with
    the training port.)"""

    def __init__(self, num_features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "MaskedArrayBatchNorm is ported in eval mode only; call .eval()")
        scale = torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean) * scale * self.weight + self.bias


class LinearBlock(nn.Module):
    """n Linear layers from nin to nout, plane i = round(nin·(nout/nin)^(i/n))."""

    def __init__(self, nin: int, nout: int, n: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if n <= 0 or nin <= 0:
            raise ValueError(f"LinearBlock needs n > 0 and nin > 0, got {n}, {nin}")
        factor = math.pow(float(nout) / nin, 1.0 / n)
        width = nin
        self.n = n
        for i in range(n):
            out = int(round(nin * math.pow(factor, i + 1)))
            layer = nn.Linear(width, out, device=device)
            lecun_normal_(layer.weight, width, generator)
            nn.init.zeros_(layer.bias)
            self.add_module(f"dense_{i}", layer)
            width = out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
        return x


class FoldedSiteLinear(nn.Module):
    """``Linear(flatten([B, C, NX, NY]))`` computed over the active rows only.

    The weight is ``[C·S, F]`` with row index ``c·S + x·NY + y`` (S = NX·NY),
    so it is interchangeable with a Linear over the flattened dense grid.
    Only the ``bysite`` mode is ported: the site-grouped GEMM over the host
    slot layout in ``batch.plans`` (kernel K2). ``plain = True`` runs the
    plain PyTorch version whatever the device, as a reference on the card.
    """

    def __init__(self, cin: int, features: int,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cin = cin
        self.features = features
        self.plain = False
        self.weight = nn.Parameter(torch.empty(cin * NX * NY, features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        lecun_normal_(self.weight, cin * NX * NY, generator)

    def forward(self, rows: torch.Tensor, batch: SparseBatch) -> torch.Tensor:
        plans = batch.plans
        if "site_take" not in plans:
            raise ValueError("FoldedSiteLinear needs the host site layout in "
                             "batch.plans (site_take/site_ev/site_s); build "
                             "batches with TaskBase.prepare_block")
        k3 = self.weight.view(self.cin, NX * NY, self.features)
        fn = site_grouped_matmul_plain if self.plain else site_grouped_matmul
        return fn(rows, k3, plans["site_take"], plans["site_ev"], plans["site_s"],
                  batch.n_events, self.bias)
