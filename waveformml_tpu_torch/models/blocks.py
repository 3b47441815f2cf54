"""Building blocks of the sparse PSD head (counterpart of
waveformml_tpu/models/blocks.py): masked BatchNorm, the site-folded first
Linear layer and the geometric Linear stack."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.ops.site_head import SiteGroupedMatmul
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
    """BatchNorm over rows, some of which are padding (mask [N], True for
    real rows). In train mode, which needs the mask, the statistics come
    from the real rows only, in float32, with the count clamped to ≥ 1; the
    rows are normalised with the biased variance, and the running statistics
    move by torch's momentum 0.1, the running variance with the unbiased
    (Bessel) one. In eval mode
    the running statistics normalise every row. Either way the caller
    re-zeroes the padding rows. Plain PyTorch under autograd, as XLA
    computed it outside any kernel."""

    momentum = 0.1           # torch semantics: running = (1 - m)·running + m·batch

    def __init__(self, num_features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if not self.training:
            scale = torch.rsqrt(self.running_var + self.eps)
            return (x - self.running_mean) * scale * self.weight + self.bias
        if mask is None:
            raise ValueError("MaskedArrayBatchNorm needs the row mask in train mode")
        m = mask.to(torch.float32)[:, None]
        xf = x.float()
        count = m.sum().clamp(min=1.0)
        mean = (xf * m).sum(0) / count
        vsum = ((xf - mean) ** 2 * m).sum(0)
        var = vsum / count
        with torch.no_grad():
            mom = self.momentum
            unbiased = vsum / (count - 1.0).clamp(min=1.0)
            self.running_mean.copy_((1 - mom) * self.running_mean + mom * mean)
            self.running_var.copy_((1 - mom) * self.running_var + mom * unbiased)
        mean, var = mean.to(x.dtype), var.to(x.dtype)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


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
    slot layout in ``batch.plans`` (kernel K2, its gradient kernel K5).
    ``plain = True`` runs the plain PyTorch versions of both whatever the
    device, as a reference on the card.
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
        return SiteGroupedMatmul.apply(rows, k3, self.bias, plans["site_take"],
                                       plans["site_ev"], plans["site_s"], batch.n_events,
                                       self.plain)
