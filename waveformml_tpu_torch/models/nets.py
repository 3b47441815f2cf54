"""Model classes registered under the JAX package's config names
(counterpart of waveformml_tpu/models/nets.py)."""
from __future__ import annotations

from math import pow as fpow
from typing import Any, Optional, Set

import torch
from torch import nn

from waveformml_tpu_torch.config import to_dict
from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.models.blocks import FoldedSiteLinear, LinearBlock
from waveformml_tpu_torch.models.sparse_blocks import SparseConv2DForEZ
from waveformml_tpu_torch.ops.sparse import SparseBatch
from waveformml_tpu_torch.registry import registry


@registry.register("SubMPSDNet", aliases=("SPConvNet.SubMPSDNet",))
class SubMPSDNet(nn.Module):
    """Event classifier over a pure-SubM sparse stack: the version-2
    ``SparseConv2DForEZ`` row stack, then ``Linear(flatten([B, C, NX, NY]))``
    folded over the active sites (``FoldedSiteLinear``), then a
    ``LinearBlock`` with the same plane schedule as the JAX model."""

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        sc = config.system_config
        hp = config.net_config.hparams
        out_planes = getattr(hp, "out_planes", 8)
        params = to_dict(getattr(hp, "conv_params", None) or {})
        params.setdefault("version", 2)
        self.stack = SparseConv2DForEZ(sc.n_samples * 2, out_planes=out_planes,
                                       generator=generator, device=device, **params)
        flat = out_planes * NX * NY
        n_lin = getattr(hp, "n_lin", 2)
        factor = fpow(float(sc.n_type) / flat, 1.0 / n_lin)
        planes = [int(round(flat * fpow(factor, i + 1))) for i in range(n_lin)]
        self.head0 = FoldedSiteLinear(out_planes, planes[0], generator, device)
        self.linear = (LinearBlock(planes[0], sc.n_type, n_lin - 1, generator, device)
                       if n_lin > 1 else None)

    def plan_requirements(self) -> Set[str]:
        """Host-built plans a batch must carry: the stack's neighbour plans
        and the head's site layout."""
        return self.stack.plan_requirements() | {"site"}

    def forward(self, batch: SparseBatch) -> torch.Tensor:
        rows = self.stack(batch)             # [N, C]
        x = self.head0(rows, batch)          # [B, planes[0]]
        if self.linear is not None:
            x = self.linear(x)
        return x
