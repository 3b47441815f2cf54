"""Model classes registered under the JAX package's config names
(counterpart of waveformml_tpu/models/nets.py).

The per-segment nets hold their stack under the name flax gives the JAX
net's one child (``SparseConv2DForZ_0``, ...), so that ``convert.py``
carries the JAX package's variables path for path; ``stack`` names it
whatever its class.
"""
from __future__ import annotations

from math import pow as fpow
from typing import Any, Optional, Set, Tuple

import torch
from torch import nn

from waveformml_tpu_torch.config import to_dict
from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.models.blocks import FoldedSiteLinear, LinearBlock
from waveformml_tpu_torch.models.sparse_blocks import (Pointwise2DForZ, SparseConv2DForEZ,
                                                       SparseConv2DForZ, SparseConv2DPreserve,
                                                       _SpecNet)
from waveformml_tpu_torch.ops.sparse import SparseBatch, gather_from_dense
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
        rows = self.stack(batch, return_rows=True)      # [N, C]
        x = self.head0(rows, batch)          # [B, planes[0]]
        if self.linear is not None:
            x = self.linear(x)
        return x


class _OneStackNet(nn.Module):
    """A net whose parameters are one ``_SpecNet``, registered under the
    flax name of the JAX net's child: ``<class name>_0``."""

    def _set_stack(self, stack: _SpecNet) -> None:
        self._stack_name = f"{type(stack).__name__}_0"
        self.add_module(self._stack_name, stack)

    @property
    def stack(self) -> _SpecNet:
        return getattr(self, self._stack_name)

    def plan_requirements(self) -> Set[str]:
        """The neighbour plans of the stack's row convs."""
        return self.stack.plan_requirements()


@registry.register("SPConvPreserveNet", aliases=("SPConvNet.SPConvPreserveNet",))
class SPConvPreserveNet(_OneStackNet):
    """Site-preserving sparse net giving per-row features ``[N, n_type]``:
    the ``SparseConv2DPreserve`` stack's grid, read back at the batch's
    rows (two rows at one site both read the sum of their outputs)."""

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        sc = config.system_config
        hp = config.net_config.hparams
        self._set_stack(SparseConv2DPreserve(sc.n_samples * 2, sc.n_type, hp.n_conv,
                                             generator=generator, device=device,
                                             **to_dict(hp.conv_params)))

    def forward(self, batch: SparseBatch) -> torch.Tensor:
        out = self.stack(batch)
        return gather_from_dense(out.features.permute(0, 2, 3, 1), batch)


def _input_planes(config) -> Tuple[int, Optional[int]]:
    """The per-segment nets' input width by the schedule (the samples of
    both PMTs, or one row of features for ``algorithm: features``), and
    the width a grid stack is really given where ``UseFFT`` turns the
    features into their spectrum (real ‖ imaginary parts, 2 more)."""
    nc = config.net_config
    ns = config.system_config.n_samples
    n_in = ns if getattr(nc, "algorithm", "conv") == "features" else ns * 2
    return n_in, (n_in + 2 if getattr(nc, "UseFFT", False) else None)


@registry.register("SingleEndedZConv", aliases=("SingleEndedZConv.SingleEndedZConv",))
class SingleEndedZConv(_OneStackNet):
    """Per-segment Z regressor giving the dense ``[B, 1, NX, NY]`` map:
    ``algorithm`` "conv" or "features" with ``SparseConv2DForZ`` at version
    0 (regular sparse convs on the grid) or ``SparseConv2DForEZ`` with one
    output plane at version >= 1 (its SubM versions run the row path),
    "point" with ``Pointwise2DForZ``."""

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        nc = config.net_config
        algorithm = getattr(nc, "algorithm", "conv")
        version = getattr(nc, "version", 0)
        n_in, in_width = _input_planes(config)
        kw = dict(generator=generator, device=device, in_width=in_width)
        if algorithm in ("conv", "features"):
            if version == 0:
                stack = SparseConv2DForZ(n_in, **to_dict(nc.hparams.conv), **kw)
            else:
                stack = SparseConv2DForEZ(n_in, out_planes=1, **to_dict(nc.hparams), **kw)
        elif algorithm == "point":
            stack = Pointwise2DForZ(n_in, **to_dict(nc.hparams.point), **kw)
        else:
            raise IOError(f"unknown algorithm {algorithm}")
        self._set_stack(stack)

    def forward(self, batch: SparseBatch) -> torch.Tensor:
        return self.stack(batch)


@registry.register("SingleEndedEZConv", aliases=("SingleEndedEZConv.SingleEndedEZConv",))
class SingleEndedEZConv(_OneStackNet):
    """(E, Z) per-segment regressor giving ``[B, 2, NX, NY]``: a
    ``SparseConv2DForEZ`` stack of two output planes, or of one beside the
    output of a frozen Z model (``z_model``, a module in eval mode whose
    parameters are not this net's: it is not registered as a submodule,
    so it is in neither ``parameters()`` nor ``state_dict()``), concatenated
    with no gradient."""

    def __init__(self, config: Any, z_model: Optional[nn.Module] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        nc = config.net_config
        n_in, in_width = _input_planes(config)
        self._z_model = (z_model,) if z_model is not None else ()
        self._set_stack(SparseConv2DForEZ(n_in, out_planes=1 if z_model is not None else 2,
                                          generator=generator, device=device,
                                          in_width=in_width, **to_dict(nc.hparams)))

    def plan_requirements(self) -> Set[str]:
        """The stack's neighbour plans and the frozen Z model's."""
        reqs = self.stack.plan_requirements()
        for z in self._z_model:
            reqs |= z.plan_requirements()
        return reqs

    def forward(self, batch: SparseBatch) -> torch.Tensor:
        x = self.stack(batch)
        for z_model in self._z_model:
            with torch.no_grad():
                z = z_model(batch)
            x = torch.cat([x, z.to(x.dtype)], dim=1)
        return x
