"""Sparse conv stacks over the active rows of a batch (counterpart of
waveformml_tpu/models/sparse_blocks.py).

Layer schedules are pure static methods, copied from the JAX package so
that a config gives the same layer shapes. The port runs row-compatible
stacks only (submanifold convs, BatchNorm, ReLU, dropout): those never leave
row space, so every conv is one ``subm_conv_rows`` (kernel K1) over a
host-built neighbour plan. Which plans a stack needs follows from its
schedule (``plan_requirements``); a batch without one of them is an error.
"""
from __future__ import annotations

from math import ceil
from typing import List, Optional, Set, Tuple

import torch
from torch import nn

from waveformml_tpu_torch.models.blocks import MaskedArrayBatchNorm, lecun_normal_
from waveformml_tpu_torch.models.schedules import (get_frame_contraction,
                                                   get_frame_expansion)
from waveformml_tpu_torch.ops.row_conv import SubMConvRows
from waveformml_tpu_torch.ops.sparse import SparseBatch

# layer specs: ("conv", cin, cout, k, s, p, d) / ("subm", cin, cout, k, p, key)
# / ("bn", c) / ("relu",) / ("dropout", rate) / ("todense",)
_ROW_OPS = ("subm", "bn", "relu", "dropout", "todense")


class RowSubMConv2d(nn.Module):
    """Row-space SubM conv: weight ``[K², Cin, Cout]`` (the JAX package's
    layout), bias ``[Cout]``; forward K1, backward K1 and K4
    (``SubMConvRows``). ``plain = True`` runs the plain PyTorch versions of
    the forward and the backward whatever the device, as a reference on the
    card."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        kk = kernel_size ** 2
        self.kernel_size = kernel_size
        self.plain = False
        self.weight = nn.Parameter(torch.empty(kk, in_channels, out_channels,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        lecun_normal_(self.weight, kk * in_channels, generator)

    def forward(self, feats: torch.Tensor, plan: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        return SubMConvRows.apply(feats, plan, self.weight, self.bias, mask, self.plain)


class SparseConv2DForEZ(nn.Module):
    """(E, Z) per-segment conv stack, versions 0-3 of the schedule; the port
    runs the row-compatible versions (1-3)."""

    def __init__(self, in_planes: int, out_planes: int = 2, kernel_size: int = 3,
                 n_conv: int = 1, n_point: int = 3, conv_position: int = 3,
                 pointwise_factor: float = 0.8, batchnorm: bool = True,
                 version: int = 0, n_expand: int = 0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.specs = self.schedule(in_planes, out_planes, kernel_size, n_conv,
                                   n_point, conv_position, pointwise_factor,
                                   batchnorm, version, n_expand)
        bad = sorted({s[0] for s in self.specs if s[0] not in _ROW_OPS})
        if bad:
            raise NotImplementedError(
                f"layer kinds {bad} need the dense-grid sparse convs, which "
                f"are not ported; use a SubM schedule (version >= 1)")
        for i, spec in enumerate(self.specs):
            if spec[0] == "subm":
                _, cin, cout, k, _, _ = spec
                self.add_module(f"l{i}", RowSubMConv2d(cin, cout, k, generator,
                                                       device))
            elif spec[0] == "bn":
                self.add_module(f"l{i}", MaskedArrayBatchNorm(spec[1], device=device))

    @staticmethod
    def schedule(in_planes, out_planes=2, kernel_size=3, n_conv=1, n_point=3,
                 conv_position=3, pointwise_factor=0.8, batchnorm=True,
                 version=0, n_expand=0) -> List[Tuple]:
        n_layers = n_conv + n_point
        if n_conv > 0 and conv_position < 1:
            raise ValueError("conv position must be >= 1 if n_conv > 0")
        if n_point > 0 and n_layers == 1:
            raise ValueError("n_layers must be > 1 if using pointwise convolution")
        if kernel_size % 2 != 1:
            raise ValueError("Kernel size must be an odd integer")
        if n_layers < 1:
            raise ValueError("n_layers must be integer >= 1")
        conv_positions = list(range(conv_position - 1, conv_position - 1 + n_conv)) \
            if n_conv > 0 else []
        specs: List[Tuple] = []

        if version == 3:
            # expansion/contraction channel path
            n_contraction = n_layers - n_expand
            if n_contraction < 1:
                raise ValueError("n expand must be <= (n_point + n_conv - 1)")
            nframes = [in_planes]
            if n_expand > 0:
                nframes += get_frame_expansion(nframes[-1], 2.0, n_expand, True)
            if n_contraction > 0:
                nframes += get_frame_contraction(nframes[-1], out_planes, n_contraction, True)
            nframes[-1] = out_planes
            for i in range(n_layers):
                if i not in conv_positions:
                    fs, pd = 1, 1
                else:
                    decay = 1.0 - conv_positions.index(i) / (n_conv - 1) if n_conv > 1 else 1.0
                    fs = int(ceil(kernel_size * decay))
                    if fs % 2 == 0:
                        fs -= 1
                    fs = max(3, fs)
                    pd = (fs - 1) // 2
                key = "subm0" if fs < 4 else f"subm{fs}"
                specs.append(("subm", nframes[i], nframes[i + 1], fs, pd, key))
                if i != n_layers - 1 and batchnorm:
                    specs.append(("bn", nframes[i + 1]))
                specs.append(("relu",))
            specs.append(("todense",))
            return specs

        # versions 0-2: decrement channel path
        if n_point > 0:
            increment = int(round(int(round(in_planes * pointwise_factor - out_planes))
                                  / float(n_layers - 1)))
        else:
            increment = int(round(float(in_planes - out_planes) / float(n_layers)))
        out = in_planes
        inp = in_planes
        for i in range(n_layers):
            if i == n_layers - 1:
                out = out_planes
            else:
                out -= increment
                if i == 0 and n_point > 0 and pointwise_factor > 0:
                    out = int(round(pointwise_factor * in_planes))
            if i not in conv_positions:
                curr_kernel = 1
            elif version == 2:
                curr_kernel = max(3, kernel_size)
            else:
                curr_kernel = max(3, kernel_size - int((i + 1 - conv_position) * 2))
            if curr_kernel % 2 == 0:
                raise ValueError("error: kernel size is even")
            pd = (curr_kernel - 1) // 2
            if out <= 0:
                out = 1
            if version == 0:
                specs.append(("conv", inp, out, curr_kernel, 1, pd, 1))
            else:  # versions 1, 2 use SubM with shared indice keys
                key = "subm0" if curr_kernel < 4 else f"subm{curr_kernel}"
                specs.append(("subm", inp, out, curr_kernel, pd, key))
            if i != n_layers - 1 and batchnorm:
                specs.append(("bn", out))
            specs.append(("relu",))
            inp = out
        specs.append(("todense",))
        return specs

    def plan_requirements(self) -> Set[str]:
        """Neighbour plans the stack reads from ``batch.plans``: "k<K>"."""
        return {f"k{s[3]}" for s in self.specs if s[0] == "subm"}

    def forward(self, batch: SparseBatch) -> torch.Tensor:
        """Active-row features ``[N, C_out]`` of the stack, zero at padding
        rows (the dense ``todense`` tail is left to the caller)."""
        x, mask = batch.feats, batch.mask
        for i, spec in enumerate(self.specs):
            if spec[0] == "subm":
                key = f"k{spec[3]}"
                if key not in batch.plans:
                    raise KeyError(f"batch.plans lacks the '{key}' neighbour plan; "
                                   f"build batches with TaskBase.prepare_block")
                x = getattr(self, f"l{i}")(x, batch.plans[key], mask)
            elif spec[0] == "bn":
                x = getattr(self, f"l{i}")(x, mask)
                x = torch.where(mask[:, None], x, torch.zeros((), dtype=x.dtype,
                                                              device=x.device))
            elif spec[0] == "relu":
                x = torch.relu(x)
            elif spec[0] == "dropout" and self.training:
                raise NotImplementedError("dropout is ported in eval mode only")
        return torch.where(mask[:, None], x, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))
