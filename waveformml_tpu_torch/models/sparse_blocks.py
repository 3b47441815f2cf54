"""Parametric sparse conv stacks (counterpart of
waveformml_tpu/models/sparse_blocks.py).

Layer schedules are pure static methods, copied from the JAX package so
that a config gives the same layer specs. ``_SpecNet`` builds a stack from
its specs and dispatches as the JAX package does: a pure-SubM stack
(submanifold convs, BatchNorm, ReLU, dropout, a ``todense`` tail) never
leaves row space, so every conv is one ``subm_conv_rows`` (kernel K1) over
a host-built neighbour plan; any other stack (regular, strided or inverse
convs) densifies the batch to a ``SparseGrid`` and runs the grid ops of
``ops.sparse_conv``. Which plans a row stack needs follows from its specs
(``plan_requirements``); a batch without one of them is an error. A 3D
row stack (``DSLSpecNet(n_t=…)``, coords ``[N, 4]``) convolves over the
K×K×K window of (x, y, t) through the same kernels, its plan ``[N, K³]``.
"""
from __future__ import annotations

from math import ceil, floor
from typing import List, Optional, Sequence, Set, Tuple

import torch
from torch import nn

from waveformml_tpu_torch.models.blocks import MaskedArrayBatchNorm, lecun_normal_
from waveformml_tpu_torch.models.schedules import (get_frame_contraction,
                                                   get_frame_expansion)
from waveformml_tpu_torch.ops.row_conv import SubMConvRows, rows_to_dense, rows_to_dense_3d
from waveformml_tpu_torch.ops.sparse import (SparseBatch, gather_from_dense, occupancy_mask,
                                             occupancy_mask_3d)
from waveformml_tpu_torch.ops.sparse_conv import (MaskedBatchNorm, SparseConv2d,
                                                  SparseGrid, SparseInverseConv2d,
                                                  SubMConv2d, batch_to_grid, dropout)
from waveformml_tpu_torch.parallel.gspmd import copy_to_model, gather_from_model

# layer specs: ("conv", cin, cout, k, s, p, d) / ("conv_keyed", cin, cout, k,
# s, p, d, key) / ("subm", cin, cout, k, p, key) / ("inv", cin, cout, k, key)
# / ("bn", c) / ("relu",) / ("dropout", rate) / ("todense",)
_ROW_OPS = ("subm", "bn", "relu", "dropout", "todense")


def _row_compatible(specs: Sequence[Tuple]) -> bool:
    """True when every layer has a row-space form (pure SubM stacks)."""
    return all(s[0] in _ROW_OPS for s in specs)


def plan_key(kernel_size: int, n_t: Optional[int] = None) -> str:
    """The key of a neighbour plan in ``batch.plans`` (and of its
    requirement): "k<K>" for the K×K window, "k<K>t<T>" for the K×K×K
    window over T samples."""
    return f"k{kernel_size}" if n_t is None else f"k{kernel_size}t{n_t}"


class RowSubMConv2d(nn.Module):
    """Row-space SubM conv: weight ``[K², Cin, Cout]`` (the JAX package's
    layout; ``[K³, Cin, Cout]`` with ``n_t``, the K×K×K window over T =
    n_t samples), bias ``[Cout]``; forward K1, backward K1 and K4
    (``SubMConvRows``), over the plan ``batch.plans[self.plan_key]``.
    ``plain = True`` runs the plain PyTorch versions of the forward and the
    backward whatever the device, as a reference on the card.

    Under tensor parallelism (``tp``, a ``parallel.gspmd.Mesh2D`` that
    ``TensorParallel`` sets) the weight is this rank's column block
    ``[K², Cin, Cout/tp]``: K1 runs on it without the bias, the blocks are
    gathered over the model group, and the whole bias and the row mask
    follow; in the backward d_feats of the block is summed over the group
    and K4 gives the block's weight gradient."""

    tp = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 generator: Optional[torch.Generator] = None, device=None,
                 n_t: Optional[int] = None):
        super().__init__()
        kk = kernel_size ** (2 if n_t is None else 3)
        self.kernel_size = kernel_size
        self.plan_key = plan_key(kernel_size, n_t)
        self.plain = False
        self.weight = nn.Parameter(torch.empty(kk, in_channels, out_channels,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        lecun_normal_(self.weight, kk * in_channels, generator)

    def forward(self, feats: torch.Tensor, plan: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return SubMConvRows.apply(feats, plan, self.weight, self.bias, mask, self.plain)
        out = SubMConvRows.apply(copy_to_model(feats, self.tp), plan, self.weight, None,
                                 mask, self.plain)
        out = gather_from_model(out, self.tp) + self.bias
        return torch.where(mask[:, None], out, torch.zeros((), dtype=out.dtype,
                                                           device=out.device))


class _SpecNet(nn.Module):
    """A stack built from layer specs, each parametric layer named
    ``l<i>`` as in the JAX package: on the row path ``RowSubMConv2d`` and
    ``MaskedArrayBatchNorm``, on the grid path the grid convs (their
    weights under ``l<i>.conv``) and ``MaskedBatchNorm``. A ``("bn",
    None)`` spec (a DSL BatchNorm without arguments) takes the width of
    the conv before it.

    ``in_width`` is the width of the features the stack is given where it
    differs from the schedule's (``UseFFT``'s spectrum): the first grid
    conv takes it, as flax's ``nn.Conv`` infers its input width; a row conv
    declares its width, as the JAX package's does. ``n_t`` makes a row
    stack 3D (T = n_t samples)."""

    def __init__(self, specs: List[Tuple], generator: Optional[torch.Generator] = None,
                 device=None, in_width: Optional[int] = None, n_t: Optional[int] = None):
        super().__init__()
        self.specs = specs
        self.n_t = n_t
        self.row_path = _row_compatible(specs)
        first = True
        width = in_width
        for i, spec in enumerate(specs):
            op = spec[0]
            if op in ("conv", "conv_keyed", "subm", "inv"):
                cin = spec[1]
                if first and in_width is not None and not self.row_path:
                    cin = in_width
                first = False
                width = spec[2]
            if op == "subm" and self.row_path:
                layer = RowSubMConv2d(cin, spec[2], spec[3], generator, device, n_t=n_t)
            elif op == "subm":
                _, _, cout, k, p, key = spec
                layer = SubMConv2d(cin, cout, k, 1, p, indice_key=key,
                                   generator=generator, device=device)
            elif op in ("conv", "conv_keyed"):
                _, _, cout, k, s, p, d = spec[:7]
                layer = SparseConv2d(cin, cout, k, s, p, d,
                                     indice_key=spec[7] if op == "conv_keyed" else None,
                                     generator=generator, device=device)
            elif op == "inv":
                _, _, cout, k, key = spec
                layer = SparseInverseConv2d(cin, cout, k, indice_key=key,
                                            generator=generator, device=device)
            elif op == "bn":
                layer = (MaskedArrayBatchNorm if self.row_path else MaskedBatchNorm)(
                    spec[1] if spec[1] is not None else width, device=device)
            elif op in ("relu", "dropout", "todense"):
                continue
            else:
                raise ValueError(f"unknown spec op {op}")
            self.add_module(f"l{i}", layer)

    def plan_requirements(self) -> Set[str]:
        """Neighbour plans the stack reads from ``batch.plans``: one per row
        conv window (``plan_key``; none on the grid path)."""
        if not self.row_path:
            return set()
        return {plan_key(s[3], self.n_t) for s in self.specs if s[0] == "subm"}

    def forward(self, g, return_rows: bool = False):
        """A ``SparseBatch`` (or, on the grid path, a ``SparseGrid``)
        through the stack. A row stack gives its rows ``[N, C]`` (zero at
        padding rows) with ``return_rows``, else ``[B, C, NX, NY]`` through
        a ``todense`` tail or a ``SparseGrid`` without one; a grid stack
        gives what its last layer gives (rows gathered from it with
        ``return_rows``). Dropout in train mode draws from the batch's
        ``generator``."""
        if isinstance(g, SparseBatch) and self.row_path:
            return self._row_forward(g, return_rows)
        batch = g if isinstance(g, SparseBatch) else None
        generator = batch.generator if batch is not None else None
        out = batch_to_grid(g) if batch is not None else g
        for i, spec in enumerate(self.specs):
            op = spec[0]
            if op == "relu":
                out = out.with_features(torch.relu(out.features))
            elif op == "dropout":
                out = out.with_features(dropout(out.features, spec[1], self.training,
                                                generator))
            elif op == "todense":
                out = out.masked()
            else:
                out = getattr(self, f"l{i}")(out)
        if return_rows:
            if batch is None:
                raise ValueError("return_rows needs a SparseBatch")
            dense = out.masked() if isinstance(out, SparseGrid) else out
            return gather_from_dense(dense.permute(0, 2, 3, 1), batch)
        return out

    def _row_forward(self, batch: SparseBatch, return_rows: bool):
        x, mask = batch.feats, batch.mask
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        to_dense = False
        for i, spec in enumerate(self.specs):
            op = spec[0]
            if op == "subm":
                key = plan_key(spec[3], self.n_t)
                if key not in batch.plans:
                    raise KeyError(f"batch.plans lacks the '{key}' neighbour plan; "
                                   f"build batches with TaskBase.prepare_block")
                x = getattr(self, f"l{i}")(x, batch.plans[key], mask)
                zero = torch.zeros((), dtype=x.dtype, device=x.device)
            elif op == "bn":
                x = torch.where(mask[:, None], getattr(self, f"l{i}")(x, mask), zero)
            elif op == "relu":
                x = torch.relu(x)
            elif op == "dropout":
                x = dropout(x, spec[1], self.training, batch.generator)
            elif op == "todense":
                to_dense = True
        if return_rows:
            return torch.where(mask[:, None], x, zero)
        if self.n_t is not None:
            dense = rows_to_dense_3d(x, batch, self.n_t)
            return dense if to_dense else SparseGrid(dense, occupancy_mask_3d(batch, self.n_t))
        if to_dense:
            return rows_to_dense(x, batch)
        # a site-preserving stack gives the grid of its rows
        return SparseGrid(rows_to_dense(x, batch), occupancy_mask(batch))


class SparseConv2DForEZ(_SpecNet):
    """(E, Z) per-segment conv stack, versions 0-3 of the schedule."""

    def __init__(self, in_planes: int, out_planes: int = 2, kernel_size: int = 3,
                 n_conv: int = 1, n_point: int = 3, conv_position: int = 3,
                 pointwise_factor: float = 0.8, batchnorm: bool = True,
                 version: int = 0, n_expand: int = 0,
                 generator: Optional[torch.Generator] = None, device=None,
                 in_width: Optional[int] = None):
        super().__init__(self.schedule(in_planes, out_planes, kernel_size, n_conv, n_point,
                                       conv_position, pointwise_factor, batchnorm, version,
                                       n_expand), generator, device, in_width)

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


class SparseConv2DForZ(_SpecNet):
    """Per-segment Z stack of regular sparse convs."""

    def __init__(self, in_planes: int, kernel_size: int = 3, n_layers: int = 2,
                 pointwise_layers: int = 0, pointwise_factor: float = 0.8,
                 todense: bool = True, generator: Optional[torch.Generator] = None,
                 device=None, in_width: Optional[int] = None):
        super().__init__(self.schedule(in_planes, kernel_size, n_layers, pointwise_layers,
                                       pointwise_factor, todense), generator, device, in_width)

    @staticmethod
    def schedule(in_planes, kernel_size=3, n_layers=2, pointwise_layers=0,
                 pointwise_factor=0.8, todense=True) -> List[Tuple]:
        if pointwise_layers > 0:
            if n_layers == 1:
                raise ValueError("n_layers must be > 1 if using pointwise convolution")
            increment = int(round(int(round(in_planes * pointwise_factor))
                                  / float(n_layers - 1)))
        else:
            increment = int(round(float(in_planes) / float(n_layers)))
        if kernel_size % 2 != 1:
            raise ValueError("Kernel size must be an odd integer")
        if n_layers < 1:
            raise ValueError("n_layers must be integer >= 1")
        specs: List[Tuple] = []
        out, inp = in_planes, in_planes
        reset_kernel, orig_kernel, pw = False, kernel_size, pointwise_layers
        k = kernel_size
        for i in range(n_layers):
            if i == n_layers - 1:
                out = 1
            else:
                out -= increment
                if i == 0 and pw > 0 and pointwise_factor > 0:
                    out = int(round(pointwise_factor * in_planes))
            pd = (k - 1) // 2
            if pw > 0:
                pd, k = 0, 1
                pw -= 1
                if pw == 0:
                    reset_kernel = True
            specs.append(("conv", inp, out, k, 1, pd, 1))
            if reset_kernel:
                k, reset_kernel = orig_kernel, False
            if i != n_layers - 1:
                specs.append(("bn", out))
            specs.append(("relu",))
            inp = out
            if k > 1:
                k -= 2
        if todense:
            specs.append(("todense",))
        return specs


class Pointwise2DForZ(_SpecNet):
    """Per-segment Z stack of 1×1 regular sparse convs."""

    def __init__(self, in_planes: int, pointwise_layers: int = 2,
                 generator: Optional[torch.Generator] = None, device=None,
                 in_width: Optional[int] = None):
        super().__init__(self.schedule(in_planes, pointwise_layers), generator, device,
                         in_width)

    @staticmethod
    def schedule(in_planes, pointwise_layers=2) -> List[Tuple]:
        n_layers = pointwise_layers
        if n_layers < 2:
            raise ValueError("n_layers must be integer >= 2")
        increment = int(round(float(in_planes) / float(n_layers - 1)))
        specs: List[Tuple] = []
        out, inp = in_planes, in_planes
        for i in range(n_layers):
            if i == n_layers - 1:
                out = 1
            elif i == 0:
                out = in_planes
            else:
                out -= increment
            specs.append(("conv", inp, out, 1, 1, 0, 1))
            specs.append(("bn", out))
            specs.append(("relu",))
            inp = out
        specs.append(("todense",))
        return specs


class SparseConv2DPreserve(_SpecNet):
    """Size-preserving sparse stack giving per-site features: version 0
    pairs each regular conv with an inverse conv by indice key (the grid
    path), versions 1-2 are SubM chains (the row path)."""

    def __init__(self, nin: int, nout: int, n: int = 1, size_factor: int = 3,
                 pad_factor: float = 0.0, stride_factor: float = 1, dil_factor: float = 1,
                 pointwise_factor: float = 0, dropout: float = 0,
                 expansion_factor: float = 0, n_expansion: int = 0, version: int = 0,
                 n_contraction: int = 1, filter_multiplier: float = 1.0,
                 generator: Optional[torch.Generator] = None, device=None,
                 in_width: Optional[int] = None):
        super().__init__(self.schedule(nin, nout, n, size_factor, pad_factor, stride_factor,
                                       dil_factor, pointwise_factor, dropout,
                                       expansion_factor, n_expansion, version,
                                       n_contraction, filter_multiplier),
                         generator, device, in_width)

    @staticmethod
    def schedule(nin, nout, n=1, size_factor=3, pad_factor=0.0, stride_factor=1,
                 dil_factor=1, pointwise_factor=0, dropout=0,
                 expansion_factor=0, n_expansion=0, version=0,
                 n_contraction=1, filter_multiplier=1.0) -> List[Tuple]:
        specs: List[Tuple] = []
        if version == 0:
            if pointwise_factor > 0:
                n_contr = n - 1 - n_expansion
                if n_contr < 1:
                    raise ValueError("n_contraction too large, must be < n - 1")
            else:
                n_contr = n - n_expansion
                if n_contr < 1:
                    raise ValueError("n_contraction too large, must be < n")
            nframes = [nin]
            if pointwise_factor > 0:
                nframes.append(nin - int(floor((nin - nout) * pointwise_factor)))
            if n_expansion > 0:
                nframes += get_frame_expansion(nframes[-1], expansion_factor, n_expansion)
            if n_contr > 0:
                nframes += get_frame_contraction(nframes[-1], nout, n_contr)
            nframes[-1] = nout
            for i in range(n):
                if pointwise_factor > 0:
                    decay = 1.0 - (i - 1) / (n - 1) if n > 1 else 1.0
                else:
                    decay = 1.0 - i / (n - 1) if n > 1 else 1.0
                fs = max(2, int(ceil(size_factor * decay)))
                st = max(1, int(round(stride_factor * i / (n - 1))) if n > 1 else 1)
                dil = int(round(dil_factor ** i))
                pd = int(round(pad_factor * ((fs - 1) / 2.0) * dil_factor * decay))
                if i == 0 and pointwise_factor > 0:
                    pd, fs, dil, st = 0, 1, 1, 1
                key = f"ind_{i}"
                specs.append(("conv_keyed", nframes[i], nframes[i + 1], fs, st, pd, dil, key))
                specs.append(("inv", nframes[i + 1], nframes[i + 1], fs, key))
                specs.append(("bn", nframes[i + 1]))
                specs.append(("relu",))
                if dropout:
                    specs.append(("dropout", float(dropout)))
            return specs

        # versions 1, 2: SubM chains
        ntot = n_contraction + n_expansion
        n_exp = n_expansion - 1 if pointwise_factor > 0 else n_expansion
        if ntot < 1:
            raise ValueError("n_contraction + n_expansion must be >=1")
        if size_factor % 2 != 1:
            raise ValueError("size factor must be odd if version >= 1")
        nframes = [nin]
        if pointwise_factor > 0:
            nframes.append(int(nin * pointwise_factor))
        if n_exp > 0:
            nframes += get_frame_expansion(nframes[-1], expansion_factor, n_exp)
        if n_contraction > 0:
            nframes += get_frame_contraction(nframes[-1], nout, n_contraction)
        nframes[-1] = nout
        for i in range(ntot):
            if version == 1:
                if pointwise_factor > 0:
                    decay = 1.0 - (i - 1) / (ntot - 1) if ntot > 1 else 1.0
                else:
                    decay = 1.0 - i / (ntot - 1) if ntot > 1 else 1.0
                fs = int(ceil(size_factor * decay))
            else:  # version 2: multiplicative filter growth, round to odd
                new_filter = size_factor * (filter_multiplier ** i)
                r = int(round(new_filter))
                if r % 2 == 0:
                    fs = int(ceil(new_filter)) if r - new_filter > 0 else int(floor(new_filter))
                else:
                    fs = int(floor(new_filter)) if r - new_filter > 0 else int(ceil(new_filter))
            if fs % 2 != 1:
                fs -= 1
            fs = max(3, fs)
            pd = (fs - 1) // 2
            if i == 0 and pointwise_factor > 0:
                pd, fs = 0, 1
                key = "ind_0" if version == 1 else "subm0"
            else:
                if version == 1:
                    key = f"ind_{fs}" if fs > 3 else "ind_0"
                else:
                    key = "subm0" if fs < 4 else f"subm{fs}"
            specs.append(("subm", nframes[i], nframes[i + 1], fs, pd, key))
            specs.append(("bn", nframes[i + 1]))
            specs.append(("relu",))
            if dropout:
                specs.append(("dropout", float(dropout)))
        return specs


class ExtractedFeatureConv(_SpecNet):
    """Regular sparse convs over per-segment extracted feature vectors."""

    def __init__(self, nin: int, nout: int, n: int, size: Sequence[int] = (14, 11),
                 expansion_factor: float = 10.0, size_factor: int = 3,
                 pad_factor: float = 0.0, stride_factor: float = 1, dil_factor: float = 1,
                 dropout: float = 0, generator: Optional[torch.Generator] = None,
                 device=None, in_width: Optional[int] = None):
        super().__init__(self.schedule(nin, nout, n, expansion_factor, size_factor,
                                       pad_factor, stride_factor, dil_factor, dropout),
                         generator, device, in_width)

    @staticmethod
    def schedule(nin, nout, n, expansion_factor=10.0, size_factor=3,
                 pad_factor=0.0, stride_factor=1, dil_factor=1, dropout=0) -> List[Tuple]:
        assert n > 1
        nframes = [nin, int(round(nin * expansion_factor))]
        diff = float(nframes[1] - nout) / (n - 1)
        nframes += [int(floor(nframes[1] - diff * i)) for i in range(n - 1)]
        specs: List[Tuple] = []
        for i in range(n):
            decay = 1.0 - (i - 1) / (n - 1)
            fs = max(2, int(floor(size_factor / (i + 1.0))))
            st = max(1, int(round(stride_factor * i / (n - 1))))
            dil = int(round(dil_factor ** i))
            pd = int(round(pad_factor * (fs - 1) * dil_factor * decay))
            specs.append(("conv", nframes[i], nframes[i + 1], fs, st, pd, dil))
            specs.append(("bn", nframes[i + 1]))
            specs.append(("relu",))
            if dropout:
                specs.append(("dropout", float(dropout)))
        specs.append(("todense",))
        return specs


def _block_frames(nin, nout, n, pointwise_factor, depth_factor) -> List[int]:
    """The version-0/1 channel schedule of ``SparseConv2DBlock``."""
    if nin == nout:
        return [nin] * (n + 1)
    if pointwise_factor > 0:
        nframes = [nin, nin - int(floor((nin - nout) * pointwise_factor))]
        if n > 1:
            diff = float(nin - nout) / n
            for _ in range(n - 1):
                val = int(floor(nframes[-1] - diff))
                nframes.append(val if val > nout else nout)
        return nframes
    if depth_factor > 0:
        nframes = [nin, int(nin * depth_factor)]
        if n > 1:
            diff = float(nframes[-1] - nout) / (n - 1)
            for _ in range(n - 1):
                val = int(floor(nframes[-1] - diff))
                nframes.append(val if val > nout else nout)
        return nframes
    diff = float(nin - nout) / n
    return [int(floor(nin - diff * i)) for i in range(n + 1)]


class SparseConv2DBlock(_SpecNet):
    """General stack of regular sparse convs, versions 0-3 of the
    kernel-decay and channel-path rules; ``size`` is the input's (NX, NY,
    C), which ``out_size`` propagates."""

    def __init__(self, nin: int, nout: int, n: int, size: Sequence[int] = (14, 11, 0),
                 to_dense: bool = True, size_factor: int = 3, pad_factor: float = 0.0,
                 stride_factor: float = 1, dil_factor: float = 1,
                 pointwise_factor: float = 0, depth_factor: float = 0, dropout: float = 0,
                 version: int = 0, expansion_factor: float = 0, n_expansion: int = 0,
                 generator: Optional[torch.Generator] = None, device=None,
                 in_width: Optional[int] = None):
        super().__init__(self.schedule(nin, nout, n, to_dense, size_factor, pad_factor,
                                       stride_factor, dil_factor, pointwise_factor,
                                       depth_factor, dropout, version, expansion_factor,
                                       n_expansion), generator, device, in_width)

    @staticmethod
    def schedule(nin, nout, n, to_dense=True, size_factor=3, pad_factor=0.0,
                 stride_factor=1, dil_factor=1, pointwise_factor=0,
                 depth_factor=0, dropout=0, version=0, expansion_factor=0,
                 n_expansion=0) -> List[Tuple]:
        assert n > 0
        if version in (0, 1):
            nframes = _block_frames(nin, nout, n, pointwise_factor, depth_factor)
        else:  # versions 2, 3: the expansion/contraction path
            if pointwise_factor > 0:
                n_contraction = n - 1 - n_expansion
                if n_contraction < 1:
                    raise ValueError("n_contraction too large, must be < n - 1")
            else:
                n_contraction = n - n_expansion
                if n_contraction < 1:
                    raise ValueError("n_contraction too large, must be < n")
            nframes = [nin]
            if pointwise_factor > 0:
                nframes.append(nin - int(floor((nin - nout) * pointwise_factor)))
            if n_expansion > 0:
                nframes += get_frame_expansion(nframes[-1], expansion_factor, n_expansion)
            if n_contraction > 0:
                nframes += get_frame_contraction(nframes[-1], nout, n_contraction)
        specs: List[Tuple] = []
        for i in range(n):
            if pointwise_factor > 0:
                decay = 1.0 - (i - 1) / (n - 1) if n > 1 else 1.0
            else:
                decay = 1.0 - i / (n - 1) if n > 1 else 1.0
            if version == 3:
                fs = max(2, int(ceil(size_factor * decay)))
            else:
                fs = max(2 if version in (1, 2) else 3,
                         int(floor(size_factor / (i + 1.0))))
            if version == 0:
                fs = max(3, int(floor(size_factor / (i + 1.0))))
                st = max(1, stride_factor - int(floor((stride_factor - 1) / (i + 1.0))))
                dil = int(round(dil_factor ** i))
                pd = int(round(pad_factor * (fs - 1) * dil_factor) * (i / (n + 1)))
                pd = int(pd)
            else:
                st = max(1, int(round(stride_factor * i / (n - 1))) if n > 1 else 1)
                dil = int(round(dil_factor ** i))
                pd = int(round(pad_factor * ((fs - 1) / 2.0) * dil_factor * decay))
            if i == 0 and pointwise_factor > 0:
                pd, fs, dil, st = 0, 1, 1, 1
            specs.append(("conv", nframes[i], nframes[i + 1], fs, st, pd, dil))
            specs.append(("bn", nframes[i + 1]))
            specs.append(("relu",))
            if dropout:
                specs.append(("dropout", float(dropout)))
        if to_dense:
            specs.append(("todense",))
        return specs

    @staticmethod
    def out_size(specs: Sequence[Tuple], size: Sequence[int]) -> List[int]:
        """The spatial size and width after the specs' convs:
        o = ⌊(i + 2p − k − (k − 1)(d − 1))/s⌋ + 1."""
        w, h = int(size[0]), int(size[1])
        c = int(size[2]) if len(size) > 2 else 0
        for spec in specs:
            if spec[0] == "conv":
                _, cin, cout, k, s, p, d = spec
                w = (w + 2 * p - k - (k - 1) * (d - 1)) // s + 1
                h = (h + 2 * p - k - (k - 1) * (d - 1)) // s + 1
                c = cout
            elif spec[0] == "subm":
                c = spec[2]
        return [w, h, c]


class DSLSpecNet(_SpecNet):
    """A ``_SpecNet`` over spec tuples translated from the config
    ``algorithm`` DSL (``models.algorithm.dsl_to_row_specs``): a pure-SubM
    stack runs in row space (K1, K4), in 2D, or with ``n_t`` in 3D over the
    (x, y, t) sites of T = n_t samples (each conv's kernel ``[K³, Cin,
    Cout]``, its output on the ``[B, C, NX, NY, T]`` grid)."""

    def __init__(self, spec_list: Sequence[Tuple], n_t: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__(list(spec_list), generator, device, n_t=n_t)
