"""Sparse convolution on the dense detector grid with spconv's occupancy
semantics (counterpart of waveformml_tpu/ops/sparse_conv.py).

The detector grid is 14×11 sites, so a batch densifies to a small
``[B, C, NX, NY]`` block (``[B, C, NX, NY, T]`` for the 3D nets, T the
samples of a waveform) and the sparse semantics become occupancy-mask
algebra around ordinary convolutions:

* ``SubMConv2d``: output sites are the input sites; with zeros at empty
  sites the dense conv over the window equals the sparse sum, so
  ``(conv(x) + bias)·occ`` is exact.
* ``SparseConv2d``: output sites are those whose window holds an active
  input (``dilate_occupancy``, a ones-kernel conv of the occupancy).
* ``SparseInverseConv2d``: the transposed conv of the forward conv paired
  with it by ``indice_key``, restoring the occupancy saved under that key.
* ``MaskedBatchNorm``: BatchNorm statistics over the active sites only.

Each conv class is 2D; its ``*3d`` subclass (``spconv.SubMConv3d``,
``SparseConv3d``, ``SparseInverseConv3d``) is the same conv over three
spatial axes, as the JAX package's classes take their rank from the grid.

The grid holds its features in PyTorch's ``[B, C, NX, NY]`` order (the
order the JAX package's ``ToDense`` and every flatten produce), usually as
a channels-last view of the row scatter. The JAX package computes these
convs with XLA's own convolution (``lax.conv_general_dilated``), not a
Pallas kernel, so the port computes them with PyTorch's (cuDNN on the
card), in float32: ``conv`` switches TF32 off around each conv, in the
forward and in the backward, whatever the process has set (``ieee_fp32``).

One exception: a 3D grid built from a batch (``batch_to_grid_3d``) carries
its rows (``GridRows``), and a float32 SubM conv over it with an odd cubic
window and no dilation computes over the occupied sites alone, not over
every site of the dense grid: the rows' features gathered from the grid,
kernels K1 (forward) and K4 (weight and bias gradients) of
``ops/row_conv.py`` over a K³-tap plan built on the device once per grid and
kernel size, the output rows put back on a zeroed grid. It sums the present
taps in IEEE float32 (FFMA), as the dense conv's semantics ask. Ops that keep
the occupancy pass the rows on (``with_features``); the regular and inverse
convs, which change it, drop them, so every other conv runs on cuDNN. While
tracing is active, counters ``grid.subm_rows`` and ``grid.subm_dense`` count
the SubM calls that took each route.

While tracing is active on the card (``utils.tracing``), each conv module
records its forward's device span, ``grid.<class>.forward``, and its
backward's, ``grid.<class>.backward``: from the gradient reaching its
output to the end of its conv's backward (the masking of its input, which
autograd runs after that, falls outside; on the row route, to the end of
K4). Their events and hooks change no number.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.models.blocks import MaskedArrayBatchNorm, lecun_normal_
from waveformml_tpu_torch.ops.row_conv import (SubMConvRows, device_site_table,
                                               subm_conv_rows_plan)
from waveformml_tpu_torch.ops.sparse import (SparseBatch, flat_site_3d, occupancy_mask,
                                             occupancy_mask_3d, scatter_to_dense,
                                             scatter_to_dense_3d)
from waveformml_tpu_torch.registry import registry
from waveformml_tpu_torch.utils import tracing

IntPair = Union[int, Sequence[int]]
Geometry = Tuple[Tuple[int, ...], ...]     # (kernel, stride, padding, dilation)


def _ntuple(v: IntPair, n: int) -> Tuple[int, ...]:
    if isinstance(v, (list, tuple)):
        if len(v) != n:
            raise ValueError(f"expected {n} values, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * n


@contextlib.contextmanager
def ieee_fp32():
    """cuDNN's float32 convolutions and recurrences and cuBLAS's float32
    matmuls in full float32 (no TF32) inside the block, through the
    precision API the installed PyTorch has; the process's settings are
    restored after it."""
    backends = torch.backends
    apis = [getattr(backends.cudnn, "conv", None), getattr(backends.cudnn, "rnn", None),
            getattr(backends.cuda, "matmul", None)]
    apis = [a for a in apis if a is not None and hasattr(a, "fp32_precision")]
    if len(apis) == 3:
        saved = [a.fp32_precision for a in apis]
        for a in apis:
            a.fp32_precision = "ieee"
        try:
            yield
        finally:
            for a, v in zip(apis, saved):
                a.fp32_precision = v
    else:
        saved = (backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32)
        backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32 = saved


class _Conv(torch.autograd.Function):
    """``aten.convolution`` (regular or transposed) and its backward, each
    inside ``ieee_fp32``: autograd runs the backward later, outside
    any block the forward ran in, so the backward sets the precision
    itself."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, transposed, groups):
        ctx.save_for_backward(x, weight)
        ctx.geometry = (stride, padding, dilation, transposed, groups)
        ctx.has_bias = bias is not None
        with ieee_fp32():
            return torch.ops.aten.convolution(x, weight, bias, stride, padding, dilation,
                                              transposed, [0] * len(stride), groups)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        stride, padding, dilation, transposed, groups = ctx.geometry
        cout = weight.shape[1] * groups if transposed else weight.shape[0]
        need = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                ctx.has_bias and ctx.needs_input_grad[2]]
        with ieee_fp32():
            dx, dw, db = torch.ops.aten.convolution_backward(
                g, x, weight, [cout] if ctx.has_bias else None, stride, padding, dilation,
                transposed, [0] * len(stride), groups, need)
        return dx, dw, db, None, None, None, None, None


def conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
         stride=(1, 1), padding=(0, 0), dilation=(1, 1), transposed: bool = False,
         groups: int = 1) -> torch.Tensor:
    """A convolution of ``x [B, Cin, *S]`` (one spatial axis a value of
    ``stride``, ``padding`` and ``dilation``) in float32 without TF32,
    forward and backward: weight ``[Cout, Cin / groups, *k]``, or ``[Cin,
    Cout / groups, *k]`` where ``transposed``; the weight and bias are cast
    to x's dtype, as the JAX package's convs compute in their input's
    dtype."""
    w = weight.to(x.dtype)
    b = bias.to(x.dtype) if bias is not None else None
    return _Conv.apply(x, w, b, list(stride), list(padding), list(dilation), transposed,
                       groups)


def _trace(module: nn.Module, begin: Optional[tracing.Mark], out: torch.Tensor,
           conv_out: torch.Tensor) -> None:
    """A conv module's device spans (the module docstring), from ``begin``,
    the mark at the start of its forward (None: tracing is not active on
    the card); ``out`` is its output's features, ``conv_out`` its conv's."""
    if begin is None:
        return
    name = "grid." + type(module).__name__
    tracing.device_span(name + ".forward", begin, tracing.device_event(out.device))
    tracing.backward_span(name + ".backward", out, conv_out, out.device)


@dataclasses.dataclass(frozen=True, eq=False)
class GridRows:
    """What a 3D batch's rows say about the sites of its grid: each row's
    flat site index ``site`` ``[N]`` int64 (``((event·NX + x)·NY + y)·T +
    t``; ``B·NX·NY·T`` for padding rows and rows off the grid), the grid's
    ``n_events`` and ``n_t``, and, built from them on the device at their
    first use (inside the first SubM conv's span): the site table
    ``table`` (``device_site_table``), ``live`` ``[N]`` bool, one canonical
    row per occupied site (the last of its rows: the scatter sums two rows
    at one site, so only one of them may convolve), and ``plans``, the
    K³-tap neighbour plans by kernel size, shared by every SubM conv of
    this occupancy."""

    site: torch.Tensor
    n_events: int
    n_t: int
    plans: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)

    @functools.cached_property
    def table(self) -> torch.Tensor:
        return device_site_table(self.site, self.n_events * NX * NY * self.n_t)

    @functools.cached_property
    def live(self) -> torch.Tensor:
        return self.table.index_select(0, self.site) == torch.arange(
            self.site.shape[0], dtype=torch.int32, device=self.site.device)

    def plan(self, k: int) -> torch.Tensor:
        """The ``[N, k³]`` plan, built at its first use."""
        if k not in self.plans:
            self.plans[k] = subm_conv_rows_plan(self.site, self.live, self.table, k, self.n_t)
        return self.plans[k]


@dataclasses.dataclass(frozen=True)
class SparseGrid:
    """A sparse batch on the dense grid: ``features [B, C, NX, NY]`` (``[B,
    C, NX, NY, T]`` in 3D; zeros off the occupancy), ``occupancy [B, NX,
    NY]`` (``[B, NX, NY, T]``) bool, and per
    ``indice_key`` the occupancy saved by the conv that recorded it
    (``indice_occ``) and that conv's geometry (``indice_geom``: kernel,
    stride, padding, dilation), which the paired inverse conv reads.
    ``rows`` (3D grids built from a batch) are the rows behind the
    occupancy, which the SubM convs compute over; a conv that changes the
    occupancy drops them."""

    features: torch.Tensor
    occupancy: torch.Tensor
    indice_occ: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    indice_geom: Dict[str, Geometry] = dataclasses.field(default_factory=dict)
    rows: Optional[GridRows] = None

    def with_features(self, f: torch.Tensor, save_key: Optional[str] = None,
                      save_geom: Optional[Geometry] = None) -> "SparseGrid":
        """This grid with features ``f`` (the same occupancy and rows);
        with ``save_key``, its occupancy (and ``save_geom``) saved under
        that key."""
        keys, geoms = dict(self.indice_occ), dict(self.indice_geom)
        if save_key is not None:
            keys[save_key] = self.occupancy
            if save_geom is not None:
                geoms[save_key] = save_geom
        return SparseGrid(f, self.occupancy, keys, geoms, self.rows)

    def masked(self) -> torch.Tensor:
        """The features with zeros enforced off the occupancy."""
        return self.features * self.occupancy[:, None].to(self.features.dtype)


def batch_to_grid(batch: SparseBatch, feats: Optional[torch.Tensor] = None) -> SparseGrid:
    """A ``SparseBatch`` (or its rows ``feats``) as a ``SparseGrid`` (the
    ``spconv.SparseConvTensor`` of the reference); the features are a
    channels-last view of the scatter."""
    return SparseGrid(scatter_to_dense(batch, feats).permute(0, 3, 1, 2),
                      occupancy_mask(batch))


def batch_to_grid_3d(batch: SparseBatch, n_t: int,
                     feats: Optional[torch.Tensor] = None) -> SparseGrid:
    """A 3D ``SparseBatch`` (coords ``[N, 4]`` = x, y, t, event) as a
    ``SparseGrid`` of ``T = n_t`` samples, ``[B, C, NX, NY, T]``, a
    channels-last view of the scatter, carrying its ``GridRows``."""
    return SparseGrid(scatter_to_dense_3d(batch, n_t, feats).permute(0, 4, 1, 2, 3),
                      occupancy_mask_3d(batch, n_t),
                      rows=GridRows(flat_site_3d(batch, n_t), batch.n_events, n_t))


def dilate_occupancy(occ: torch.Tensor, kernel_size: IntPair, stride: IntPair,
                     padding: IntPair, dilation: IntPair) -> torch.Tensor:
    """The occupancy ``[B, *S]`` (2 or 3 spatial axes) after a regular
    sparse conv: an output site is active where its window holds an active
    input site."""
    nd = occ.dim() - 1
    k = _ntuple(kernel_size, nd)
    ones = torch.ones((1, 1) + k, dtype=torch.float32, device=occ.device)
    y = conv(occ[:, None].to(torch.float32), ones, None, _ntuple(stride, nd),
             _ntuple(padding, nd), _ntuple(dilation, nd))
    return y[:, 0] > 0.5


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's ``nn.Dropout``: in train mode each element is kept with
    probability ``1 - rate`` (drawn from ``generator``, which train mode
    needs) and scaled by ``1 / (1 - rate)``; zeros stay zero. Identity in
    eval mode or at rate 0."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs an explicit torch.Generator "
                         "(the Trainer passes its own)")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class _ConvParams(nn.Module):
    """The parameters of one conv, as a flax ``nn.Conv`` holds them: weight
    ``[Cout, Cin, *k]`` (flax's ``[*k, Cin, Cout]`` transposed,
    ``convert.py``), bias ``[Cout]``; lecun-normal weight, zero bias."""

    def __init__(self, cin: int, cout: int, k: Tuple[int, ...], use_bias: bool,
                 generator: Optional[torch.Generator], device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin) + tuple(k), device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device)) if use_bias else None
        lecun_normal_(self.weight, cin * math.prod(k), generator)


@registry.register("spconv.SubMConv2d", aliases=("SubMConv2d",))
class SubMConv2d(nn.Module):
    """Submanifold sparse conv on the grid: stride 1, padded to keep the
    size, the output masked by the input's occupancy (which it keeps); on
    a 3D grid that carries its rows, computed over them (the module
    docstring)."""

    ndim = 2

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntPair = 3,
                 stride: IntPair = 1, padding: IntPair = 0, dilation: IntPair = 1,
                 use_bias: bool = True, indice_key: Optional[str] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.kernel_size = _ntuple(kernel_size, self.ndim)
        self.dilation = _ntuple(dilation, self.ndim)
        self.indice_key = indice_key
        self.conv = _ConvParams(in_channels, out_channels, self.kernel_size, use_bias,
                                generator, device)

    def forward(self, g: SparseGrid, generator=None) -> SparseGrid:
        begin = tracing.device_event(g.features.device)
        k, d = self.kernel_size, self.dilation
        # spconv pads a SubM conv to keep the size, whatever padding it got
        p = tuple(((ki - 1) * di) // 2 for ki, di in zip(k, d))
        one = (1,) * self.ndim
        if self._takes_rows(g):
            tracing.count("grid.subm_rows")
            y, c = self._rows_forward(g)
        else:
            tracing.count("grid.subm_dense")
            c = conv(g.masked(), self.conv.weight, self.conv.bias, one, p, d)
            y = c * g.occupancy[:, None].to(c.dtype)
        _trace(self, begin, y, c)
        return g.with_features(y, save_key=self.indice_key, save_geom=(k, one, p, d))

    def _takes_rows(self, g: SparseGrid) -> bool:
        """Whether the conv runs over the grid's rows: a 3D grid that
        carries them, float32 features (a bf16 grid keeps the dense conv's
        rounding points), an odd cubic window and no dilation."""
        k = self.kernel_size
        return (g.rows is not None and self.ndim == 3 and g.features.dtype == torch.float32
                and k[0] % 2 == 1 and len(set(k)) == 1 and set(self.dilation) == {1})

    def _rows_forward(self, g: SparseGrid) -> Tuple[torch.Tensor, torch.Tensor]:
        """The conv over the occupied sites: the rows' features gathered
        from the channels-last grid, K1 over the grid's K³-tap plan
        (``SubMConvRows``: K4 and, where the input needs it, K1 again in
        the backward; their plain versions off the card), and the output
        rows added into a zeroed channels-last grid at their sites. Rows
        that are not live read and add at site 0: the plan names none of
        them and their outputs are zero. Returns that grid's ``[B, Cout,
        *S]`` view and K1's rows."""
        rows, x = g.rows, g.features
        cin, k = x.shape[1], self.kernel_size[0]
        weight = self.conv.weight.to(x.dtype)
        cout = weight.shape[0]
        flat = x.movedim(1, -1).reshape(-1, cin)
        site = torch.where(rows.live, rows.site, 0)
        # tap (dx, dy, dt) reads weight[:, :, dx + h, dy + h, dt + h]
        kernel = weight.permute(2, 3, 4, 1, 0).reshape(k ** 3, cin, cout).contiguous()
        bias = self.conv.bias.to(x.dtype) if self.conv.bias is not None else None
        out = SubMConvRows.apply(flat.index_select(0, site), rows.plan(k), kernel, bias,
                                 rows.live, not x.is_cuda)
        y = out.new_zeros(flat.shape[0], cout).index_add(0, site, out)
        return y.view(x.shape[0], *x.shape[2:], cout).movedim(-1, 1), out


@registry.register("spconv.SparseConv2d", aliases=("SparseConv2d",))
class SparseConv2d(nn.Module):
    """Regular sparse conv on the grid: the occupancy dilates (and strides
    down) and masks the output; with ``indice_key`` the input's occupancy
    and this conv's geometry are saved for the paired inverse conv."""

    ndim = 2

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntPair = 3,
                 stride: IntPair = 1, padding: IntPair = 0, dilation: IntPair = 1,
                 use_bias: bool = True, indice_key: Optional[str] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        nd = self.ndim
        self.kernel_size, self.stride = _ntuple(kernel_size, nd), _ntuple(stride, nd)
        self.padding, self.dilation = _ntuple(padding, nd), _ntuple(dilation, nd)
        self.indice_key = indice_key
        self.conv = _ConvParams(in_channels, out_channels, self.kernel_size, use_bias,
                                generator, device)

    def forward(self, g: SparseGrid, generator=None) -> SparseGrid:
        begin = tracing.device_event(g.features.device)
        k, s, p, d = self.kernel_size, self.stride, self.padding, self.dilation
        c = conv(g.masked(), self.conv.weight, self.conv.bias, s, p, d)
        new_occ = dilate_occupancy(g.occupancy, k, s, p, d)
        y = c * new_occ[:, None].to(c.dtype)
        _trace(self, begin, y, c)
        keys, geoms = dict(g.indice_occ), dict(g.indice_geom)
        if self.indice_key is not None:
            keys[self.indice_key] = g.occupancy
            geoms[self.indice_key] = (k, s, p, d)
        return SparseGrid(y, new_occ, keys, geoms)


@registry.register("spconv.SparseInverseConv2d", aliases=("SparseInverseConv2d",))
class SparseInverseConv2d(nn.Module):
    """The transposed conv of the forward conv paired by ``indice_key``,
    restoring the occupancy (and size) saved under that key:
    ``out[i] = Σ_{j, t: i = j·s + t·d − p} w[t]·x[j]`` with the paired
    conv's stride s, padding p and dilation d (a stride-1 "same" pairing
    where the key has no recorded geometry).

    Weight ``[Cin, Cout, *k]`` (``conv_transpose2d``'s layout: the JAX
    package's ``kernel [*k, Cin, Cout]``, which its forward flips,
    unflipped and transposed, ``convert.py``), bias ``[Cout]``. The conv
    runs without padding, over the whole span ``(o − 1)·s + d·(k − 1) + 1``
    of each axis, and positions ``p .. p + target`` of it are kept, zeros
    appended where the target is longer: that covers the floor-cut tail of
    a strided pairing, which ``conv_transpose2d``'s ``output_padding`` can
    express only below ``max(s, d)``."""

    ndim = 2

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntPair = 3,
                 indice_key: str = "", use_bias: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.kernel_size = _ntuple(kernel_size, self.ndim)
        self.indice_key = indice_key
        k = self.kernel_size
        self.weight = nn.Parameter(torch.empty((in_channels, out_channels) + k, device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device)) if use_bias else None
        lecun_normal_(self.weight, in_channels * math.prod(k), generator)

    def forward(self, g: SparseGrid, generator=None) -> SparseGrid:
        if self.indice_key not in g.indice_occ:
            raise ValueError(f"indice_key '{self.indice_key}' not found; have "
                             f"{list(g.indice_occ)}")
        begin = tracing.device_event(g.features.device)
        prev_occ = g.indice_occ[self.indice_key]
        k = self.kernel_size
        geom = g.indice_geom.get(self.indice_key)
        if geom is None:
            s, p, d = (1,) * self.ndim, tuple((ki - 1) // 2 for ki in k), (1,) * self.ndim
        else:
            k_f, s, p, d = geom
            if tuple(k_f) != k:
                raise ValueError(f"kernel_size {k} != paired conv kernel {tuple(k_f)} for "
                                 f"indice_key '{self.indice_key}' (spconv requires them equal)")
        c = y = conv(g.masked(), self.weight, None, s, (0,) * self.ndim, d, transposed=True)
        for axis, (pi, target) in enumerate(zip(p, prev_occ.shape[1:])):
            dim = 2 + axis
            y = y.narrow(dim, pi, max(0, min(target, y.shape[dim] - pi)))
            if y.shape[dim] < target:
                pad = [0, 0] * (y.dim() - dim - 1) + [0, target - y.shape[dim]]
                y = nn.functional.pad(y, pad)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype).view((-1,) + (1,) * self.ndim)
        y = y * prev_occ[:, None].to(y.dtype)
        _trace(self, begin, y, c)
        return SparseGrid(y, prev_occ, dict(g.indice_occ), dict(g.indice_geom))


class MaskedBatchNorm(MaskedArrayBatchNorm):
    """BatchNorm over the grid's active sites only (spconv's BatchNorm1d
    over the active rows): the statistics of ``MaskedArrayBatchNorm`` (in
    float32, the running variance unbiased) over the sites as rows, the
    output masked by the occupancy."""

    def forward(self, g: SparseGrid, generator=None) -> SparseGrid:
        x = g.features
        c = x.shape[1]
        rows = x.movedim(1, -1).reshape(-1, c)
        y = super().forward(rows, g.occupancy.reshape(-1))
        y = y.view(x.shape[0], *x.shape[2:], c).movedim(-1, 1)
        return g.with_features(y * g.occupancy[:, None].to(y.dtype))


class SparseReLU(nn.Module):
    def forward(self, g: SparseGrid, generator=None) -> SparseGrid:
        return g.with_features(torch.relu(g.features))


class SparseDropout(nn.Module):
    """``dropout`` over the grid's features (zeros stay zero, so no
    re-mask); train mode draws from the ``generator`` it is given."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, g: SparseGrid, generator=None) -> SparseGrid:
        return g.with_features(dropout(g.features, self.rate, self.training, generator))


class SparseActivation(nn.Module):
    """Any elementwise activation over the grid, re-masked after it (an
    activation with f(0) != 0 must not light up empty sites)."""

    def __init__(self, fn: Any):
        super().__init__()
        self.fn = fn

    def forward(self, g: SparseGrid, generator=None) -> SparseGrid:
        return g.with_features(self.fn(g.features) * g.occupancy[:, None].to(g.features.dtype))


@registry.register("spconv.ToDense", aliases=("ToDense", "sparseconvnet.SparseToDense"))
class ToDense(nn.Module):
    """``spconv.ToDense``: the masked features, ``[B, C, NX, NY]`` (``[B,
    C, NX, NY, T]`` in 3D)."""

    def forward(self, g: SparseGrid, generator=None) -> torch.Tensor:
        return g.masked()


@registry.register("spconv.SparseSequential",
                   aliases=("SparseSequential", "sparseconvnet.Sequential"))
class SparseSequential(nn.Module):
    """The layers in order (``spconv.SparseSequential``), named
    ``layers_<i>`` as flax names a module's list of submodules."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.n = len(layers)
        for i, layer in enumerate(layers):
            self.add_module(f"layers_{i}", layer)

    def forward(self, g, generator=None):
        for i in range(self.n):
            g = getattr(self, f"layers_{i}")(g, generator)
        return g


@registry.register("spconv.SubMConv3d", aliases=("SubMConv3d",))
class SubMConv3d(SubMConv2d):
    """``SubMConv2d`` over the (x, y, t) grid: weight ``[Cout, Cin, kx, ky, kt]``."""

    ndim = 3


@registry.register("spconv.SparseConv3d", aliases=("SparseConv3d",))
class SparseConv3d(SparseConv2d):
    """``SparseConv2d`` over the (x, y, t) grid."""

    ndim = 3


@registry.register("spconv.SparseInverseConv3d", aliases=("SparseInverseConv3d",))
class SparseInverseConv3d(SparseInverseConv2d):
    """``SparseInverseConv2d`` over the (x, y, t) grid."""

    ndim = 3
