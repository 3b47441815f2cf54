"""Dense building blocks (counterpart of waveformml_tpu/models/blocks.py):
masked BatchNorm, the site-folded first Linear layer, the geometric and the
explicit-plane Linear stacks, the pointwise reducer, the weight-normed
causal TCN, the dilated and the expand/contract 1D conv stacks and the
dense 2D conv stack.

The convs run in PyTorch's channels-first layout (``[N, C, L]``, ``[B, C,
H, W]``) through ``ops.sparse_conv.conv`` (float32 without TF32, as the
JAX package's XLA convs); their channel schedules are copied from the JAX
package as they are, so that a config gives the same layers.
"""
from __future__ import annotations

import math
from math import ceil, floor
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.models.schedules import get_frame_contraction, get_frame_expansion
from waveformml_tpu_torch.nn.bn import all_reduce_sum, get_bn_group
from waveformml_tpu_torch.ops.site_head import SiteGroupedMatmul
from waveformml_tpu_torch.ops.sparse import SparseBatch
from waveformml_tpu_torch.parallel.gspmd import copy_to_model, gather_from_model


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
    (Bessel) one. Under a BatchNorm group (``nn.bn``) the count and sums
    are the group's. In eval mode
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
        """``x`` is ``[N, C]``, or ``[N, C, *S]`` (channels first) whose
        every position of a row is a real element where the row is real
        (``mask [N]``)."""
        if x.dim() > 2:
            rows = x.movedim(1, -1)
            shape = rows.shape
            if mask is not None:
                mask = mask.reshape((-1,) + (1,) * (x.dim() - 2)).expand(shape[:-1])
                mask = mask.reshape(-1)
            return self.forward(rows.reshape(-1, shape[-1]), mask).view(shape).movedim(-1, 1)
        if not self.training:
            scale = torch.rsqrt(self.running_var + self.eps)
            return (x - self.running_mean) * scale * self.weight + self.bias
        if mask is None:
            raise ValueError("MaskedArrayBatchNorm needs the row mask in train mode")
        m = mask.to(torch.float32)[:, None]
        xf = x.float()
        count, xsum = m.sum(), (xf * m).sum(0)
        if get_bn_group() is not None:
            # the group's sums, before the count is clamped: an empty shard
            # adds zeros, not a count of 1
            both = all_reduce_sum(torch.cat([count[None], xsum]))
            count, xsum = both[0], both[1:]
        count = count.clamp(min=1.0)
        mean = xsum / count
        vsum = all_reduce_sum(((xf - mean) ** 2 * m).sum(0))
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

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
        return x


class LinearPlanes(nn.Module):
    """Linear layers ``dense_i`` through an explicit plane list, the
    activation (where given) after every layer, the last one included."""

    def __init__(self, planes: Sequence[float], activation=None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.n = len(planes) - 1
        self.activation = activation
        width = int(round(planes[0]))
        for i in range(self.n):
            out = int(round(planes[i + 1]))
            layer = nn.Linear(width, out, device=device)
            lecun_normal_(layer.weight, width, generator)
            nn.init.zeros_(layer.bias)
            self.add_module(f"dense_{i}", layer)
            width = out

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if self.activation is not None:
                x = self.activation(x)
        return x


class PointwiseReducer(nn.Module):
    """1×1 plane reduction: ``pw_i`` (a Linear without bias over the
    channels) and ReLU per plane. Input ``[N, C, L]``."""

    def __init__(self, planes: Sequence[float], generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.n = len(planes) - 1
        width = int(round(planes[0]))
        for i in range(self.n):
            out = int(round(planes[i + 1]))
            layer = nn.Linear(width, out, bias=False, device=device)
            lecun_normal_(layer.weight, width, generator)
            self.add_module(f"pw_{i}", layer)
            width = out

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        x = x.movedim(1, -1)
        for i in range(self.n):
            x = torch.relu(getattr(self, f"pw_{i}")(x))
        return x.movedim(-1, 1)


class FoldedSiteLinear(nn.Module):
    """``Linear(flatten([B, C, NX, NY]))`` computed over the active rows only.

    The weight is ``[C·S, F]`` with row index ``c·S + x·NY + y`` (S = NX·NY),
    so it is interchangeable with a Linear over the flattened dense grid.
    Only the ``bysite`` mode is ported: the site-grouped GEMM over the host
    slot layout in ``batch.plans`` (kernel K2, its gradient kernel K5).
    ``plain = True`` runs the plain PyTorch versions of both whatever the
    device, as a reference on the card.

    Under tensor parallelism (``tp``, a ``parallel.gspmd.Mesh2D`` that
    ``TensorParallel`` sets) the weight is this rank's column block ``[C·S,
    F/tp]``: K2 runs on it without the bias, the blocks are gathered over
    the model group and the whole bias is added; in the backward K5's
    d_rows of the block is summed over the group.
    """

    tp = None

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
        k3 = self.weight.view(self.cin, NX * NY, -1)
        if self.tp is None:
            return SiteGroupedMatmul.apply(rows, k3, self.bias, plans["site_take"],
                                           plans["site_ev"], plans["site_s"], batch.n_events,
                                           self.plain)
        out = SiteGroupedMatmul.apply(copy_to_model(rows, self.tp), k3, None,
                                      plans["site_take"], plans["site_ev"], plans["site_s"],
                                      batch.n_events, self.plain)
        return gather_from_model(out, self.tp) + self.bias


class TemporalBlock(nn.Module):
    """TCN residual block: two weight-normed causal dilated convs (each
    input left-padded by ``(k - 1)·dilation``), each followed by ReLU and
    dropout, a 1×1 ``downsample`` of the input where the widths differ,
    and a ReLU over the sum. Input ``[N, C, L]``.

    ``conv1`` and ``conv2`` carry torch's weight-norm parametrisation over
    ``dim=0`` (``original0`` the scale ``g [Cout, 1, 1]``, ``original1``
    the direction ``v [Cout, Cin, k]``), the counterpart of flax's
    ``nn.WeightNorm`` (``WeightNorm_i/conv<j>/kernel/scale`` beside
    ``conv<j>/kernel``, normalised over every axis but the output one);
    as flax initialises them, ``v`` is drawn from N(0, 0.01) and ``g`` is
    one."""

    def __init__(self, n_inputs: int, n_outputs: int, kernel_size: int, dilation: int,
                 dropout: float = 0.2, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        from torch.nn.utils.parametrizations import weight_norm

        # ops.sparse_conv imports this module: import it when a block is built
        from waveformml_tpu_torch.ops.sparse_conv import _ConvParams

        self.pad = (kernel_size - 1) * dilation
        self.dilation = dilation
        self.dropout = float(dropout or 0.0)
        for name, cin in (("conv1", n_inputs), ("conv2", n_outputs)):
            layer = _ConvParams(cin, n_outputs, (kernel_size,), True, generator, device)
            with torch.no_grad():
                layer.weight.normal_(0.0, 0.01, generator=generator)
            layer = weight_norm(layer, dim=0)
            with torch.no_grad():
                layer.parametrizations.weight.original0.fill_(1.0)
            self.add_module(name, layer)
        self.downsample = None
        if n_inputs != n_outputs:
            self.downsample = _ConvParams(n_inputs, n_outputs, (1,), True, generator, device)
            with torch.no_grad():
                self.downsample.weight.normal_(0.0, 0.01, generator=generator)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        from waveformml_tpu_torch.ops.sparse_conv import conv, dropout

        out = x
        for layer in (self.conv1, self.conv2):
            out = nn.functional.pad(out, (self.pad, 0))
            out = torch.relu(conv(out, layer.weight, layer.bias, (1,), (0,), (self.dilation,)))
            out = dropout(out, self.dropout, self.training, generator)
        res = x
        if self.downsample is not None:
            res = conv(x, self.downsample.weight, self.downsample.bias, (1,), (0,), (1,))
        return torch.relu(out + res)


class TemporalConvNet(nn.Module):
    """Dilated TCN, ``tblock_i`` of dilation 2^i. Input ``[N, C, L]``."""

    def __init__(self, num_inputs: int, num_channels: Sequence[int], kernel_size: int = 3,
                 dropout: float = 0.2, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.n = len(num_channels)
        for i, ch in enumerate(num_channels):
            nin = num_inputs if i == 0 else num_channels[i - 1]
            self.add_module(f"tblock_{i}", TemporalBlock(nin, ch, kernel_size, 2 ** i,
                                                         dropout, generator, device))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"tblock_{i}")(x, generator)
        return x


class _Conv1DStack(nn.Module):
    """``conv_i`` (weight ``[Cout, Cin, k]``), ``MaskedArrayBatchNorm``
    ``bn_i`` and ReLU per layer of ``self.layers`` ((cin, cout, k, stride,
    pad, dilation) each). Input ``[N, C, L]``. Without a mask the BatchNorm
    takes its statistics over every row, the bucket's padding rows
    included, as the JAX package's does when its net passes none
    (``ConvWaveformNet``). The first conv takes ``in_width`` channels where
    given (flax infers a conv's input width from its input)."""

    def _build(self, in_width: Optional[int], generator, device) -> None:
        from waveformml_tpu_torch.ops.sparse_conv import _ConvParams

        for i, (cin, cout, fs, _, _, _) in enumerate(self.layers):
            if i == 0 and in_width is not None:
                cin = in_width
            self.add_module(f"conv_{i}", _ConvParams(cin, cout, (fs,), True, generator,
                                                     device))
            self.add_module(f"bn_{i}", MaskedArrayBatchNorm(cout, device=device))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator=None) -> torch.Tensor:
        from waveformml_tpu_torch.ops.sparse_conv import conv

        if mask is None:
            mask = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        for i, (_, _, _, st, pd, dil) in enumerate(self.layers):
            layer = getattr(self, f"conv_{i}")
            x = conv(x, layer.weight, layer.bias, (st,), (pd,), (dil,))
            x = torch.relu(getattr(self, f"bn_{i}")(x, mask))
        return x


class DilationBlock(_Conv1DStack):
    """Dilated 1D conv stack with linear channel interpolation."""

    def __init__(self, nin: int, nout: int, n: int, length: int, size_factor: int = 3,
                 pad_factor: float = 0, stride_factor: int = 1, dil_factor: float = 2.0,
                 generator: Optional[torch.Generator] = None, device=None,
                 in_width: Optional[int] = None):
        super().__init__()
        self.length = length
        self.layers = self.schedule(nin, nout, n, size_factor, pad_factor, stride_factor,
                                    dil_factor)
        self._build(in_width, generator, device)

    @staticmethod
    def schedule(nin, nout, n, size_factor=3, pad_factor=0, stride_factor=1,
                 dil_factor=2.0) -> List[Tuple[int, int, int, int, int, int]]:
        if nin != nout:
            diff = float(nin - nout) / n
            nframes = [int(floor(nin - diff * i)) for i in range(n + 1)]
        else:
            nframes = [nin] * (n + 1)
        out = []
        for i in range(n):
            fs = max(3, int(floor(size_factor / (i + 1.0))))
            st = max(1, stride_factor - int(floor((stride_factor - 1) / (i + 1.0))))
            dil = int(round(dil_factor ** i))
            pd = int(floor(pad_factor * (fs - 1) * dil_factor))
            out.append((nframes[i], nframes[i + 1], fs, st, pd, dil))
        return out

    def out_length(self) -> int:
        length = self.length
        for (_, _, fs, st, pd, dil) in self.layers:
            length = (length + 2 * pd - fs - (fs - 1) * (dil - 1)) // st + 1
        return int(length)


class Conv1DNet(_Conv1DStack):
    """Expand/contract 1D CNN."""

    def __init__(self, length: int, num_channels: int, out_size: int, num_expand: int,
                 num_contract: int, expand_factor: float, size_factor: int = 3,
                 pad_factor: float = 1, stride_factor: float = 0, min_kernel: int = 2,
                 generator: Optional[torch.Generator] = None, device=None,
                 in_width: Optional[int] = None):
        super().__init__()
        layers, self.out_len = self.schedule(length, num_channels, out_size, num_expand,
                                             num_contract, expand_factor, size_factor,
                                             pad_factor, stride_factor, min_kernel)
        self.layers = [(cin, cout, fs, st, pd, 1) for cin, cout, fs, st, pd in layers]
        self._build(in_width, generator, device)

    @staticmethod
    def schedule(length, num_channels, out_size, num_expand, num_contract,
                 expand_factor, size_factor=3, pad_factor=1, stride_factor=0,
                 min_kernel=2):
        planes = [num_channels]
        if num_expand > 0:
            expand = float((planes[0] * expand_factor - planes[0]) / num_expand)
            planes += [int(round(planes[0] + expand * (i + 1))) for i in range(num_expand)]
        contract_factor = float((planes[-1] - out_size) / num_contract)
        start_n = planes[-1]
        planes += [int(round(start_n - contract_factor * (i + 1))) for i in range(num_contract)]
        planes[-1] = out_size
        n = num_expand + num_contract
        layers, out_len = [], length
        for i in range(n):
            if n > 1:
                decay = 1.0 - i / (n - 1)
                st = int(round(stride_factor * i / (n - 1)))
            else:
                decay, st = 1.0, int(stride_factor)
            st = max(1, st)
            fs = max(min_kernel, int(ceil(size_factor * decay)))
            pd = int(round(pad_factor * ((fs - 1) / 2.0) * decay))
            layers.append((planes[i], planes[i + 1], fs, st, pd))
            out_len = int((out_len + 2 * pd - fs) / st + 1)
        return layers, out_len

    def out_shape(self) -> Tuple[int, int]:
        return self.out_len, self.layers[-1][1]


class Conv2DBlock(nn.Module):
    """Dense 2D conv stack, the dense analog of ``SparseConv2DBlock``:
    ``conv_i`` (weight ``[Cout, Cin, k, k]``), masked BatchNorm ``bn_i``
    (statistics over the sites of the real events, ``mask [B]``), ReLU and
    dropout per layer. Input ``[B, C, H, W]``."""

    def __init__(self, nin: int, nout: int, n: int, size: Sequence[int],
                 size_factor: int = 3, pad_factor: float = 0.0, stride_factor: float = 1.0,
                 dil_factor: float = 1.0, expansion_factor: float = 1.0,
                 n_expansion: int = 0, pointwise_factor: float = 0.0,
                 dropout: Optional[float] = None,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        from waveformml_tpu_torch.ops.sparse_conv import _ConvParams

        self.size = list(size)
        self.dropout = float(dropout or 0.0)
        self.layers = self.schedule(nin, nout, n, size_factor, pad_factor, stride_factor,
                                    dil_factor, expansion_factor, n_expansion,
                                    pointwise_factor)
        for i, (cin, cout, fs, _, _, _) in enumerate(self.layers):
            self.add_module(f"conv_{i}", _ConvParams(cin, cout, (fs, fs), True, generator,
                                                     device))
            self.add_module(f"bn_{i}", MaskedArrayBatchNorm(cout, device=device))

    @staticmethod
    def schedule(nin, nout, n, size_factor=3, pad_factor=0.0, stride_factor=1.0,
                 dil_factor=1.0, expansion_factor=1.0, n_expansion=0,
                 pointwise_factor=0.0) -> List[Tuple[int, int, int, int, int, int]]:
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
        layers = []
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
            layers.append((nframes[i], nframes[i + 1], fs, st, pd, dil))
        return layers

    def out_size(self) -> List[int]:
        size = list(self.size)
        for (cin, cout, fs, st, pd, dil) in self.layers:
            size = [int((size[0] + 2 * pd - fs - (fs - 1) * (dil - 1)) / st + 1),
                    int((size[1] + 2 * pd - fs - (fs - 1) * (dil - 1)) / st + 1),
                    cout]
        return size

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator=None) -> torch.Tensor:
        from waveformml_tpu_torch.ops.sparse_conv import conv, dropout

        for i, (_, _, _, st, pd, dil) in enumerate(self.layers):
            layer = getattr(self, f"conv_{i}")
            x = conv(x, layer.weight, layer.bias, (st, st), (pd, pd), (dil, dil))
            x = torch.relu(getattr(self, f"bn_{i}")(x, mask))
            x = dropout(x, self.dropout, self.training, generator)
        return x
