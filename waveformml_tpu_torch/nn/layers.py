"""Layers under the torch class names of the config ``algorithm`` DSL
(counterpart of waveformml_tpu/nn/layers.py): the names and aliases the
JAX package registers ("nn.Linear", "nn.Conv1d", "nn.ReLU", ...), built
from the same positional or keyword arguments.

The layers run in PyTorch's channels-first layout (``[B, C, L]``, ``[B,
C, H, W]``), where the JAX package's run channels-last; a torch ``dim``
(``Softmax``, ``LogSoftmax``) and a ``LayerNorm``'s ``normalized_shape``
mean what torch means by them in both. Each parametric layer holds its parameters under the name its
flax module gives them (``dense``, ``conv``, ``bn``, ``LayerNorm_0``), so
that ``convert.py`` carries them path for path. Each layer is called as
``layer(x, generator)``: dropout in train mode draws from ``generator``.
The recurrent layers (``nn.RNN``, ``nn.GRU``, ``nn.LSTM``) take ``[B, L,
C]`` as the JAX package's do, and run torch's recurrences in float32
without TF32, forward and backward (``run_recurrence``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from waveformml_tpu_torch.models.blocks import lecun_normal_
from waveformml_tpu_torch.nn.bn import all_reduce_sum, bn_world_size
from waveformml_tpu_torch.ops.sparse_conv import _ConvParams, conv, dropout, ieee_fp32
from waveformml_tpu_torch.registry import registry

IntOrPair = Union[int, Sequence[int]]


def _pair(v: IntOrPair) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)  # type: ignore[return-value]
    return int(v), int(v)


@registry.register("Linear", aliases=("nn.Linear",))
class Linear(nn.Module):
    """torch ``nn.Linear(in_features, out_features, bias=True)``, its
    parameters under ``dense``; lecun-normal weight, zero bias (flax's
    ``nn.Dense``)."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True):
        super().__init__()
        self.dense = nn.Linear(in_features, out_features, bias=use_bias)
        lecun_normal_(self.dense.weight, in_features)
        if use_bias:
            nn.init.zeros_(self.dense.bias)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return self.dense(x)


@registry.register("Conv1d", aliases=("nn.Conv1d",))
class Conv1d(nn.Module):
    """torch ``nn.Conv1d(nin, nout, k, stride, padding, dilation, groups)``
    on ``[B, C, L]``, its parameters under ``conv``, in float32 without
    TF32."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1, groups: int = 1,
                 use_bias: bool = True):
        super().__init__()
        self.geometry = ((int(stride),), (int(padding),), (int(dilation),))
        self.groups = groups
        self.conv = _ConvParams(in_channels // groups, out_channels, (int(kernel_size),),
                                use_bias, None, None)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return conv(x, self.conv.weight, self.conv.bias, *self.geometry, groups=self.groups)


@registry.register("Conv2d", aliases=("nn.Conv2d",))
class Conv2d(nn.Module):
    """torch ``nn.Conv2d`` on ``[B, C, H, W]``, its parameters under
    ``conv``, in float32 without TF32."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntOrPair,
                 stride: IntOrPair = 1, padding: IntOrPair = 0, dilation: IntOrPair = 1,
                 groups: int = 1, use_bias: bool = True):
        super().__init__()
        self.geometry = (_pair(stride), _pair(padding), _pair(dilation))
        self.groups = groups
        self.conv = _ConvParams(in_channels // groups, out_channels, _pair(kernel_size),
                                use_bias, None, None)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return conv(x, self.conv.weight, self.conv.bias, *self.geometry, groups=self.groups)


# -- activations -------------------------------------------------------------------

def _activation(name: str, fn: Callable[[torch.Tensor], torch.Tensor]):
    @registry.register(name, aliases=(f"nn.{name}",))
    class _Act(nn.Module):
        __doc__ = f"torch ``nn.{name}``: no parameters."

        def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
            return fn(x)

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _activation("ReLU", torch.relu)
SELU = _activation("SELU", torch.selu)
# jax.nn.gelu's default is the tanh approximation
GELU = _activation("GELU", lambda x: F.gelu(x, approximate="tanh"))
Tanh = _activation("Tanh", torch.tanh)
Sigmoid = _activation("Sigmoid", torch.sigmoid)
Identity = _activation("Identity", lambda x: x)


@registry.register("LeakyReLU", aliases=("nn.LeakyReLU",))
class LeakyReLU(nn.Module):
    def __init__(self, negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return F.leaky_relu(x, self.negative_slope)


@registry.register("Softmax", aliases=("nn.Softmax",))
class Softmax(nn.Module):
    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return torch.softmax(x, dim=self.dim)


@registry.register("LogSoftmax", aliases=("nn.LogSoftmax",))
class LogSoftmax(nn.Module):
    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return torch.log_softmax(x, dim=self.dim)


@registry.register("Dropout", aliases=("nn.Dropout",))
class Dropout(nn.Module):
    """flax's ``nn.Dropout`` (``ops.sparse_conv.dropout``) in train mode."""

    def __init__(self, rate: float = 0.5):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return dropout(x, self.rate, self.training, generator)


@registry.register("Flatten", aliases=("nn.Flatten",))
class Flatten(nn.Module):
    """Flattens from ``start_dim`` as the array lies: after ``ToDense``,
    where a DSL flattens, both packages hold ``[B, C, H, W]``."""

    def __init__(self, start_dim: int = 1):
        super().__init__()
        self.start_dim = start_dim

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return x.reshape(tuple(x.shape[:self.start_dim]) + (-1,))


# -- norms -------------------------------------------------------------------------

class _FlaxBatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over every axis but the channel axis (dim 1):
    in train mode the batch's mean and biased variance (E[x²] − E[x]²,
    float32) normalise it and move the running statistics by
    ``momentum``, the running variance with the biased one too; in eval
    mode the running statistics normalise it. Every element counts,
    padding included, as in the JAX package. Under a BatchNorm group
    (``nn.bn``) the mean and E[x²] are averaged over its ranks, as flax's
    ``axis_name`` averages them."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            axes = [0] + list(range(2, x.dim()))
            xf = x.float()
            mean, mean2 = xf.mean(axes), xf.square().mean(axes)
            world = bn_world_size()
            if world is not None:
                # flax's axis_name: the ranks' means averaged, the global
                # statistics only where every rank's shape is the same
                both = all_reduce_sum(torch.cat([mean, mean2])) / world
                mean, mean2 = both[:mean.shape[0]], both[mean.shape[0]:]
            var = (mean2 - mean.square()).clamp(min=0.0)
            with torch.no_grad():
                mom = self.momentum
                self.running_mean.copy_((1 - mom) * self.running_mean + mom * mean)
                self.running_var.copy_((1 - mom) * self.running_var + mom * var)
            mean, var = mean.to(x.dtype), var.to(x.dtype)
        else:
            mean, var = self.running_mean.to(x.dtype), self.running_var.to(x.dtype)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * scale.view(shape) + self.bias.view(shape)


@registry.register("BatchNorm1d", aliases=("nn.BatchNorm1d",))
class BatchNorm1d(nn.Module):
    """torch ``nn.BatchNorm1d(num_features)`` with flax's statistics
    (``_FlaxBatchNorm``), its parameters under ``bn``."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.bn = _FlaxBatchNorm(num_features, eps, momentum)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return self.bn(x)


@registry.register("BatchNorm2d", aliases=("nn.BatchNorm2d",))
class BatchNorm2d(BatchNorm1d):
    pass


@registry.register("LayerNorm", aliases=("nn.LayerNorm",))
class LayerNorm(nn.Module):
    """torch ``nn.LayerNorm(normalized_shape)``: normalises over the
    trailing ``len(normalized_shape)`` axes, with a scale and bias of that
    shape under ``LayerNorm_0``. torch makes parameters before the first
    input, so the port needs ``normalized_shape`` where flax infers it."""

    def __init__(self, normalized_shape: Any = None, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        shape = ((normalized_shape,) if isinstance(normalized_shape, int)
                 else tuple(normalized_shape or ()))
        self.normalized_shape = shape
        self.LayerNorm_0 = nn.Module()
        if shape:
            self.LayerNorm_0.weight = nn.Parameter(torch.ones(shape))
            self.LayerNorm_0.bias = nn.Parameter(torch.zeros(shape))

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        if not self.normalized_shape:
            raise ValueError("LayerNorm needs normalized_shape in the port (torch's "
                             "parameters are made before the first input)")
        return F.layer_norm(x, self.normalized_shape, self.LayerNorm_0.weight,
                            self.LayerNorm_0.bias, self.eps)


# -- pooling -----------------------------------------------------------------------

class _Pool(nn.Module):
    def __init__(self, kernel_size: IntOrPair, stride: Optional[IntOrPair] = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride or kernel_size


@registry.register("MaxPool1d", aliases=("nn.MaxPool1d",))
class MaxPool1d(_Pool):
    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return F.max_pool1d(x, self.kernel_size, self.stride)


@registry.register("AvgPool1d", aliases=("nn.AvgPool1d",))
class AvgPool1d(_Pool):
    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return F.avg_pool1d(x, self.kernel_size, self.stride)


@registry.register("MaxPool2d", aliases=("nn.MaxPool2d",))
class MaxPool2d(_Pool):
    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return F.max_pool2d(x, _pair(self.kernel_size), _pair(self.stride))


@registry.register("AvgPool2d", aliases=("nn.AvgPool2d",))
class AvgPool2d(_Pool):
    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        return F.avg_pool2d(x, _pair(self.kernel_size), _pair(self.stride))


# -- recurrent ---------------------------------------------------------------------

@contextlib.contextmanager
def _cudnn_off():
    """PyTorch's own recurrence (its per-step ops) instead of cuDNN's
    inside the block."""
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


class _IEEERecurrence(torch.autograd.Function):
    """One torch recurrent module over ``x``, its forward and its backward
    each inside ``ieee_fp32``: autograd runs the backward later, outside
    any block the forward ran in, so the forward keeps the graph of its own
    call and the backward differentiates that graph inside the block.
    ``params`` are the module's parameters, for autograd to route their
    gradients; ``keep`` masks their gradients (None: kept whole);
    ``native`` runs PyTorch's own recurrence instead of cuDNN's."""

    @staticmethod
    def forward(ctx, cell, keep, native, x, *params):
        with torch.enable_grad(), ieee_fp32(), (_cudnn_off() if native
                                                else contextlib.nullcontext()):
            inner = x.detach().requires_grad_(x.requires_grad)
            out = cell(inner)[0]
        ctx.graph = (inner, out, params, keep)
        return out.detach()

    @staticmethod
    def backward(ctx, g):
        inner, out, params, keep = ctx.graph
        wrt = [t for t in (inner, *params) if t.requires_grad]
        with ieee_fp32():
            grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
        grads = [next(grads) if t.requires_grad else None for t in (inner, *params)]
        for i, mask in enumerate(keep):
            if mask is not None and grads[i + 1] is not None:
                grads[i + 1] = grads[i + 1] * mask
        return (None, None, None) + tuple(grads)


def run_recurrence(cell: nn.RNNBase, x: torch.Tensor) -> torch.Tensor:
    """The outputs ``[B, L, H]`` of a batch-first one-layer torch recurrent
    module over ``x [B, L, C]`` from a zero state, in float32 without TF32,
    forward and backward.

    Under autograd a ReLU cell runs PyTorch's own recurrence, not cuDNN's:
    cuDNN's backward differentiates ReLU at 0 otherwise than autograd,
    flax and the JAX package (which take 0 there), and a zero pre-activation
    is common (zero biases at initialisation, waveforms clipped at 0), so
    its bias gradients part from the reference's by several percent. The
    forward alone (serving) stays on cuDNN: ReLU(0) is 0 either way.

    flax's cells have one bias a gate where torch's have two
    (``convert.py``): the recurrent bias gets no gradient (it stays as
    loaded, zero), but for a GRU's n gate, whose recurrent bias flax keeps
    apart (``hn``), so that an optimizer moves each gate's bias as it moves
    flax's one."""
    params = tuple(cell.parameters())
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params)):
        hidden = cell.hidden_size
        mask = torch.zeros(cell.bias_hh_l0.shape, dtype=x.dtype, device=x.device)
        if isinstance(cell, nn.GRU):
            mask[2 * hidden:] = 1.0
        keep = [mask if p is cell.bias_hh_l0 else None for p in params]
        native = isinstance(cell, nn.RNN) and cell.nonlinearity == "relu"
        return _IEEERecurrence.apply(cell, keep, native, x, *params)
    with ieee_fp32():
        return cell(x)[0]


#: torch's recurrent module of each cell kind, and its gates a layer
_CELLS = {"RNN": (nn.RNN, 1), "GRU": (nn.GRU, 3), "LSTM": (nn.LSTM, 4)}


class RecurrentStack(nn.Module):
    """``num_layers`` recurrent layers of one cell kind ("RNN", "GRU",
    "LSTM") on ``[B, L, C]``, each a one-layer batch-first torch module
    ``cell_<l>`` (flax's ``cell_<l>`` beside it: ``convert.py`` maps the
    gates), from a zero state, with ``dropout`` between layers in train
    mode. Initialised as flax's cells are: the input kernels
    lecun-normal, each gate's recurrent kernel orthogonal, the biases
    zero."""

    kind = "RNN"

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 nonlinearity: str = "tanh", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        cls, gates = _CELLS[self.kind]
        kwargs = {"nonlinearity": nonlinearity} if self.kind == "RNN" else {}
        self.n = num_layers
        self.dropout = float(dropout or 0.0)
        width = input_size
        for layer in range(num_layers):
            cell = cls(width, hidden_size, 1, batch_first=True, device=device, **kwargs)
            with torch.no_grad():
                lecun_normal_(cell.weight_ih_l0, width, generator)
                for block in cell.weight_hh_l0.split(hidden_size):
                    nn.init.orthogonal_(block, generator=generator)
                cell.bias_ih_l0.zero_()
                cell.bias_hh_l0.zero_()
            self.add_module(f"cell_{layer}", cell)
            width = hidden_size

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        for layer in range(self.n):
            x = run_recurrence(getattr(self, f"cell_{layer}"), x)
            if layer < self.n - 1:
                x = dropout(x, self.dropout, self.training, generator)
        return x


@registry.register("RNNLayer", aliases=("nn.RNN",))
class RNNLayer(RecurrentStack):
    """torch ``nn.RNN(input_size, hidden_size, num_layers, nonlinearity)``
    with ``batch_first=True``."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 nonlinearity: str = "tanh"):
        super().__init__(input_size, hidden_size, num_layers, nonlinearity)


@registry.register("GRULayer", aliases=("nn.GRU",))
class GRULayer(RecurrentStack):
    """torch ``nn.GRU(input_size, hidden_size, num_layers)``, batch first."""

    kind = "GRU"

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1):
        super().__init__(input_size, hidden_size, num_layers)


@registry.register("LSTMLayer", aliases=("nn.LSTM",))
class LSTMLayer(RecurrentStack):
    """torch ``nn.LSTM(input_size, hidden_size, num_layers)``, batch first."""

    kind = "LSTM"

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1):
        super().__init__(input_size, hidden_size, num_layers)
