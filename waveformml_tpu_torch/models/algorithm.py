"""The config ``algorithm`` DSL (counterpart of
waveformml_tpu/models/algorithm.py).

A DSL list alternates class names and their arguments. ``split_algorithm``
cuts it as the JAX package does: a leading run of "nn.*" layers starting
with "nn.Conv1d" is the per-waveform section, everything up to the first
"nn.Linear" the sparse section, the rest the linear head. Inside the sparse
section the dense names "nn.BatchNorm1d", "nn.ReLU", "nn.Dropout", ...
become their grid forms (``_SPARSE_TRANSLATIONS``: masked BatchNorm over
the active sites, re-masked activations). ``dsl_to_row_specs`` turns a
pure-SubM section into ``_SpecNet`` specs, so that it runs in row space
(``SCNet`` does so in 2D; a 3D section's specs build
``DSLSpecNet(n_t=…)``). The SparseConvNet names take that library's positional arguments
``(dimension, nin, nout, filter_size[, stride], bias)``: adapters map them
onto the grid convs.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

import waveformml_tpu_torch.nn.layers  # noqa: F401  (registers the DSL's dense layers)
from waveformml_tpu_torch.ops.sparse_conv import (MaskedBatchNorm, SparseActivation,
                                                  SparseConv2d, SparseConv3d, SparseDropout,
                                                  SparseGrid, SparseReLU, SubMConv2d,
                                                  SubMConv3d)
from waveformml_tpu_torch.registry import registry


@registry.register("sparseconvnet.Convolution", aliases=("scn.Convolution",))
class SCNConvolution(nn.Module):
    """``sparseconvnet.Convolution(dim, nin, nout, fs, stride, bias)``: a
    regular sparse conv without padding (over 3 axes where ``dim`` is 3),
    under ``conv``."""

    def __init__(self, dimension: int, nin: int, nout: int, filter_size: int,
                 filter_stride: int = 1, use_bias: bool = True):
        super().__init__()
        cls = SparseConv3d if int(dimension) == 3 else SparseConv2d
        self.conv = cls(nin, nout, filter_size, filter_stride, 0, 1, use_bias=use_bias)

    def forward(self, g: SparseGrid, generator=None) -> SparseGrid:
        return self.conv(g)


@registry.register("sparseconvnet.SubmanifoldConvolution",
                   aliases=("scn.SubmanifoldConvolution",))
class SCNSubmanifoldConvolution(nn.Module):
    """``sparseconvnet.SubmanifoldConvolution(dim, nin, nout, fs, bias)``:
    a SubM conv (over 3 axes where ``dim`` is 3), under ``conv``."""

    def __init__(self, dimension: int, nin: int, nout: int, filter_size: int,
                 use_bias: bool = True):
        super().__init__()
        cls = SubMConv3d if int(dimension) == 3 else SubMConv2d
        self.conv = cls(nin, nout, filter_size, use_bias=use_bias)

    def forward(self, g: SparseGrid, generator=None) -> SparseGrid:
        return self.conv(g)


def split_algorithm(algorithm: Sequence[Any]) -> Tuple[List[Any], List[Any], List[Any]]:
    """The DSL list as (waveform section, sparse section, linear head)."""
    sparse_funcs: List[Any] = []
    linear_funcs: List[Any] = []
    waveform_funcs: List[Any] = []
    has_wf = False
    for i, f in enumerate(algorithm):
        if i == 0 and isinstance(f, str) and f == "nn.Conv1d":
            has_wf = True
            waveform_funcs.append(f)
            continue
        if has_wf:
            if isinstance(f, str):
                if f == "nn.Linear":
                    # the head starts here even with no sparse section between
                    linear_funcs = list(algorithm[i:])
                    break
                if f.startswith("nn."):
                    waveform_funcs.append(f)
                else:
                    has_wf = False
                    sparse_funcs.append(f)
            else:
                waveform_funcs.append(f)
            continue
        if isinstance(f, str) and f == "nn.Linear":
            linear_funcs = list(algorithm[i:])
            break
        sparse_funcs.append(f)
    return waveform_funcs, sparse_funcs, linear_funcs


def _leaky_relu(slope: float):
    return lambda x: F.leaky_relu(x, slope)


# dense names → their grid forms inside the sparse section; each reads its
# argument positionally or under torch's keyword (the JAX package's read the
# positional form only: BatchNorm1d(num_features=c) and Dropout(p=r) there
# get no width and the default rate)
_SPARSE_TRANSLATIONS = {
    "nn.ReLU": lambda *a, **k: SparseReLU(),
    "ReLU": lambda *a, **k: SparseReLU(),
    "nn.BatchNorm1d": lambda c=None, *a, **k: MaskedBatchNorm(k.get("num_features", c)),
    "BatchNorm1d": lambda c=None, *a, **k: MaskedBatchNorm(k.get("num_features", c)),
    "nn.LeakyReLU": lambda s=0.01, *a, **k: SparseActivation(
        _leaky_relu(k.get("negative_slope", s))),
    "nn.Sigmoid": lambda *a, **k: SparseActivation(torch.sigmoid),
    "nn.Tanh": lambda *a, **k: SparseActivation(torch.tanh),
    "nn.Dropout": lambda r=0.5, *a, **k: SparseDropout(float(k.get("p", r))),
    "Dropout": lambda r=0.5, *a, **k: SparseDropout(float(k.get("p", r))),
}


def build_sparse_instances(spec: Sequence[Any]) -> List[Any]:
    """The sparse section's layers (``create_class_instances`` with the
    grid translations)."""
    instances: List[Any] = []
    current = None
    for item in spec:
        if isinstance(item, str):
            if current is not None:
                instances.append(current())
            current = _SPARSE_TRANSLATIONS.get(item) or registry.retrieve_class(item)
        elif isinstance(item, (list, tuple)):
            if current is None:
                raise ValueError(f"sparse DSL: args {item} with no preceding class")
            instances.append(current(*item))
            current = None
        else:
            kwargs = item.to_dict() if hasattr(item, "to_dict") else dict(item)
            instances.append(current(**kwargs))
            current = None
    if current is not None:
        instances.append(current())
    return instances


def dsl_to_row_specs(spec: Sequence[Any]) -> Optional[List[Tuple]]:
    """The sparse section as ``_SpecNet`` specs where it is pure SubM
    (odd kernel, stride 1, dilation 1; BatchNorm, ReLU, dropout, ToDense),
    so that it runs in row space; None for any other stack (regular,
    strided or inverse convs, other layers), which runs on the grid."""
    def _arg(args, pos, key, default=None):
        if isinstance(args, dict):
            return args.get(key, default)
        return args[pos] if len(args) > pos else default

    specs: List[Tuple] = []
    i = 0
    items = list(spec)
    while i < len(items):
        name = items[i]
        if not isinstance(name, str):
            return None
        args = items[i + 1] if i + 1 < len(items) and \
            not isinstance(items[i + 1], str) else None
        i += 2 if args is not None else 1
        if args is not None and not isinstance(args, (list, tuple, dict)):
            args = args.to_dict() if hasattr(args, "to_dict") else None
            if args is None:
                return None
        short = name.rsplit(".", 1)[-1]
        if short in ("SubMConv2d", "SubMConv3d"):
            cin = _arg(args, 0, "in_channels") if args else None
            cout = _arg(args, 1, "out_channels") if args else None
            k = _arg(args, 2, "kernel_size") if args else None
            if cin is None or cout is None or k is None:
                return None
            cin, cout, k = int(cin), int(cout), int(k)
            stride = int(_arg(args, 3, "stride", 1))
            dilation = int(_arg(args, 5, "dilation", 1))
            # the row conv's backward flips a symmetric (odd-k) window
            if stride != 1 or dilation != 1 or k % 2 != 1:
                return None
            specs.append(("subm", cin, cout, k, (k - 1) // 2, f"subm{k}"))
        elif short in ("BatchNorm1d",):
            c = _arg(args, 0, "num_features") if args else None
            specs.append(("bn", int(c) if c is not None else None))
        elif short in ("ReLU",):
            specs.append(("relu",))
        elif short in ("Dropout",):
            rate = _arg(args, 0, "p", 0.5) if args else 0.5
            specs.append(("dropout", float(rate)))
        elif short in ("ToDense", "SparseToDense"):
            specs.append(("todense",))
        else:
            return None
    return specs
