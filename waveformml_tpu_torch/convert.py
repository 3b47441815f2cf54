"""Carry weights between the JAX package's flax variables and the port's
``state_dict``.

The flax side is a flat dict of numpy arrays keyed by collection and module
path, ``"params/stack/l0/kernel"``, ``"batch_stats/stack/l1/mean"`` (what
``flax.traverse_util.flatten_dict(variables, sep="/")`` or an ``.npz``
holds). The mapping, leaf by leaf, the layout keyed on the name of the
module that holds the leaf (the last component of its path):

==============================  ============================  ===========================
flax                            torch                         layout
==============================  ============================  ===========================
``…/l<i>/kernel`` (3D)          ``….l<i>.weight``             row conv ``[K², Cin, Cout]``
                                                              as it is
``…/head0/kernel``              ``….head0.weight``            site head ``[C·S, F]`` as it is
``…/dense_<i>/kernel``,         ``….weight``                  ``[in, out]`` → ``[out, in]``
``…/dense/kernel``,
``…/pw_<i>/kernel``, the
graph convs' Dense layers
(``lin*``, ``q``, ``k``, ``v``,
``edge``, ``edge_proj``,
``skip``, ``g``, ``root``,
``u``, ``film*``, ``V_<i>``,
``W_<i>``, ``mlp<i>``)
``…/conv/kernel``,              ``….weight``                  ``[*k, Cin, Cout]`` →
``…/conv_<i>/kernel``,                                        ``[Cout, Cin, *k]`` (1D, 2D
``…/conv1``, ``conv2``,                                       and 3D convs)
``…/downsample/kernel``
other 4D, 5D ``…/kernel``       ``….weight``                  inverse conv ``[*k, Cin,
                                                              Cout]`` → ``[Cin, Cout, *k]``
``…/cell_<l>/<gate>/…``         ``….cell_<l>.{weight,bias}_   a recurrent layer's gates
                                {ih,hh}_l0``                  (below)
``…/WeightNorm_<j>/<conv>/``    ``….<conv>.parametrizations   ``[Cout]`` → ``[Cout, 1, 1]``
``kernel/scale``                .weight.original0``
``…/<conv>/kernel`` of a        ``….<conv>.parametrizations   as a conv kernel
weight-normed conv              .weight.original1``
``…/scale``                     ``….weight``                  BatchNorm, LayerNorm scale
``…/bias``                      ``….bias``
``batch_stats/…/mean``          ``….running_mean``
``batch_stats/…/var``           ``….running_var``
``…/att_src``, ``att_dst``,     ``….att_src``, …              as they are
``att``, ``mu``, ``sigma``
==============================  ============================  ===========================

Module paths are carried as they are (``/`` ↔ ``.``): the port names its
modules as flax names the JAX package's (``stack/l0``,
``SparseConv2DForZ_0/l0/conv``, ``sparse_model/layers_0/conv``), a list
attribute's items included: flax names them ``<attribute>_<i>``
(``linear_layers_0``, ``waveform_layers_0``), and so does the port. flax's
``nn.WeightNorm`` keeps each scale in a module of its own,
``WeightNorm_<j>`` beside the conv in the block that wraps it, numbered
in the order the block calls its convs; torch's weight-norm
parametrisation keeps it in the conv, and the port's TCN block registers
its convs in that order, so the j-th parametrised conv of a module is
``WeightNorm_<j>``. The inverse conv's kernel keeps its orientation: the
JAX forward flips it, ``conv_transpose2d`` takes it unflipped.

A recurrent layer ``cell_<l>`` (flax's ``SimpleCell``, ``GRUCell`` or
``LSTMCell``; the port's one-layer torch ``RNN``, ``GRU`` or ``LSTM``)
carries one Dense a gate: the input gates' kernels, in torch's gate order
(GRU r, z, n; LSTM i, f, g, o), are ``weight_ih_l0`` transposed, the
recurrent ones ``weight_hh_l0``. flax has one bias a gate where torch has two: a
simple cell's ``i`` bias, a GRU's ``ir``, ``iz`` and an LSTM's ``h*``
biases are torch's two summed; on the way in they go to ``bias_ih_l0``,
and ``bias_hh_l0`` is zero, but for a GRU's n gate, whose two biases flax
keeps apart too (``in``; ``hn``, inside the reset gate's product as
torch's).
"""
from __future__ import annotations

import re
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_INV = {v: k for k, v in _STATS.items()}
#: a weight-norm parametrisation's leaves in a torch state_dict
_WN = ".parametrizations.weight.original"
_CONV = re.compile(r"^(conv(_\d+)?|conv1|conv2|downsample)$")
_DENSE = re.compile(r"^(dense(_\d+)?|pw_\d+"
                    # the graph convs' Dense layers (models/graph_layers.py)
                    r"|lin(_\w+|\d)?|[qkvgu]|edge(_proj)?|skip|root|film(_skip)?|[VW]_\d+"
                    r"|mlp\d)$")
#: parameters carried as they are, under their own names (the graph convs'
#: attention vectors, GMMConv's means and widths)
_RAW = ("att_src", "att_dst", "att", "mu", "sigma")
_WN_SCALE = re.compile(r"^(?P<parent>.*?)/?WeightNorm_\d+/(?P<conv>[^/]+)/kernel/scale$")


def _leaf_module(module_path: str) -> str:
    return module_path.rsplit("/", 1)[-1]


#: a recurrent cell's gates in flax: (input gates, recurrent gates) in
#: torch's gate order, by torch's gates a layer
_GATES = {1: (("i",), ("h",)), 3: (("ir", "iz", "in"), ("hr", "hz", "hn")),
          4: (("ii", "if", "ig", "io"), ("hi", "hf", "hg", "ho"))}
_CELL_FLAX = re.compile(r"^params/(?P<cell>(.*/)?cell_\d+)/(?P<gate>[ih][a-z]?)/"
                        r"(?P<leaf>kernel|bias)$")
_CELL_TORCH = re.compile(r"^(?P<cell>(.*\.)?cell_\d+)\.(weight|bias)_(ih|hh)_l0$")


def _kernel_to_torch(module_path: str, arr: np.ndarray) -> np.ndarray:
    name = _leaf_module(module_path)
    if _CONV.match(name) and arr.ndim >= 3:
        # flax [*k, Cin, Cout] → [Cout, Cin, *k]
        return np.ascontiguousarray(np.moveaxis(arr, (-1, -2), (0, 1)))
    if arr.ndim >= 4:
        # an inverse conv's conv_transpose [Cin, Cout, *k]
        return np.ascontiguousarray(np.moveaxis(arr, (-2, -1), (0, 1)))
    return arr.T if _DENSE.match(name) else arr


def _kernel_to_flax(module_path: str, arr: np.ndarray) -> np.ndarray:
    name = _leaf_module(module_path)
    if _CONV.match(name) and arr.ndim >= 3:
        return np.ascontiguousarray(np.moveaxis(arr, (0, 1), (-1, -2)))
    if arr.ndim >= 4:
        return np.ascontiguousarray(np.moveaxis(arr, (0, 1), (-2, -1)))
    return arr.T if _DENSE.match(name) else arr


def _kernel_layout(module_path: str, shape: Tuple[int, ...]) -> Tuple[Tuple[int, ...], int]:
    """``_kernel_to_flax``'s flax shape of a kernel of the port's ``shape``,
    and the port axis that holds flax's last axis."""
    name = _leaf_module(module_path)
    view = np.broadcast_to(np.float32(0), shape)     # a shape without storage
    if _CONV.match(name) and len(shape) >= 3:
        return np.moveaxis(view, (0, 1), (-1, -2)).shape, 0
    if len(shape) >= 4:
        return np.moveaxis(view, (0, 1), (-2, -1)).shape, 1
    if _DENSE.match(name):
        return tuple(reversed(shape)), 0
    return tuple(shape), len(shape) - 1


class FlaxLayout(NamedTuple):
    """Where a parameter of the port's ``state_dict`` sits in flax: the
    flax names it carries, the flax shape of each, and the port axis that
    holds flax's last axis, in ``blocks`` equal blocks (a recurrent
    layer's gates, each a flax Dense of its own; 1 elsewhere)."""
    names: List[str]
    shape: Tuple[int, ...]
    axis: int
    blocks: int


def flax_layout(key: str, shapes: Dict[str, Tuple[int, ...]]) -> FlaxLayout:
    """The ``FlaxLayout`` of the parameter ``key`` of a ``state_dict``
    whose entries have ``shapes`` (all of them, in ``state_dict`` order:
    a recurrent layer's gates and a weight norm's index are read from
    its siblings), as ``state_dict_to_flax`` maps it."""
    shape = tuple(shapes[key])
    cell = _CELL_TORCH.match(key)
    if cell:
        hidden = shapes[f"{cell['cell']}.weight_hh_l0"][1]
        gates = shape[0] // hidden
        gi, gh = _GATES[gates]
        path = "params/" + cell["cell"].replace(".", "/")
        which = key[len(cell["cell"]) + 1:]
        gate = gi if which.endswith("ih_l0") else gh
        if which.startswith("weight"):
            return FlaxLayout([f"{path}/{g}/kernel" for g in gate], (shape[1], hidden), 0,
                              gates)
        return FlaxLayout([f"{path}/{g}/bias" for g in gate], (hidden,), 0, gates)
    if _WN in key:
        conv_path, _, which = key.partition(_WN)
        path = conv_path.replace(".", "/")
        if which == "1":
            flax_shape, axis = _kernel_layout(path, shape)
            return FlaxLayout([f"params/{path}/kernel"], flax_shape, axis, 1)
        parent, _, conv = path.rpartition("/")
        keys = list(shapes)
        # state_dict_to_flax numbers a parent's scales in state_dict order
        j = sum(1 for k in keys[:keys.index(key)] if k.endswith(_WN + "0")
                and k.partition(_WN)[0].rpartition(".")[0] == conv_path.rpartition(".")[0])
        prefix = f"{parent}/" if parent else ""
        return FlaxLayout([f"params/{prefix}WeightNorm_{j}/{conv}/kernel/scale"],
                          (shape[0],), 0, 1)
    module, _, leaf = key.rpartition(".")
    path = module.replace(".", "/")
    prefix = f"{path}/" if path else ""
    if leaf == "bias" or leaf in _RAW:
        return FlaxLayout([f"params/{prefix}{leaf}"], shape, len(shape) - 1, 1)
    if leaf == "weight" and (key[:-len("weight")] + "running_mean" in shapes
                             or _leaf_module(path).startswith("LayerNorm_")):
        return FlaxLayout([f"params/{prefix}scale"], shape, len(shape) - 1, 1)
    if leaf == "weight":
        flax_shape, axis = _kernel_layout(path, shape)
        return FlaxLayout([f"params/{prefix}kernel"], flax_shape, axis, 1)
    raise KeyError(f"'{key}' is not a parameter flax carries")


def _cells_to_torch(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The recurrent cells' leaves of flat flax variables as torch's
    ``weight_{ih,hh}_l0``, ``bias_{ih,hh}_l0``."""
    cells: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in flat.items():
        m = _CELL_FLAX.match(key)
        if m:
            cells.setdefault(m["cell"], {})[f"{m['gate']}/{m['leaf']}"] = np.asarray(
                value, dtype=np.float32)
    out: Dict[str, torch.Tensor] = {}
    for cell, leaves in cells.items():
        n_gates = next(n for n, (gi, _) in _GATES.items() if f"{gi[0]}/kernel" in leaves)
        gi, gh = _GATES[n_gates]
        hidden = leaves[f"{gh[0]}/kernel"].shape[0]
        zero = np.zeros(hidden, np.float32)
        # the LSTM's gate biases (flax's on the recurrent Dense) in torch's
        # input bias: the recurrent bias is zero but for a GRU's n gate
        b_ih = np.concatenate([leaves.get(f"{g}/bias", leaves.get(f"{h}/bias", zero))
                               for g, h in zip(gi, gh)])
        b_hh = np.concatenate([leaves[f"{g}/bias"] if g == "hn" else zero for g in gh])
        prefix = cell.replace("/", ".")
        for name, arr in (("weight_ih_l0", np.concatenate([leaves[f"{g}/kernel"] for g in gi],
                                                          axis=1).T),
                          ("weight_hh_l0", np.concatenate([leaves[f"{g}/kernel"] for g in gh],
                                                          axis=1).T),
                          ("bias_ih_l0", b_ih), ("bias_hh_l0", b_hh)):
            out[f"{prefix}.{name}"] = torch.tensor(np.ascontiguousarray(arr))
    return out


def _cells_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of ``_cells_to_torch``: each torch bias pair summed into
    flax's one bias a gate, but for a GRU's n gate, whose two stay apart
    (``in``, ``hn``)."""
    cells: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in state.items():
        m = _CELL_TORCH.match(key)
        if m:
            cells.setdefault(m["cell"], {})[key[len(m["cell"]) + 1:]] = \
                value.detach().cpu().numpy()
    out: Dict[str, np.ndarray] = {}
    for cell, t in cells.items():
        w_hh = t["weight_hh_l0"]
        n_gates = w_hh.shape[0] // w_hh.shape[1]
        gi, gh = _GATES[n_gates]
        w_i = np.split(t["weight_ih_l0"], n_gates)
        w_h = np.split(w_hh, n_gates)
        b_i = np.split(t["bias_ih_l0"], n_gates)
        b_h = np.split(t["bias_hh_l0"], n_gates)
        path = "params/" + cell.replace(".", "/")
        for j in range(n_gates):
            out[f"{path}/{gi[j]}/kernel"] = np.ascontiguousarray(w_i[j].T)
            out[f"{path}/{gh[j]}/kernel"] = np.ascontiguousarray(w_h[j].T)
            if n_gates == 4:        # LSTM: the recurrent gates carry the bias
                out[f"{path}/{gh[j]}/bias"] = b_i[j] + b_h[j]
            elif n_gates == 3 and j == 2:
                out[f"{path}/{gi[j]}/bias"] = b_i[j]
                out[f"{path}/{gh[j]}/bias"] = b_h[j]
            else:
                out[f"{path}/{gi[j]}/bias"] = b_i[j] + b_h[j]
    return out


def flax_to_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax variables → the port's ``state_dict`` (float32 tensors)."""
    out: Dict[str, torch.Tensor] = _cells_to_torch(flat)
    flat = {k: v for k, v in flat.items() if not _CELL_FLAX.match(k)}
    normed = set()
    for key in flat:
        m = _WN_SCALE.match(key.split("/", 1)[1]) if key.startswith("params/") else None
        if m:
            normed.add(f"{m['parent']}/{m['conv']}".lstrip("/"))
    for key, value in flat.items():
        collection, path = key.split("/", 1)
        arr = np.asarray(value, dtype=np.float32)
        m = _WN_SCALE.match(path) if collection == "params" else None
        if m:
            module = f"{m['parent']}/{m['conv']}".lstrip("/")
            out[module.replace("/", ".") + _WN + "0"] = torch.tensor(
                arr.reshape((-1,) + (1,) * 2))
            continue
        module, _, leaf = path.rpartition("/")
        if collection == "batch_stats":
            name = _STATS[leaf]
        elif collection == "params" and leaf in _RAW:
            name = leaf
        elif collection == "params":
            name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
            if leaf == "kernel":
                arr = _kernel_to_torch(module, arr)
                if module in normed:
                    name = _WN[1:] + "1"
        else:
            raise KeyError(f"unknown flax collection in '{key}'")
        out[f"{module.replace('/', '.')}.{name}".lstrip(".")] = torch.tensor(arr)
    return out


def state_dict_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of ``flax_to_state_dict``."""
    out: Dict[str, np.ndarray] = _cells_to_flax(state)
    weight_norms: Dict[str, int] = {}
    for key, value in state.items():
        if _CELL_TORCH.match(key):
            continue
        arr = value.detach().cpu().numpy()
        if _WN in key:
            conv_path, _, which = key.partition(_WN)
            path = conv_path.replace(".", "/")
            if which == "1":
                out[f"params/{path}/kernel"] = _kernel_to_flax(path, arr)
            else:
                parent, _, conv = path.rpartition("/")
                j = weight_norms.setdefault(parent, 0)
                weight_norms[parent] = j + 1
                prefix = f"{parent}/" if parent else ""
                out[f"params/{prefix}WeightNorm_{j}/{conv}/kernel/scale"] = arr.reshape(-1)
            continue
        module, _, leaf = key.rpartition(".")
        path = module.replace(".", "/")
        prefix = f"{path}/" if path else ""
        if leaf in _STATS_INV:
            out[f"batch_stats/{prefix}{_STATS_INV[leaf]}"] = arr
        elif leaf == "bias" or leaf in _RAW:
            out[f"params/{prefix}{leaf}"] = arr
        elif leaf == "weight" and (key[:-len("weight")] + "running_mean" in state
                                   or _leaf_module(path).startswith("LayerNorm_")):
            out[f"params/{prefix}scale"] = arr
        elif leaf == "weight":
            out[f"params/{prefix}kernel"] = _kernel_to_flax(path, arr)
        else:
            raise KeyError(f"unknown state_dict entry '{key}'")
    return out
