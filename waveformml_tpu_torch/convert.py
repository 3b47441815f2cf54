"""Carry weights between the JAX package's flax variables and the port's
``state_dict``.

The flax side is a flat dict of numpy arrays keyed by collection and module
path, ``"params/stack/l0/kernel"``, ``"batch_stats/stack/l1/mean"`` (what
``flax.traverse_util.flatten_dict(variables, sep="/")`` or an ``.npz``
holds). The mapping, leaf by leaf:

======================  ===================  ==================================
flax                    torch                layout
======================  ===================  ==================================
``params/…/kernel``     ``….weight``         row conv ``[K², Cin, Cout]`` and
                                             site head ``[C·S, F]`` as they are
``params/…/dense_i/kernel``  ``….dense_i.weight``  ``[in, out]`` → ``[out, in]``
``params/…/conv/kernel``     ``….conv.weight``  grid conv ``[kh, kw, Cin, Cout]``
                                             → ``[Cout, Cin, kh, kw]``
``params/…/kernel`` (4D)     ``….weight``  inverse conv ``[kh, kw, Cin, Cout]``
                                             → ``[Cin, Cout, kh, kw]``
``params/…/scale``      ``….weight``         BatchNorm scale
``params/…/bias``       ``….bias``
``batch_stats/…/mean``  ``….running_mean``
``batch_stats/…/var``   ``….running_var``
======================  ===================  ==================================

Module paths are carried as they are (``/`` ↔ ``.``): the port names its
modules as flax names the JAX package's (``stack/l0``,
``SparseConv2DForZ_0/l0/conv``). The inverse conv's kernel keeps its
orientation: the JAX forward flips it, ``conv_transpose2d`` takes it
unflipped.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_INV = {v: k for k, v in _STATS.items()}


def _is_dense(module_path: str) -> bool:
    return module_path.rsplit("/", 1)[-1].startswith("dense_")


def _kernel_to_torch(module_path: str, arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:
        # flax [kh, kw, Cin, Cout]: a grid conv's F.conv2d [Cout, Cin, kh, kw]
        # or an inverse conv's conv_transpose2d [Cin, Cout, kh, kw]
        axes = (3, 2, 0, 1) if module_path.rsplit("/", 1)[-1] == "conv" else (2, 3, 0, 1)
        return np.ascontiguousarray(arr.transpose(axes))
    return arr.T if _is_dense(module_path) else arr


def _kernel_to_flax(module_path: str, arr: np.ndarray) -> np.ndarray:
    if arr.ndim == 4:
        axes = (2, 3, 1, 0) if module_path.rsplit("/", 1)[-1] == "conv" else (2, 3, 0, 1)
        return np.ascontiguousarray(arr.transpose(axes))
    return arr.T if _is_dense(module_path) else arr


def flax_to_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax variables → the port's ``state_dict`` (float32 tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        collection, path = key.split("/", 1)
        module, _, leaf = path.rpartition("/")
        arr = np.asarray(value, dtype=np.float32)
        if collection == "batch_stats":
            name = _STATS[leaf]
        elif collection == "params":
            name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
            if leaf == "kernel":
                arr = _kernel_to_torch(module, arr)
        else:
            raise KeyError(f"unknown flax collection in '{key}'")
        out[f"{module.replace('/', '.')}.{name}".lstrip(".")] = torch.tensor(arr)
    return out


def state_dict_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of ``flax_to_state_dict``."""
    out: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        module, _, leaf = key.rpartition(".")
        path = module.replace(".", "/")
        prefix = f"{path}/" if path else ""
        arr = value.detach().cpu().numpy()
        if leaf in _STATS_INV:
            out[f"batch_stats/{prefix}{_STATS_INV[leaf]}"] = arr
        elif leaf == "bias":
            out[f"params/{prefix}bias"] = arr
        elif leaf == "weight" and key[:-len("weight")] + "running_mean" in state:
            out[f"params/{prefix}scale"] = arr
        elif leaf == "weight":
            out[f"params/{prefix}kernel"] = _kernel_to_flax(path, arr)
        else:
            raise KeyError(f"unknown state_dict entry '{key}'")
    return out
