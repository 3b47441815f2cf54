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
``params/…/scale``      ``….weight``         BatchNorm scale
``params/…/bias``       ``….bias``
``batch_stats/…/mean``  ``….running_mean``
``batch_stats/…/var``   ``….running_var``
======================  ===================  ==================================
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_INV = {v: k for k, v in _STATS.items()}


def _is_dense(module_path: str) -> bool:
    return module_path.rsplit("/", 1)[-1].startswith("dense_")


def flax_to_state_dict(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat flax variables → the port's ``state_dict`` (float32 tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        collection, path = key.split("/", 1)
        module, leaf = path.rsplit("/", 1)
        arr = np.asarray(value, dtype=np.float32)
        if collection == "batch_stats":
            name = _STATS[leaf]
        elif collection == "params":
            name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[leaf]
            if leaf == "kernel" and _is_dense(module):
                arr = arr.T
        else:
            raise KeyError(f"unknown flax collection in '{key}'")
        out[f"{module.replace('/', '.')}.{name}"] = torch.tensor(arr)
    return out


def state_dict_to_flax(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of ``flax_to_state_dict``."""
    out: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        module, leaf = key.rsplit(".", 1)
        path = module.replace(".", "/")
        arr = value.detach().cpu().numpy()
        if leaf in _STATS_INV:
            out[f"batch_stats/{path}/{_STATS_INV[leaf]}"] = arr
        elif leaf == "bias":
            out[f"params/{path}/bias"] = arr
        elif leaf == "weight" and f"{module}.running_mean" in state:
            out[f"params/{path}/scale"] = arr
        elif leaf == "weight":
            out[f"params/{path}/kernel"] = arr.T if _is_dense(path) else arr
        else:
            raise KeyError(f"unknown state_dict entry '{key}'")
    return out
