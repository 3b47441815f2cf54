"""The comparisons that decide ``correct``: the program's outputs against
the plain reference's, as numbers; those that ``limits/<cell>.json`` names
are compared, the rest are printed beside them as not compared.

Training (``train_numbers``), over the first three steps:

* ``out1_gap``: the first step's forward output (logits or map, in training
  mode) as ``max|out − ref| / max|ref|``;
* ``loss1_gap``: ``|L_prog − L_ref| / |L_ref|`` of the first step's loss;
* ``grad1_median_gap``: the first step's gradient as the optimizer got it,
  per leaf ``|‖g_prog‖ − ‖g_ref‖|`` over the larger of ``‖g_ref‖`` and the
  median leaf's norm, the median over the leaves;
* ``change3_median_gap``: the same for each parameter's change over the
  three steps;
* ``grad1_worst_gap``, ``change3_worst_gap``: the worst leaf's.

A gradient is not continuous where a ReLU's input crosses 0: two float32
sums of one value in different orders now and then put one site of a chunk
on either side, which moves the leaves that the site's gradient reaches by
~1e-4 of their norm, as much as computing in TF32 does. The worst leaf and
the later steps' losses swing with such a flip; the forward output, the
first step's loss and the median leaf do not. Which of the numbers a cell
compares is its ``limits/<cell>.json``'s choice.

Leaves whose reference gradient is under a thousandth of the median leaf's
(a bias that a BatchNorm after it cancels, moved by round-off alone) are
left out, by that rule and not by name.

Serving (``serve_error``): the largest ``max|out − ref| / max|ref|`` over the
served chunks compared.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

#: a leaf whose reference gradient is under this share of the median leaf's
#: is left out
NEGLIGIBLE = 1e-3


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: List[str]) -> Optional[List[float]]:
    """Each kept leaf's gap of norms against the larger of its reference
    norm and the median kept leaf's; None where a leaf is missing."""
    if any(k not in prog or prog[k] is None for k in keep):
        return None
    pn, rn = _norms({k: prog[k] for k in keep}), _norms({k: ref[k] for k in keep})
    median = float(np.median(list(rn.values())))
    return [abs(pn[k] - rn[k]) / max(rn[k], median, 1e-30) for k in keep]


def kept_leaves(ref_grad1: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves compared: a reference gradient at least ``NEGLIGIBLE`` of
    the median leaf's."""
    norms = _norms(ref_grad1)
    median = float(np.median(list(norms.values())))
    return sorted(k for k, n in norms.items() if n >= NEGLIGIBLE * median)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, Optional[float]]:
    """``prog`` and ``ref``: ``losses`` (3 floats), ``grad1`` and ``delta``
    (leaf name → tensor; the program's ``grad1`` may be None), and
    ``out1``, the first step's forward output (either side's may be None)."""
    lp, lr = prog.get("losses") or [], ref["losses"]
    out = {"out1_gap": (relative_error(prog["out1"], ref["out1"])
                        if prog.get("out1") is not None and ref.get("out1") is not None
                        else None),
           "loss1_gap": abs(lp[0] - lr[0]) / max(abs(lr[0]), 1e-30) if lp else None}
    keep = kept_leaves(ref["grad1"])
    for name, key in (("grad1", "grad1"), ("change3", "delta")):
        gaps = leaf_gaps(prog[key], ref[key], keep) if prog.get(key) else None
        out[f"{name}_median_gap"] = float(np.median(gaps)) if gaps else None
        out[f"{name}_worst_gap"] = max(gaps) if gaps else None
    return out


def relative_error(out, ref) -> Optional[float]:
    """``max|out − ref| / max|ref|`` (None where the shapes differ)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    if out.shape != ref.shape:
        return None
    return float(np.abs(out - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def serve_error(outputs: List[np.ndarray], refs: List[np.ndarray]) -> Optional[float]:
    """The largest relative error of a served chunk (None where the shapes
    differ)."""
    errors = [relative_error(out, ref) for out, ref in zip(outputs, refs)]
    return None if any(e is None for e in errors) else max(errors, default=0.0)
