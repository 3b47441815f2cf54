"""Seeded weights, made on the device: one ``torch.randn`` of every leaf's
elements from a ``torch.Generator`` on that device, then cut into the leaves
of a ``state_dict`` by name and shape (float32, the type both configurations
are served in). The benchmark hands the same dict to the program and, made
again from the same seed, to the reference.

Per leaf: a weight of two or more axes is ``N(0, 1/fan_in)`` (fan-in = the
product of every axis but the first, PyTorch's ``[out, in, *k]`` layout); a
1-D ``weight`` (a BatchNorm's scale) ``1 + 0.1·N``; a ``bias`` or
``running_mean`` ``0.1·N``; a ``running_var`` ``exp(0.25·N)``. Integer leaves
(a BatchNorm's step count) are zero.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch


def make_weights(shapes: Iterable[Tuple[str, Tuple[int, ...], torch.dtype]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``(name, shape, dtype)`` leaves, from ``seed``."""
    leaves = list(shapes)
    total = sum(math.prod(s) for _, s, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(max(total, 1), generator=gen, device=device, dtype=torch.float32)
    out, pos = {}, 0
    for name, shape, dtype in leaves:
        n = math.prod(shape)
        x = flat[pos:pos + n].view(shape)
        pos += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_var":
            x = torch.exp(0.25 * x)
        elif leaf in ("bias", "running_mean"):
            x = 0.1 * x
        elif len(shape) == 1:
            x = 1.0 + 0.1 * x
        else:
            x = x / math.sqrt(math.prod(shape[1:]))
        out[name] = x.to(dtype).contiguous()
    return out

