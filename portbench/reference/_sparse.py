"""Plain PyTorch pieces that the configurations' references share, written
from spconv's layer equations over the occupied sites of the 14×11 (×T)
detector grid, never over a dense grid: a site is one (event, x, y[, t])
key, the rows of one site are summed into it, and each tap of a conv reads
the site it names where that site is occupied.

``mm`` is the one matrix product every layer goes through. In float32 it is
``a @ b`` with TF32 off; with ``tf32=True`` (the control) its operands, and in
the backward the incoming gradient, are rounded to TF32's 10-bit mantissa
and the products summed in float32, as the tensor cores compute a TF32
product.
"""
from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch

NX, NY = 14, 11


@contextlib.contextmanager
def float32_matmul():
    """cuBLAS and cuDNN in full float32 (no TF32) inside the block, the
    process's settings restored after it."""
    b = torch.backends
    new = [getattr(b.cuda, "matmul", None), getattr(b.cudnn, "conv", None)]
    new = [a for a in new if a is not None and hasattr(a, "fp32_precision")]
    if len(new) == 2:
        saved = [a.fp32_precision for a in new]
        for a in new:
            a.fp32_precision = "ieee"
        try:
            yield
        finally:
            for a, v in zip(new, saved):
                a.fp32_precision = v
        return
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10 mantissa bits,
    ties away from zero), as float32."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        return rg @ rb.t(), ra.t() @ rg


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """``a @ b`` for 2-D operands, in float32 or (``tf32``) TF32."""
    return _TF32MM.apply(a, b) if tf32 else a @ b


def site_keys(coords: torch.Tensor, n_t: int = 0) -> torch.Tensor:
    """Each row's site key, int64: ``((event·NX + x)·NY + y)`` (``·T + t``
    for (x, y, t, event) rows with ``n_t`` = T)."""
    c = coords.long()
    key = (c[:, -1] * NX + c[:, 0]) * NY + c[:, 1]
    return key * n_t + c[:, 2] if n_t else key


def key_xyz(keys: torch.Tensor, n_t: int = 0) -> Tuple[torch.Tensor, ...]:
    """(event, x, y[, t]) of site keys."""
    t = None
    if n_t:
        t = keys % n_t
        keys = keys // n_t
    y = keys % NY
    keys = keys // NY
    x = keys % NX
    e = keys // NX
    return (e, x, y) if t is None else (e, x, y, t)


def sites_of(coords: torch.Tensor, values: torch.Tensor, n_t: int = 0):
    """The occupied sites (sorted keys) and ``values`` ``[N, F]`` summed
    into them."""
    keys = site_keys(coords, n_t)
    sites, inverse = torch.unique(keys, sorted=True, return_inverse=True)
    out = values.new_zeros((sites.shape[0],) + values.shape[1:]).index_add(0, inverse, values)
    return sites, out


def lookup(sites: torch.Tensor, keys: torch.Tensor, valid: torch.Tensor):
    """Index of each of ``keys`` among the sorted ``sites`` and whether it
    is there (and ``valid``)."""
    pos = torch.searchsorted(sites, keys).clamp(max=max(sites.shape[0] - 1, 0))
    return pos, valid & (sites[pos] == keys)


def shifted(sites: torch.Tensor, offset: Sequence[int], n_t: int = 0):
    """The keys of ``sites`` moved by ``offset`` ((dx, dy) or (dx, dy, dt))
    and whether the moved site lies on the grid."""
    parts = key_xyz(sites, n_t)
    e, x, y = parts[0], parts[1] + offset[0], parts[2] + offset[1]
    ok = (x >= 0) & (x < NX) & (y >= 0) & (y < NY)
    key = (e * NX + x) * NY + y
    if n_t:
        t = parts[3] + offset[2]
        ok = ok & (t >= 0) & (t < n_t)
        key = key * n_t + t
    return key, ok


def taps(k: int, ndim: int):
    """The taps of a k^ndim window in the order of a ``[Cout, Cin, *k]``
    weight, as (index tuple, offset from the centre)."""
    grids = torch.cartesian_prod(*[torch.arange(k)] * ndim).reshape(-1, ndim)
    return [(tuple(int(v) for v in g), tuple(int(v) - (k - 1) // 2 for v in g)) for g in grids]


def conv_sites(in_sites: torch.Tensor, x: torch.Tensor, out_sites: torch.Tensor,
               weight: torch.Tensor, bias: torch.Tensor, n_t: int = 0,
               tf32: bool = False) -> torch.Tensor:
    """A stride-1 conv whose window is centred on each output site (a SubM
    conv, or a regular conv padded by (k − 1) / 2): ``out[o] = bias +
    Σ_taps W[:, :, tap]·x[o + tap − centre]`` over the taps whose input
    site is occupied; weight ``[Cout, Cin, *k]``."""
    ndim = weight.dim() - 2
    k = weight.shape[2]
    out = x.new_zeros((out_sites.shape[0], weight.shape[0])) + bias
    for index, offset in taps(k, ndim):
        key, ok = shifted(out_sites, offset, n_t)
        pos, found = lookup(in_sites, key, ok)
        rows = torch.nonzero(found).squeeze(1)
        if rows.numel() == 0:
            continue
        w = weight[(slice(None), slice(None)) + index]          # [Cout, Cin]
        out = out.index_add(0, rows, mm(x[pos[rows]], w.t(), tf32))
    return out


def dilated_sites(in_sites: torch.Tensor, k: int, ndim: int, n_t: int = 0) -> torch.Tensor:
    """The output sites of a stride-1 regular conv padded by (k − 1) / 2:
    every on-grid site whose window holds an occupied input site."""
    keys = []
    for _, offset in taps(k, ndim):
        key, ok = shifted(in_sites, offset, n_t)
        keys.append(key[ok])
    return torch.unique(torch.cat(keys), sorted=True)


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over the rows of ``x`` (the occupied sites) with their
    batch statistics: the biased variance normalises."""
    mean = x.mean(0)
    var = ((x - mean) ** 2).mean(0)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


def batch_norm_eval(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    running_mean: torch.Tensor, running_var: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm with the running statistics."""
    return (x - running_mean) * torch.rsqrt(running_var + eps) * weight + bias


def sgd_steps(params, grads, state, lr: float, momentum: float, nesterov: bool,
              weight_decay: float = 0.0, dampening: float = 0.0) -> None:
    """One step of torch's SGD in place: ``g + wd·p``; the momentum buffer
    ``g`` on its first step, ``μ·buf + (1 − dampening)·g`` after; nesterov's
    ``g + μ·buf``; ``p −= lr·update``."""
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name]
            if weight_decay:
                g = g + weight_decay * p
            if momentum:
                buf = state.get(name)
                buf = g.clone() if buf is None else momentum * buf + (1 - dampening) * g
                state[name] = buf
                g = g + momentum * buf if nesterov else buf
            p -= lr * g
