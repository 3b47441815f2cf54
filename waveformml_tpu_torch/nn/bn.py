"""Cross-rank BatchNorm statistics (counterpart of waveformml_tpu/nn/bn.py).

Under data parallelism each rank sees a shard of the batch. The trainer
sets the process group here around its training forward (``synced_bn``),
and every BatchNorm of the port then sums its statistics over the group
(``all_reduce_sum``), so that N ranks normalise as one rank over the whole
batch. None, the default, means no sync.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

_BN_GROUP = None


def set_bn_group(group) -> None:
    """The process group BatchNorm statistics are summed over (None: none)."""
    global _BN_GROUP
    _BN_GROUP = group


def get_bn_group():
    return _BN_GROUP


@contextlib.contextmanager
def synced_bn(group) -> Iterator[None]:
    """``set_bn_group(group)`` for the block, the previous group after it."""
    previous = get_bn_group()
    set_bn_group(group)
    try:
        yield
    finally:
        set_bn_group(previous)


class _AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over the group's ranks; its backward sums the
    cotangents over the ranks too, as the transpose of JAX's ``psum`` does
    under ``shard_map(check_vma=False)``: each rank's input feeds every
    rank's loss."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        import torch.distributed as dist

        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group`` (default: the BatchNorm group), under
    autograd; ``x`` itself where there is no group."""
    group = get_bn_group() if group is None else group
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def bn_world_size() -> Optional[int]:
    """The BatchNorm group's size, or None without one."""
    group = get_bn_group()
    if group is None:
        return None
    import torch.distributed as dist

    return dist.get_world_size(group)
