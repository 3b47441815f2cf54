"""Tensor parallelism over a (data, model) grid of ranks (counterpart of
waveformml_tpu/parallel/gspmd.py).

The JAX package's second engine puts its devices on a 2-D ``(data,
model)`` mesh, column-shards the wide kernels over ``model`` and lets
XLA's GSPMD partitioner insert every collective of one global program.
The port runs one process per GPU, as its data-parallel engine does
(``parallel.mesh``): a mesh of ``dp × tp`` devices is ``dp·tp`` ranks, and
rank ``r`` sits at ``(data, model) = (r // tp, r % tp)``, where
``devs.reshape(dp, tp)`` puts device ``r``. ``make_mesh_2d`` gives each
rank two process groups: its **data group** (the ranks of its model
index), over which gradients, the loss, the metrics and the BatchNorm
statistics are summed, and its **model group** (the ranks of its data
index), over which the column shards are gathered. The collectives are
written out here, in Megatron's pair (``copy_to_model``,
``gather_from_model``) and as ``gather_weight``.

The tensor-parallel rule (``tp_spec_for``) is the JAX one, on each
parameter's flax shape: its last axis (the output features) is sharded
over ``model`` where the parameter has two dims or more, the axis
divides by ``tp`` and a block keeps ``_MIN_SHARD_COLS`` columns at least;
everything else (biases, BatchNorm parameters and statistics, narrow
kernels) is replicated. ``convert.flax_layout`` says which axis of the
port's parameter that flax axis is, so any model that the JAX package
shards is sharded the same way: rank ``m`` of a model group holds columns
``[m·n/tp, (m+1)·n/tp)`` of each block of that axis (a recurrent layer's
gates are blocks of their own).

``TensorParallel(model, mesh)`` puts the rule on a built model: each
sharded parameter is replaced by this rank's block under the same name,
so ``state_dict`` keys stay the one-rank keys and only the sharded
entries' shapes change (``gather_params`` and ``shard_params`` carry a
state between the two). The row path computes on its blocks: a
``RowSubMConv2d`` runs K1 (forward and d_feats) and K4 on its column
block, a ``FoldedSiteLinear`` K2 and K5, an ``nn.Linear`` a matmul; each
gathers its output over the model group and adds its whole (replicated)
bias after the gather. Every other sharded parameter is gathered whole
(``gather_weight``) for each forward of the model and put back as the
shard after it, so that its module computes the one-rank arithmetic.

``shard_batch`` has no counterpart. The JAX engine stitches each
process's prepared slice into one global batch: its row buckets rounded
to the data degree, ``plan_site_*`` slot grids replicated, event ids,
row plans and edge lists shifted by the process's row and event offsets
(waveformml_tpu/engineering/trainer.py:429-481). Here each data rank
prepares its own block, read round-robin over the data index with ``dp``
(``shard_loader_round_robin``), and the ranks of a model group read the
same block; the layers sum over the data group what the global program
sums over the global batch, so no batch is stitched and nothing is
shifted.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from waveformml_tpu_torch.convert import flax_layout

DATA_AXIS = "data"
MODEL_AXIS = "model"

# a sharded kernel column block should still span an MXU lane tile (the
# JAX package's reason; the port keeps the rule so that both shard alike)
_MIN_SHARD_COLS = 8


@dataclass
class Mesh2D:
    """This rank's place on the ``(dp, tp)`` grid and its two groups."""
    dp: int
    tp: int
    data_index: int
    model_index: int
    data_group: Any
    model_group: Any

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.tp}


def mesh_coords(rank: int, tp: int) -> Tuple[int, int]:
    """``(data, model)`` of ``rank``: where ``devs.reshape(dp, tp)`` puts
    device ``rank``."""
    return rank // tp, rank % tp


def make_mesh_2d(dp: Optional[int] = None, tp: int = 1) -> Mesh2D:
    """The ``(dp, tp)`` grid over the default process group (``dp``
    defaults to the world over ``tp``): this rank's coordinates, its data
    group (the ranks of its model index) and its model group (the ranks of
    its data index). Every rank creates every group, in the same order, as
    ``dist.new_group`` needs. Raises ValueError where the world does not
    form the grid."""
    n = dist.get_world_size()
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"{n} devices cannot form a ({dp}, {tp}) mesh")
    data_groups = [dist.new_group([d * tp + m for d in range(dp)]) for m in range(tp)]
    model_groups = [dist.new_group([d * tp + m for m in range(tp)]) for d in range(dp)]
    d, m = mesh_coords(dist.get_rank(), tp)
    return Mesh2D(dp, tp, d, m, data_groups[m], model_groups[d])


def tp_spec_for(shape: Sequence[int], tp: int) -> Tuple[Optional[str], ...]:
    """The JAX rule's partition of one parameter of flax shape ``shape``:
    ``(None, …, "model")`` where its last axis is sharded, else ``()``
    (replicated), the entries of the JAX ``PartitionSpec``."""
    if tp > 1 and len(shape) >= 2 and shape[-1] % tp == 0 \
            and shape[-1] // tp >= _MIN_SHARD_COLS:
        return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
    return ()


class ShardSpec(NamedTuple):
    """A sharded parameter: the port axis that holds flax's last axis, in
    ``blocks`` equal blocks, each split in ``tp`` columns blocks."""
    axis: int
    blocks: int


def tp_specs(model: nn.Module, tp: int) -> Dict[str, ShardSpec]:
    """The parameters of ``model`` that the rule shards, by ``state_dict``
    key, with the port axis of each (``convert.flax_layout``)."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    specs = {}
    for name, _ in model.named_parameters():
        layout = flax_layout(name, shapes)
        if tp_spec_for(layout.shape, tp):
            specs[name] = ShardSpec(layout.axis, layout.blocks)
    return specs


def sharded_flax_names(model: nn.Module, tp: int) -> List[str]:
    """The flax names of the parameters of ``model`` that the rule shards."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    return sorted(n for k in tp_specs(model, tp) for n in flax_layout(k, shapes).names)


def block_of(full: torch.Tensor, spec: ShardSpec, tp: int, m: int) -> torch.Tensor:
    """Rank ``m``'s columns of ``full`` along ``spec.axis`` (contiguous)."""
    parts = full.unflatten(spec.axis, (spec.blocks, tp, -1)).select(spec.axis + 1, m)
    return parts.flatten(spec.axis, spec.axis + 1).contiguous()


def _all_gather(x: torch.Tensor, group, tp: int) -> torch.Tensor:
    """``[tp, *x.shape]``: every rank's ``x`` of the group, in rank order."""
    out = x.new_empty((tp * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.unflatten(0, (tp, -1))


def gather_blocks(block: torch.Tensor, spec: ShardSpec, mesh: Mesh2D) -> torch.Tensor:
    """The whole tensor of which every rank of the model group holds its
    ``block`` (the inverse of ``block_of``); a collective."""
    stacked = _all_gather(block.movedim(spec.axis, 0), mesh.model_group, mesh.tp)
    # [tp, blocks·k, ...] -> [blocks, tp, k, ...] -> [blocks·tp·k, ...]
    stacked = stacked.unflatten(1, (spec.blocks, -1)).transpose(0, 1)
    return stacked.flatten(0, 2).movedim(0, spec.axis).contiguous()


# -- the column functions ---------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model group (each
    rank's column block gives a part of its input's gradient). A
    low-precision gradient is summed in float32."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        low = g.dtype in (torch.bfloat16, torch.float16)
        total = (g.float() if low else g.clone()).contiguous()
        dist.all_reduce(total, group=ctx.mesh.model_group)
        return total.to(g.dtype), None


class _GatherFromModel(torch.autograd.Function):
    """The model group's column blocks concatenated along the last axis;
    the backward keeps this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        stacked = _all_gather(x, mesh.model_group, mesh.tp)      # [tp, ..., n]
        return stacked.movedim(0, -2).flatten(-2)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return g.unflatten(-1, (mesh.tp, -1)).select(-2, mesh.model_index).contiguous(), None


class _GatherWeight(torch.autograd.Function):
    """A sharded parameter made whole over the model group; the backward
    keeps this rank's block of the gradient (every rank of the group
    computes the whole gradient alike)."""

    @staticmethod
    def forward(ctx, block, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return gather_blocks(block, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return block_of(g, ctx.spec, ctx.mesh.tp, ctx.mesh.model_index), None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh2D) -> torch.Tensor:
    """``x``, whose gradient is summed over the model group."""
    return _CopyToModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh: Mesh2D) -> torch.Tensor:
    """The column blocks ``x [..., n/tp]`` of the model group as ``[...,
    n]``, in rank order; the gradient keeps this rank's block."""
    return _GatherFromModel.apply(x, mesh)


def gather_weight(block: torch.Tensor, spec: ShardSpec, mesh: Mesh2D) -> torch.Tensor:
    """A sharded parameter whole, along its port axis; the gradient keeps
    this rank's block."""
    return _GatherWeight.apply(block, spec, mesh)


def column_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                  mesh: Mesh2D) -> torch.Tensor:
    """``nn.Linear`` on its row block of the weight (``[out/tp, in]``): the
    matmul of the block, the output gathered, then the whole bias."""
    y = gather_from_model(torch.matmul(copy_to_model(x, mesh), weight.t()), mesh)
    return y if bias is None else y + bias


class ColumnLinear(nn.Linear):
    """An ``nn.Linear`` whose weight is this rank's block (``column_linear``);
    ``TensorParallel`` gives a sharded ``nn.Linear`` this class."""

    tp_mesh: Mesh2D

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return column_linear(x, self.weight, self.bias, self.tp_mesh)


# -- a model on the grid ----------------------------------------------------------------

def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    module, _, leaf = name.rpartition(".")
    return (model.get_submodule(module) if module else model), leaf


class TensorParallel:
    """``model`` on the grid of ``mesh`` (see the module docstring): each
    parameter the rule shards is this rank's block under its own name; a
    ``RowSubMConv2d``'s, ``FoldedSiteLinear``'s or ``nn.Linear``'s weight
    is computed on as a block (column-parallel), every other one is
    gathered whole by a forward pre-hook of ``model`` and put back as the
    block by its forward hook."""

    def __init__(self, model: nn.Module, mesh: Mesh2D):
        from waveformml_tpu_torch.models.blocks import FoldedSiteLinear
        from waveformml_tpu_torch.models.sparse_blocks import RowSubMConv2d

        self.mesh = mesh
        self.specs = tp_specs(model, mesh.tp)
        #: (owner, leaf, spec, block) of the parameters gathered whole
        self.gathered: List[Tuple[nn.Module, str, ShardSpec, nn.Parameter]] = []
        for name, spec in self.specs.items():
            owner, leaf = _owner(model, name)
            full = owner._parameters[leaf]
            block = nn.Parameter(block_of(full.detach(), spec, mesh.tp, mesh.model_index),
                                 requires_grad=full.requires_grad)
            owner._parameters[leaf] = block
            if leaf == "weight" and isinstance(owner, (RowSubMConv2d, FoldedSiteLinear)):
                owner.tp = mesh
            elif leaf == "weight" and type(owner) is nn.Linear:
                owner.__class__ = ColumnLinear
                owner.tp_mesh = mesh
            else:
                self.gathered.append((owner, leaf, spec, block))
        if self.gathered:
            model.register_forward_pre_hook(self._whole)
            model.register_forward_hook(self._blocks, always_call=True)

    def _whole(self, module, args) -> None:
        # a tensor in place of the parameter (a recurrent module's forward
        # takes it up into its flat weights itself)
        for owner, leaf, spec, block in self.gathered:
            owner._parameters[leaf] = gather_weight(block, spec, self.mesh)

    def _blocks(self, module, args, output) -> None:
        for owner, leaf, _, block in self.gathered:
            owner._parameters[leaf] = block

    def gather_params(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The one-rank ``state_dict`` of a state whose sharded entries are
        this rank's blocks; a collective of the model group."""
        return {k: gather_blocks(v, self.specs[k], self.mesh) if k in self.specs else v
                for k, v in state.items()}

    def shard_params(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's blocks of a one-rank ``state_dict``."""
        return {k: block_of(v, self.specs[k], self.mesh.tp, self.mesh.model_index)
                if k in self.specs else v for k, v in state.items()}

