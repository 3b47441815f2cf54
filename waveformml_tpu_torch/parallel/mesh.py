"""Data parallelism over ranks (counterpart of waveformml_tpu/parallel/mesh.py
and of the loader sharding of waveformml_tpu/engineering/trainer.py).

The JAX package runs one process per host over a mesh of its local devices
and splits each block over them (``split_block_for_devices``); the port
runs one process per GPU, PyTorch's idiom: a JAX run of P processes with D
devices each is P·D ranks here. At step t rank r trains on loader batch
t·W + r (``shard_loader_round_robin``, W the world size), so D ranks fed
``split_block_for_devices(B, D)[r]`` in turn equal the JAX package's
single-process mesh of D devices fed B. ``initialize_distributed`` starts
``torch.distributed``: NCCL for the card, Gloo on the CPU, unless the
caller names a backend.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock

log = logging.getLogger(__name__)

#: how long a rank waits for the others at the rendezvous and in a collective
TIMEOUT = datetime.timedelta(minutes=10)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: Optional[Union[str, torch.device]] = None
                           ) -> Tuple[int, int, torch.device, "torch.distributed.ProcessGroup"]:
    """Join the process group (``torch.distributed.init_process_group``)
    and return ``(rank, world size, device, group)``.

    ``coordinator`` is ``host:port`` (``tcp://`` is prepended) or a URL of
    its own (``file://...``); without one the rendezvous is torchrun's
    ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``),
    the counterpart of JAX's auto-discovery. The device is
    ``cuda:<local rank>`` (``LOCAL_RANK``, else the rank), made the current
    device, unless ``device`` is given; a card that does not exist raises.
    The backend is ``nccl`` for a CUDA device and ``gloo`` on the CPU unless
    ``backend`` is given."""
    import torch.distributed as dist

    kwargs = {}
    if coordinator is None:
        init_method = "env://"
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        kwargs.update(world_size=int(num_processes), rank=int(process_id))
    if device is None:
        rank = int(process_id if process_id is not None else os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank))
        if not torch.cuda.is_available() or local >= torch.cuda.device_count():
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise RuntimeError(f"rank {rank} needs cuda:{local}, and this host has {found} "
                               "CUDA device(s); pass device='cpu' to train on the CPU")
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method=init_method, timeout=TIMEOUT, **kwargs)
    log.info("rank %d of %d on %s (%s)", dist.get_rank(), dist.get_world_size(), device,
             dist.get_backend())
    return dist.get_rank(), dist.get_world_size(), device, dist.group.WORLD


def _balanced_bounds(n: int, parts: int) -> List[int]:
    """Bounds of ``parts`` contiguous ranges over ``n`` items, the first
    ``n % parts`` one item longer."""
    base, extra = divmod(n, parts)
    bounds = [0]
    for d in range(parts):
        bounds.append(bounds[-1] + base + (1 if d < extra else 0))
    return bounds


def split_block_for_devices(block: FileBlock, n_devices: int) -> List[FileBlock]:
    """Split a multi-event block into ``n_devices`` event-contiguous blocks,
    the events renumbered from 0 in each, the first ``n_events %
    n_devices`` one event longer; with fewer events than parts the trailing
    blocks are empty (BatchNorm and the loss sum masked counts over the
    ranks, so an empty block adds zeros). The event column is the last
    (``[x, y, event]`` or ``[x, y, t, event]``). Event labels are cut by
    event, per-row labels and extras by row; cached padded edge lists
    (``edges_<k>`` with ``edge_mask_<k>``) keep their live edges, remapped
    to the block's rows (an edge joins rows of one event, so it lands
    whole in one block); an edge list without its mask is dropped, and
    ``prepare_block`` builds it again. Per-row data without events (``[N]``
    coords) is split by rows."""
    if n_devices == 1:
        return [block]
    if block.coords.ndim != 2:
        bounds = _balanced_bounds(block.coords.shape[0], n_devices)
        return [FileBlock(block.coords[lo:hi], block.feats[lo:hi], block.labels[lo:hi],
                          {k: v[lo:hi] for k, v in block.extras.items()})
                for lo, hi in zip(bounds[:-1], bounds[1:])]
    ev = block.coords[:, -1]
    n_events = int(ev[-1]) + 1 if len(ev) else 0
    bounds = _balanced_bounds(n_events, n_devices)
    out = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        sel = (ev >= lo) & (ev < hi)
        coords = block.coords[sel].copy()
        coords[:, -1] -= lo
        labels = block.labels[lo:hi] if block.labels.shape[0] == n_events else block.labels[sel]
        extras: Dict[str, np.ndarray] = {}
        row_map = None
        for k, v in block.extras.items():
            if k.startswith("edge_mask_"):
                continue
            if not k.startswith("edges_"):
                extras[k] = v[sel]
                continue
            mask = block.extras.get("edge_mask_" + k[len("edges_"):])
            if mask is None:
                continue
            edges = np.asarray(v)[:, np.asarray(mask, dtype=bool)]
            if row_map is None:
                row_map = np.full(sel.shape[0], -1, dtype=np.int64)
                row_map[sel] = np.arange(int(sel.sum()))
            edges = row_map[edges[:, sel[edges[0]] & sel[edges[1]]]]
            extras[k] = edges
            extras["edge_mask_" + k[len("edges_"):]] = np.ones(edges.shape[1], dtype=bool)
        out.append(FileBlock(coords, block.feats[sel], labels, extras))
    return out


def pad_to(a: np.ndarray, shape: Tuple[int, ...]) -> np.ndarray:
    """``a`` zero-padded at the end of each dim to ``shape`` (safe for every
    prepared array: masks pad False, edges pad to row 0 with their mask
    False, the site layout's slots pad empty)."""
    if a.shape == tuple(shape):
        return a
    return np.pad(a, [(0, t - s) for s, t in zip(a.shape, shape)])


def stack_shards(shards: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack prepared batches along a new leading axis, each array first
    padded to the largest shape among them (``pad_to``)."""
    out = {}
    for k in shards[0]:
        arrs = [np.asarray(s[k]) for s in shards]
        target = tuple(np.max([a.shape for a in arrs], axis=0))
        out[k] = np.stack([pad_to(a, target) for a in arrs])
    return out


class RoundRobinLoader:
    """Rank ``rank``'s view of ``loader`` among ``world`` ranks (torch's
    DistributedSampler semantics): at step t the loader's batch t·world +
    rank, ``ceil(len / world)`` batches a rank; the missing tail slots
    replay the loader's first batches, cycling them where there are more
    slots than batches, so no batch is dropped and every rank steps the
    same number of times. Iterating reads the whole loader; the loader's
    iterator is closed with this one's."""

    def __init__(self, loader, world: int, rank: int):
        self.loader, self.world, self.rank = loader, world, rank
        self.n = -(-len(loader) // world)

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        total = self.n * self.world
        pad = total - len(self.loader)
        head = []              # the leading batches, replayed for the tail slots
        i = 0
        it = iter(self.loader)
        try:
            for b in it:
                if len(head) < pad:
                    head.append(b)
                if i % self.world == self.rank:
                    yield b
                i += 1
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()
        while i < total and head:
            for b in head:
                if i >= total:
                    break
                if i % self.world == self.rank:
                    yield b
                i += 1


def shard_loader_round_robin(loader, n_proc: int, proc: int) -> RoundRobinLoader:
    """``RoundRobinLoader(loader, n_proc, proc)``; logs the padding once,
    from rank 0."""
    sharded = RoundRobinLoader(loader, n_proc, proc)
    pad = sharded.n * n_proc - len(loader)
    if pad and proc == 0:
        log.info("data-parallel loader: padding %d trailing slot(s) by wrapping to the first "
                 "batches (len=%d, ranks=%d)", pad, len(loader), n_proc)
    return sharded
