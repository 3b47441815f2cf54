"""Host data loading (counterpart of waveformml_tpu/datasets/data_module.py):
``collate_blocks`` joins file blocks into one batch block, ``DataLoaderLite``
shuffles, batches and collates a dataset's blocks, optionally on a
background thread. Numpy only; batches stay on the host until the trainer
pads them and copies them to the device."""
from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np

from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.ops.sparse import consecutive_event_index
from waveformml_tpu_torch.utils.util import prefetch_iter


def collate_blocks(blocks: Sequence[FileBlock]) -> FileBlock:
    """Concatenate file blocks, offsetting each block's event column by the
    events before it so that events stay distinct, then renumber the events
    0..B-1. ``edges_*`` extras hold block-local row indices and are shifted
    by the rows before their block (along the edge axis); other extras are
    concatenated along rows."""
    if len(blocks) == 1:
        merged = blocks[0]
    else:
        coords_list, offset = [], 0
        for b in blocks:
            c = b.coords.copy()
            if c.ndim == 2:
                c[:, -1] += offset
            offset += b.labels.shape[0]
            coords_list.append(c)
        row_offsets = np.cumsum([0] + [b.coords.shape[0] for b in blocks])
        extras = {}
        for k in blocks[0].extras:
            if k.startswith("edges_"):
                extras[k] = np.concatenate([b.extras[k] + row_offsets[i]
                                            for i, b in enumerate(blocks)], axis=1)
            else:
                extras[k] = np.concatenate([b.extras[k] for b in blocks])
        merged = FileBlock(coords=np.concatenate(coords_list),
                           feats=np.concatenate([b.feats for b in blocks]),
                           labels=np.concatenate([b.labels for b in blocks]),
                           extras=extras)
    if merged.coords.ndim == 2:
        c = merged.coords.copy()
        c[:, -1] = consecutive_event_index(c[:, -1])
        merged = FileBlock(c, merged.feats, merged.labels, merged.extras)
    return merged


class DataLoaderLite:
    """Batches of ``batch_size`` dataset items (``len(dataset)``,
    ``dataset[i]`` a ``FileBlock``), collated into one block each. With
    ``shuffle`` the item order is drawn anew each epoch from
    ``np.random.default_rng(seed)``; ``drop_last`` drops a short last batch;
    ``num_workers > 0`` loads batches on a background thread, up to
    ``prefetch_depth`` ahead."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 0, seed: int = 0, prefetch_depth: int = 4,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = max(1, int(batch_size))
        self.shuffle = shuffle
        self.num_workers = int(num_workers)
        self.prefetch_depth = prefetch_depth
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self) -> List[List[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        if self.drop_last:
            idx = idx[:(len(idx) // self.batch_size) * self.batch_size]
        return [idx[i:i + self.batch_size].tolist()
                for i in range(0, len(idx), self.batch_size)]

    def _load(self, batch_idx: List[int]) -> FileBlock:
        return collate_blocks([self.dataset[i] for i in batch_idx])

    def __iter__(self) -> Iterator[FileBlock]:
        batches = self._index_batches()
        if self.num_workers <= 0:
            for b in batches:
                yield self._load(b)
            return
        yield from prefetch_iter((self._load(b) for b in batches), depth=self.prefetch_depth)
