"""Host data loading (counterpart of waveformml_tpu/datasets/data_module.py):
``collate_blocks`` joins file blocks into one batch block, ``DataLoaderLite``
shuffles, batches and collates a dataset's blocks, optionally on a
background thread, and ``PSDDataModule`` builds the training, validation
and test datasets and their loaders from a config. Numpy only; batches stay
on the host until the trainer pads them and copies them to the device."""
from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from waveformml_tpu_torch.config import to_dict
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.ops.sparse import consecutive_event_index
from waveformml_tpu_torch.registry import registry, retrieve_class
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
    ``prefetch_depth`` ahead. Other keyword arguments (a config's
    ``dataloader_params`` for torch's loader, such as ``pin_memory``) are
    ignored."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 num_workers: int = 0, seed: int = 0, prefetch_depth: int = 4,
                 drop_last: bool = False, **_ignored):
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


@registry.register("PSDDataModule", aliases=("PSDDataModule.PSDDataModule",))
class PSDDataModule:
    """The training, validation and test datasets of a config and their
    loaders. ``dataset_config`` names the dataset class and its
    ``dataset_params``; ``n_train``, ``n_validate`` and ``n_test`` are events
    per directory of each split. The validation split excludes the training
    files and the test split both, so no two splits share a file. With
    ``"data_prep": "shuffle"`` the training files are first interleaved
    into combined files (``write_shuffled``). ``train_config``,
    ``val_config`` and ``test_config`` restore a split from a saved dataset
    JSON instead. Loaders take ``dataloader_params`` (``batch_size`` counts
    file blocks); the training loader shuffles. ``half_precision`` makes the
    datasets return float16 features (``use_half``)."""

    def __init__(self, config):
        self.log = logging.getLogger(__name__)
        self.config = config
        dc = config.dataset_config
        self.half_precision = bool(getattr(config.system_config, "half_precision", False))
        if "use_half" not in dc.dataset_params:
            dc.dataset_params["use_half"] = self.half_precision
        self.ntype = len(dc.paths)
        self.total_train = dc.n_train * self.ntype
        self.dataset_class = retrieve_class(dc.dataset_class)
        self.train_dataset = None
        self.val_dataset = None
        self.test_dataset = None
        self.train_excludes: List[str] = []

    def _dataset_params(self, which: str = "dataset_params") -> Dict:
        dc = self.config.dataset_config
        params = getattr(dc, which, None)
        if params is None:
            params = dc.dataset_params
        return to_dict(params)

    def gen_train_dataset(self) -> None:
        if self.train_dataset is not None:
            return
        dc = self.config.dataset_config
        if "train_config" in dc:
            self.train_dataset = self.dataset_class.retrieve_config(
                dc.train_config, self.half_precision)
            self.log.info("Using train dataset from %s.", dc.train_config)
        else:
            self.train_dataset = self.dataset_class(
                self.config, "train", dc.n_train, **self._dataset_params())
            self.log.info("Training dataset generated.")
        self.train_excludes = self.train_dataset.get_file_list()

    def setup(self, stage: Optional[str] = None) -> None:
        """Build the datasets a stage needs: "fit" (or "train") the
        training split, "test" (or "validate") the validation and test
        splits, None all three."""
        dc = self.config.dataset_config
        if stage in ("fit", "train", None):
            self.gen_train_dataset()
            if getattr(dc, "data_prep", None) == "shuffle":
                if "train_config" in dc:
                    self.log.warning(
                        "You specified a training dataset and shuffling data prep; "
                        "shuffling only supports directory lists. Skipping shuffle.")
                else:
                    self.train_dataset.write_shuffled()
        if stage in ("test", "validate", None):
            self.gen_train_dataset()
            if self.val_dataset is None:
                if "val_config" in dc:
                    self.val_dataset = self.dataset_class.retrieve_config(
                        dc.val_config, self.half_precision)
                else:
                    n_validate = getattr(dc, "n_validate", None)
                    if n_validate is None:
                        n_validate = getattr(dc, "n_test", None)
                    if n_validate is None:
                        self.log.warning("dataset_config has no n_validate/n_test; using "
                                         "n_train for the validation split size")
                        n_validate = dc.n_train
                    self.val_dataset = self.dataset_class(
                        self.config, "validate", n_validate,
                        file_excludes=self.train_excludes, **self._dataset_params())
                    self.log.info("Validation dataset generated.")
            if self.test_dataset is None and "n_test" not in dc and "test_config" not in dc:
                self.log.warning("dataset_config has no n_test; using the validation "
                                 "dataset for testing")
                self.test_dataset = self.val_dataset
            if self.test_dataset is None:
                if "test_config" in dc:
                    self.test_dataset = self.dataset_class.retrieve_config(
                        dc.test_config, self.half_precision)
                else:
                    excludes = self.train_excludes + self.val_dataset.get_file_list()
                    params_key = ("test_dataset_params" if "test_dataset_params" in dc
                                  else "dataset_params")
                    self.test_dataset = self.dataset_class(
                        self.config, "test", dc.n_test, file_excludes=excludes,
                        **self._dataset_params(params_key))
                    self.log.info("Test dataset generated.")

    def _loader_params(self) -> Dict:
        return to_dict(getattr(self.config.dataset_config, "dataloader_params", {}) or {})

    def train_dataloader(self) -> DataLoaderLite:
        if self.train_dataset is None:
            self.setup("fit")
        return DataLoaderLite(self.train_dataset, shuffle=True, **self._loader_params())

    def val_dataloader(self) -> DataLoaderLite:
        if self.val_dataset is None:
            self.setup("test")
        return DataLoaderLite(self.val_dataset, shuffle=False, **self._loader_params())

    def test_dataloader(self) -> DataLoaderLite:
        if self.test_dataset is None:
            self.setup("test")
        return DataLoaderLite(self.test_dataset, shuffle=False, **self._loader_params())


@registry.register("GraphDataModule", aliases=("GraphDataModule.GraphDataModule",))
class GraphDataModule(PSDDataModule):
    """The reference's GraphDataModule under its config names (ref:
    src/engineering/GraphDataModule.py:22-52): the loaders are
    ``PSDDataModule``'s, since the task's ``prepare_block`` builds a graph
    model's edges on the host."""
