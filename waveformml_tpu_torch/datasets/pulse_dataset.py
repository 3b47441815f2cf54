"""PulseDataset family: config-bound dataset subclasses and the offline
shuffle (the port's counterpart of waveformml_tpu/datasets/pulse_dataset.py,
behaviour for behaviour).

Each registered subclass binds a file mask, an HDF5 table name, field names
and a normalization. The base class writes the dataset's metadata JSON
under ``<model>/datasets``, and ``write_shuffled()`` (the configs'
``"data_prep": "shuffle"``) merges the per-class files' event ranges into
class-interleaved ``Combined_*`` files with renumbered event indices (gzip
group layout, or compound layout where labels are a per-row field),
``nevents`` attributes and sidecar JSON configs, skipping an output whose
sidecar already covers it. Then it re-roots the dataset at the combined
files. h5py is needed to read and write files (``io.hdf5.open_h5``), not to
import this module.
"""
from __future__ import annotations

import json
import logging
import os
from copy import copy
from typing import Dict, List, Optional

import numpy as np

from waveformml_tpu_torch.config import to_dict
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock, HDF5Dataset
from waveformml_tpu_torch.detector import E_SCALE, Z_SCALE
from waveformml_tpu_torch.io.compound_types import (WaveformNorm, WaveformPairCal,
                                                    WaveformPairNorm)
from waveformml_tpu_torch.io.hdf5 import open_h5
from waveformml_tpu_torch.registry import registry
from waveformml_tpu_torch.utils.util import unique_path_combine


def dataset_class_type_map(dataset_class):
    """Dataset class → on-disk compound type."""
    m = {
        "PulseDatasetWaveformNorm": WaveformNorm,
        "PulseDatasetWFPairNorm": WaveformPairNorm,
        "PulseDatasetWFPair": WaveformPairCal,
        "PulseDatasetWFPairEZ": WaveformPairCal,
        "PulseDatasetRealWFPair": WaveformPairCal,
    }
    name = dataset_class if isinstance(dataset_class, str) else dataset_class.__name__
    cls = m.get(name)
    return cls() if cls else None


def _is_superset(super_range, rng) -> bool:
    return int(super_range[1]) >= int(rng[1]) and int(super_range[0]) <= int(rng[0])


def _file_config_superset(data_info: Dict, fname: str) -> bool:
    """True if the on-disk sidecar covers (is a superset of) data_info.

    A requested source file that is absent from the sidecar (a data file
    added to the directory after the combined files were written) makes it
    return False: the combined file is written again rather than reused
    without the new events."""
    with open(fname) as f:
        on_disk = json.load(f)
    for key, entries in data_info.items():
        k = str(key)
        if k not in on_disk and key not in on_disk:
            return False
        disk_entries = on_disk.get(k, on_disk.get(key))
        for this_info in entries:
            for disk_info in disk_entries:
                if this_info[0] == disk_info[0]:
                    if float(this_info[2]) != float(disk_info[2]):
                        return False
                    if not _is_superset(disk_info[1], this_info[1]):
                        return False
                    break
            else:
                return False  # source file unknown to the sidecar
    return True


class PulseDataset(HDF5Dataset):
    """Base class binding the framework config to HDF5Dataset + shuffle prep."""

    # defaults so retrieve_config-restored instances work without __init__
    label_index: Optional[int] = None
    waveform_subset = None
    label_file_pattern = None

    def __init__(self, config, dataset_type: str, n_per_dir: int,
                 file_mask: str, dataset_name: str,
                 coord_name: str, feat_name: str,
                 file_excludes=None, label_name=None, label_file_pattern=None,
                 data_cache_size: int = 3, batch_index: int = 2,
                 model_dir=None, data_dir=None, dataset_dir=None,
                 normalize: bool = True, use_half: bool = False,
                 event_based: bool = True, additional_fields=None, label_map=None):
        self.file_mask = file_mask
        self.config = config.dataset_config
        self.batch_index = batch_index
        base = getattr(self.config, "base_path", "")
        paths = [os.path.join(base, p) for p in self.config.paths]
        self.n_paths = len(paths)
        self.n_categories = len(self.config.paths)

        super().__init__(paths, file_mask, dataset_name, coord_name, feat_name,
                         int(n_per_dir),
                         file_excludes=file_excludes, label_name=label_name,
                         label_file_pattern=label_file_pattern,
                         data_cache_size=data_cache_size, normalize=normalize,
                         use_half=use_half, event_based=event_based,
                         additional_fields=additional_fields, label_map=label_map)

        self.use_half = use_half
        self.label_file_pattern = label_file_pattern
        self.dataset_type = dataset_type

        # directory layout
        if not model_dir:
            model_dir = os.path.join(config.system_config.model_base_path,
                                     config.system_config.model_name)
        if not data_dir:
            root = os.path.abspath(os.path.dirname(config.system_config.model_base_path))
            sub = getattr(self.config, "name", None) or unique_path_combine(list(self.config.paths))
            data_dir = os.path.join(root, "data", sub)
        self.data_dir = data_dir
        os.makedirs(self.data_dir, exist_ok=True)
        self.dataset_dir = dataset_dir or os.path.join(model_dir, "datasets")
        os.makedirs(self.dataset_dir, exist_ok=True)
        if hasattr(self.config, "name"):
            self.file_path = os.path.join(
                self.dataset_dir, f"{self.config.name}_{dataset_type}_dataset.json")
        else:
            self.file_path = os.path.join(
                self.dataset_dir, f"{dataset_type}_{dataset_name}_{n_per_dir}_dataset.json")

        self.chunk_size = getattr(self.config, "chunk_size", 1024)
        self.shuffled_size = getattr(self.config, "shuffled_size", 16384)
        self.log = logging.getLogger(__name__)
        self.shuffle_queue: List[Dict[int, List]] = []

        if getattr(self.config, "data_prep", None) == "shuffle" and dataset_type == "train":
            self.log.info("Preparing to shuffle the dataset, alternating directory.")
            self._gen_shuffle_map()
        else:
            self.save_info_to_file(self.file_path)

    def save_info_to_file(self, fpath: Optional[str] = None) -> None:
        self.info["dataset_config"] = to_dict(self.config)
        super().save_info_to_file(fpath or self.file_path)

    # -- shuffle-map construction --------------------
    def _gen_shuffle_map(self) -> None:
        self.shuffle_queue = []
        n_per_category = int(self.shuffled_size / max(1, self.n_categories))
        # group by the discovery-time dir_index (config.paths order): mapping
        # dirname(fp) back to a configured path breaks under symlinked roots
        by_cat: Dict[int, List[str]] = {i: [] for i in range(self.n_categories)}
        for di in self.info["data_info"]:
            by_cat[di["dir_index"]].append(di["file_path"])

        current_total = [0] * self.n_categories
        for cat, files in by_cat.items():
            cur_file = 0
            for fp in files:
                di = self.get_path_info(fp)
                n_events = di["event_range"][1] - di["event_range"][0] + 1
                while len(self.shuffle_queue) <= cur_file:
                    self.shuffle_queue.append({c: [] for c in by_cat})
                if n_events <= n_per_category - current_total[cat]:
                    self.shuffle_queue[cur_file][cat].append(
                        [fp, copy(di["event_range"]), di["modified"]])
                    current_total[cat] += n_events
                else:
                    if n_per_category == current_total[cat]:
                        # this output file's quota is exactly full: advance
                        # to the next output file instead of emitting a
                        # degenerate [lo, -1] zero-event chunk (wasted reads
                        # + a junk sidecar entry that defeats superset-skip)
                        cur_file += 1
                        current_total[cat] = 0
                        while len(self.shuffle_queue) <= cur_file:
                            self.shuffle_queue.append({c: [] for c in by_cat})
                        if n_events <= n_per_category:
                            self.shuffle_queue[cur_file][cat].append(
                                [fp, copy(di["event_range"]), di["modified"]])
                            current_total[cat] += n_events
                            continue
                    subrange = [di["event_range"][0], n_per_category - 1 - current_total[cat]]
                    while subrange[1] < di["event_range"][1]:
                        while len(self.shuffle_queue) <= cur_file:
                            self.shuffle_queue.append({c: [] for c in by_cat})
                        self.shuffle_queue[cur_file][cat].append([fp, copy(subrange), di["modified"]])
                        cur_file += 1
                        subrange = [subrange[1] + 1, 0]
                        hi = di["event_range"][1]
                        subrange[1] = hi if hi - subrange[0] + 1 <= n_per_category \
                            else subrange[0] + n_per_category - 1
                        current_total[cat] = 0
                    if subrange[1] >= di["event_range"][1]:
                        subrange[1] = di["event_range"][1]
                        while len(self.shuffle_queue) <= cur_file:
                            self.shuffle_queue.append({c: [] for c in by_cat})
                        self.shuffle_queue[cur_file][cat].append([fp, copy(subrange), di["modified"]])
                        current_total[cat] = subrange[1] - subrange[0] + 1

    # -- shuffle execution ---------------------------
    def _read_range(self, file_info) -> Dict[str, np.ndarray]:
        """Read the rows of one (file, event_range) entry through the
        dataset's LRU-cached column decode (`_get_file_data`): a file split
        across k output files is decoded once, not k times, and the
        group/compound/label-file layout handling lives in one place
        (`_decode_file`)."""
        fp, (lo, hi), _ = file_info
        data = self._get_file_data(fp)
        coords = data["coords"]
        ev = coords[:, self.batch_index]
        sel = (ev >= lo) & (ev <= hi)
        out: Dict[str, np.ndarray] = {"coords": coords[sel],
                                      "feats": data["feats"][sel]}
        if "labels" in data:
            if self.label_file_pattern:
                # label files are per-EVENT, indexed by absolute event id
                out["event_labels"] = data["labels"][lo:hi + 1]
                out["event_lo"] = lo
            else:
                out["labels"] = data["labels"][sel]
        return out

    def _get_label(self, label, cat):
        """Map a per-event raw label to a class index."""
        return cat if label < 3 else self.n_categories

    def _write_shuffled(self, data_info: Dict[int, List], fname: str) -> None:
        sidecar = fname[:-3] + ".json"
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                on_disk = json.load(f)
            as_str_keys = {str(k): v for k, v in data_info.items()}
            if on_disk == as_str_keys or _file_config_superset(data_info, sidecar):
                self.log.info("Already found a valid combined file: %s, skipping.", fname)
                return

        self.log.info("Shuffling data into file %s", fname)
        has_label_field = bool(self.info["label_name"]) and not self.label_file_pattern
        # read all ranges per category, build per-event row slices
        cat_events: Dict[int, List[Dict[str, np.ndarray]]] = {}
        for cat, entries in data_info.items():
            events = []
            for entry in entries:
                chunk = self._read_range(entry)
                if chunk["coords"].size == 0:
                    continue
                ev = chunk["coords"][:, self.batch_index]
                # split rows into per-event groups, in file order
                boundaries = np.flatnonzero(np.diff(ev)) + 1
                row_groups = np.split(np.arange(ev.shape[0]), boundaries)
                for rows in row_groups:
                    item = {"coords": chunk["coords"][rows],
                            "feats": chunk["feats"][rows]}
                    if "labels" in chunk:
                        item["labels"] = chunk["labels"][rows]
                    elif "event_labels" in chunk:
                        # index by the group's ABSOLUTE event id, not its
                        # position among the events that happen to have
                        # rows: an event with zero pulse rows would shift
                        # every later event's label by one
                        e = int(ev[rows[0]]) - chunk["event_lo"]
                        item["event_label"] = chunk["event_labels"][e]
                    events.append(item)
            cat_events[cat] = events

        # round-robin one event per category
        out_coords, out_feats, out_labels, event_labels = [], [], [], []
        iters = {cat: iter(evs) for cat, evs in cat_events.items()}
        pending = dict(iters)
        event_counter = -1
        while pending:
            done = []
            for cat in list(pending):
                try:
                    item = next(pending[cat])
                except StopIteration:
                    done.append(cat)
                    continue
                event_counter += 1
                c = item["coords"].copy()
                c[:, self.batch_index] = event_counter
                out_coords.append(c)
                out_feats.append(item["feats"])
                if has_label_field:
                    out_labels.append(item["labels"])
                elif "event_label" in item:
                    event_labels.append(self._get_label(item["event_label"], cat))
                else:
                    event_labels.append(cat)
            for cat in done:
                pending.pop(cat)

        if not out_coords:
            # every selected event had zero pulse rows: neither output
            # layout can represent an empty combined file (compound needs a
            # row dtype, the gzip group layout needs chunks <= shape), so
            # record the work done and write nothing
            self.log.warning("shuffle output %s collected no rows; skipping",
                             fname)
            with open(sidecar, "w") as f:
                json.dump({str(k): v for k, v in data_info.items()}, f,
                          indent=2, default=str)
            return
        coords = np.concatenate(out_coords)
        feats = np.concatenate(out_feats)
        self._to_hdf(fname, coords, feats,
                     np.concatenate(out_labels) if has_label_field else np.asarray(event_labels, dtype=np.int8),
                     has_label_field, event_counter)
        with open(sidecar, "w") as f:
            json.dump({str(k): v for k, v in data_info.items()}, f, indent=2, default=str)
        self.log.debug("finished shuffling data into file %s", fname)

    def _to_hdf(self, fname: str, coords, feats, labels, has_label_field: bool,
                event_counter: int) -> None:
        """Write a combined file: compound layout
        when labels are a per-row field, gzip group layout otherwise."""
        name = self.info["data_name"]
        with open_h5(fname, "w") as h5:
            if has_label_field:
                label_len = labels.shape[1] if labels.ndim == 2 else 1
                dt = np.dtype([
                    (self.info["coord_name"], coords.dtype, (coords.shape[1],)),
                    (self.info["feat_name"], feats.dtype, (feats.shape[1],)),
                    (self.info["label_name"], labels.dtype, (label_len,)),
                ])
                dset = np.zeros(coords.shape[0], dtype=dt)
                dset[self.info["coord_name"]] = coords
                dset[self.info["feat_name"]] = feats
                dset[self.info["label_name"]] = labels.reshape(coords.shape[0], label_len)
                h5.create_dataset(name, data=dset)
            else:
                csize = min(self.chunk_size, max(1, coords.shape[0]))
                h5.create_dataset(f"{name}/{self.info['coord_name']}", data=coords,
                                  compression="gzip", compression_opts=6,
                                  chunks=(csize, coords.shape[1]))
                h5.create_dataset(f"{name}/{self.info['feat_name']}", data=feats,
                                  compression="gzip", compression_opts=6,
                                  chunks=(csize, feats.shape[1]))
                h5.create_dataset(f"{name}/labels", data=labels,
                                  compression="gzip", compression_opts=6,
                                  chunks=(min(self.chunk_size, max(1, len(labels))),))
            h5[name].attrs.create("nevents", np.array([event_counter + 1]))

    def write_shuffled(self) -> None:
        """Run the full shuffle queue, then re-root the dataset at the combined
        directory."""
        while self.shuffle_queue:
            shuffle_length = len(self.shuffle_queue)
            if "*" in self.file_mask:
                suffix = self.file_mask[self.file_mask.index("*") + 1:]
            else:
                suffix = self.file_mask
            fname = f"Combined_{shuffle_length - 1}_{suffix}"
            self._write_shuffled(self.shuffle_queue.pop(), os.path.join(self.data_dir, fname))
        self.log.info("Shuffling finished; re-rooting dataset at %s", self.data_dir)
        # normalize carries through the re-init. label_map carries only
        # when the combined files store the raw per-row label field
        # (compound layout): group-layout files store FINAL class indices
        # (directory index or _get_label output), and re-mapping those would
        # double-apply the map.
        raw_labels = bool(self.info["label_name"]) and not self.label_file_pattern
        label_map = self.info.get("label_map") if raw_labels else None
        if self.info.get("additional_fields"):
            # _write_shuffled emits only coord/feat/label columns, so extras
            # cannot survive a shuffle
            self.log.warning(
                "additional_fields %s are not propagated into combined "
                "shuffle files and will be absent after re-rooting; use "
                "data_prep without shuffle to keep them",
                self.info["additional_fields"])
        HDF5Dataset.__init__(self, [self.data_dir], self.file_mask,
                             self.info["data_name"], self.info["coord_name"],
                             self.info["feat_name"],
                             self.info["events_per_dir"] * self.n_paths,
                             # group-layout combined files always store the
                             # class index under "labels", whatever the
                             # source label column was called
                             label_name=self.info["label_name"] if raw_labels else "labels",
                             data_cache_size=self.info["data_cache_size"],
                             normalize=self.normalize,
                             label_map=label_map,
                             use_half=self.use_half)
        self.save_info_to_file()


def _label_index_getitem(self, idx):
    block = PulseDataset.__getitem__(self, idx)
    if getattr(self, "label_index", None) is not None and block.labels.ndim == 2:
        return FileBlock(block.coords, block.feats,
                         block.labels[:, self.label_index], block.extras)
    return block


# ---------------------------------------------------------------------------------
# concrete dataset classes
# ---------------------------------------------------------------------------------

@registry.register("PulseDataset2D", aliases=("PulseDataset.PulseDataset2D",))
class PulseDataset2D(PulseDataset):
    """*WaveformPairSim.h5 / WaveformPairs / coord+waveform."""

    def __init__(self, config, dataset_type, n_per_dir, file_excludes=None,
                 label_name=None, label_file_pattern=None, data_cache_size=3,
                 model_dir=None, data_dir=None, dataset_dir=None, use_half=False):
        super().__init__(config, dataset_type, n_per_dir,
                         "*WaveformPairSim.h5", "WaveformPairs", "coord", "waveform",
                         file_excludes=file_excludes, label_name=label_name,
                         label_file_pattern=label_file_pattern,
                         data_cache_size=data_cache_size, model_dir=model_dir,
                         data_dir=data_dir, dataset_dir=dataset_dir, use_half=use_half)


@registry.register("PulseDataset3D", aliases=("PulseDataset.PulseDataset3D",))
class PulseDataset3D(PulseDataset):
    """*Waveform3DPairSim.h5 with batch index at coord column 3."""

    def __init__(self, config, dataset_type, n_per_dir, file_excludes=None,
                 label_name=None, label_file_pattern=None, data_cache_size=3,
                 model_dir=None, data_dir=None, dataset_dir=None, use_half=False):
        super().__init__(config, dataset_type, n_per_dir,
                         "*Waveform3DPairSim.h5", "Waveform3DPairs", "coord", "waveform",
                         batch_index=3, file_excludes=file_excludes,
                         label_name=label_name, label_file_pattern=label_file_pattern,
                         data_cache_size=data_cache_size, model_dir=model_dir,
                         data_dir=data_dir, dataset_dir=dataset_dir, use_half=use_half)


@registry.register("PulseDatasetPMT", aliases=("PulseDataset.PulseDatasetPMT",))
class PulseDatasetPMT(PulseDataset):
    """*PMTCoordSim.h5 with per-feature normalization vector."""

    NORMALIZATION = np.array(
        [1.0 / 16383, 1.0 / 163830, 0.001, 1.0, 1.0 / 16383, 1.0 / 163830, 0.001, 1.0],
        dtype=np.float32)

    def __init__(self, config, dataset_type, n_per_dir, file_excludes=None,
                 label_name=None, label_file_pattern=None, data_cache_size=3,
                 model_dir=None, data_dir=None, dataset_dir=None, use_half=False):
        super().__init__(config, dataset_type, n_per_dir,
                         "*PMTCoordSim.h5", "DetPulseCoord", "coord", "pulse",
                         batch_index=2, file_excludes=file_excludes,
                         label_name=label_name, label_file_pattern=label_file_pattern,
                         data_cache_size=data_cache_size, model_dir=model_dir,
                         data_dir=data_dir, dataset_dir=dataset_dir,
                         normalize=False, use_half=use_half)

    def __getitem__(self, idx):
        block = super().__getitem__(idx)
        n = block.feats.shape[1]
        # scale in the block's own dtype: a float32 multiplier would promote
        # use_half's float16 feats back to float32
        norm = self.NORMALIZATION[:n].astype(block.feats.dtype)
        return FileBlock(block.coords, block.feats * norm,
                         block.labels, block.extras)


@registry.register("PulseDatasetDet", aliases=("PulseDataset.PulseDatasetDet",))
class PulseDatasetDet(PulseDataset):
    """*DetCoordSim.h5 / DetPulseCoord 7-feature phys pulses."""

    def __init__(self, config, dataset_type, n_per_dir, file_excludes=None,
                 label_name=None, label_file_pattern=None, data_cache_size=3,
                 model_dir=None, data_dir=None, dataset_dir=None, use_half=False):
        super().__init__(config, dataset_type, n_per_dir,
                         "*DetCoordSim.h5", "DetPulseCoord", "coord", "pulse",
                         file_excludes=file_excludes, label_name=label_name,
                         label_file_pattern=label_file_pattern,
                         data_cache_size=data_cache_size, model_dir=model_dir,
                         data_dir=data_dir, dataset_dir=dataset_dir,
                         use_half=use_half, normalize=False)


@registry.register("PulseDataset2DWithZ", aliases=("PulseDataset.PulseDataset2DWithZ",))
class PulseDataset2DWithZ(PulseDataset):
    """*WaveformPairZSim.h5 with per-segment z labels."""

    def __init__(self, config, dataset_type, n_per_dir, file_excludes=None,
                 label_name="z", label_file_pattern=None, data_cache_size=3,
                 model_dir=None, data_dir=None, dataset_dir=None, use_half=False):
        super().__init__(config, dataset_type, n_per_dir,
                         "*WaveformPairZSim.h5", "WaveformPairsWithZ", "coord", "waveform",
                         file_excludes=file_excludes, label_name=label_name,
                         label_file_pattern=label_file_pattern,
                         data_cache_size=data_cache_size, model_dir=model_dir,
                         data_dir=data_dir, dataset_dir=dataset_dir, use_half=use_half)


@registry.register("PulseDataset2DWithEZ", aliases=("PulseDataset.PulseDataset2DWithEZ",))
class PulseDataset2DWithEZ(PulseDataset):
    """*WaveformPairEZSim.h5 with (E,z) labels."""

    def __init__(self, config, dataset_type, n_per_dir, file_excludes=None,
                 label_file_pattern=None, data_cache_size=3, model_dir=None,
                 data_dir=None, dataset_dir=None, use_half=False, label_index=None):
        super().__init__(config, dataset_type, n_per_dir,
                         "*WaveformPairEZSim.h5", "WaveformPairsWithEZ", "coord", "waveform",
                         file_excludes=file_excludes, label_name="EZ",
                         label_file_pattern=label_file_pattern,
                         data_cache_size=data_cache_size, model_dir=model_dir,
                         data_dir=data_dir, dataset_dir=dataset_dir, use_half=use_half)
        self.label_index = label_index

    __getitem__ = _label_index_getitem


@registry.register("PulseDatasetDetWithZ", aliases=("PulseDataset.PulseDatasetDetWithZ",))
class PulseDatasetDetWithZ(PulseDataset):
    """*DetCoordZSim.h5 phys features + z labels."""

    def __init__(self, config, dataset_type, n_per_dir, file_excludes=None,
                 label_name="z", label_file_pattern=None, data_cache_size=3,
                 model_dir=None, data_dir=None, dataset_dir=None, use_half=False,
                 additional_fields=None):
        super().__init__(config, dataset_type, n_per_dir,
                         "*DetCoordZSim.h5", "DetPulseCoordWithZ", "coord", "pulse",
                         file_excludes=file_excludes, label_name=label_name,
                         label_file_pattern=label_file_pattern,
                         data_cache_size=data_cache_size, model_dir=model_dir,
                         data_dir=data_dir, dataset_dir=dataset_dir,
                         use_half=use_half, normalize=False,
                         additional_fields=additional_fields)


@registry.register("PulseDatasetDetWithEZ", aliases=("PulseDataset.PulseDatasetDetWithEZ",))
class PulseDatasetDetWithEZ(PulseDataset):
    """*DetCoordEZSim.h5 phys features + (E,z) labels."""

    def __init__(self, config, dataset_type, n_per_dir, file_excludes=None,
                 label_file_pattern=None, data_cache_size=3, model_dir=None,
                 data_dir=None, dataset_dir=None, use_half=False, label_index=None,
                 additional_fields=None):
        super().__init__(config, dataset_type, n_per_dir,
                         "*DetCoordEZSim.h5", "DetPulseCoordWithEZ", "coord", "pulse",
                         file_excludes=file_excludes, label_name="EZ",
                         label_file_pattern=label_file_pattern,
                         data_cache_size=data_cache_size, model_dir=model_dir,
                         data_dir=data_dir, dataset_dir=dataset_dir,
                         use_half=use_half, normalize=False,
                         additional_fields=additional_fields)
        self.label_index = label_index

    __getitem__ = _label_index_getitem


@registry.register("PulseDatasetWFPair", aliases=("PulseDataset.PulseDatasetWFPair",))
class PulseDatasetWFPair(PulseDataset):
    """*WFPairSim.h5 / WaveformPairCal raw ADC pairs."""

    def __init__(self, config, dataset_type, n_per_dir, file_excludes=None,
                 label_file_pattern=None, data_cache_size=3, model_dir=None,
                 data_dir=None, dataset_dir=None, use_half=False, label_index=None,
                 label_name=None, additional_fields=None, label_map=None):
        super().__init__(config, dataset_type, n_per_dir,
                         "*WFPairSim.h5", "WaveformPairCal", "coord", "waveform",
                         file_excludes=file_excludes,
                         label_file_pattern=label_file_pattern,
                         data_cache_size=data_cache_size, model_dir=model_dir,
                         data_dir=data_dir, dataset_dir=dataset_dir,
                         use_half=use_half, label_name=label_name,
                         additional_fields=additional_fields,
                         label_map=label_map)
        self.label_index = label_index

    __getitem__ = _label_index_getitem


@registry.register("PulseDatasetWFPairEZ", aliases=("PulseDataset.PulseDatasetWFPairEZ",))
class PulseDatasetWFPairEZ(PulseDatasetWFPair):
    """*WFPairSim.h5 with EZ labels."""

    def __init__(self, config, dataset_type, n_per_dir, label_name="EZ", **kwargs):
        super().__init__(config, dataset_type, n_per_dir, label_name=label_name, **kwargs)


@registry.register("PulseDatasetRealWFPair", aliases=("PulseDataset.PulseDatasetRealWFPair",))
class PulseDatasetRealWFPair(PulseDataset):
    """Real data *WFCalFilteredSE.h5 with z→z/1200+0.5 (or E→E/12) label
    normalization."""

    def __init__(self, config, dataset_type, n_per_dir, file_pattern="*WFCalFilteredSE.h5",
                 file_excludes=None, label_file_pattern=None, data_cache_size=3,
                 model_dir=None, data_dir=None, dataset_dir=None, use_half=False,
                 label_name="z", additional_fields=None, label_map=None):
        super().__init__(config, dataset_type, n_per_dir,
                         file_pattern, "WaveformPairCal", "coord", "waveform",
                         file_excludes=file_excludes,
                         label_file_pattern=label_file_pattern,
                         data_cache_size=data_cache_size, model_dir=model_dir,
                         data_dir=data_dir, dataset_dir=dataset_dir,
                         use_half=use_half, label_name=label_name,
                         additional_fields=additional_fields, label_map=label_map)

    def __getitem__(self, idx):
        block = super().__getitem__(idx)
        name = self.info["label_name"]
        if name == "z":
            y = block.labels / np.float32(Z_SCALE) + np.float32(0.5)
        elif name == "E":
            y = block.labels / np.float32(E_SCALE)
        else:
            return block
        return FileBlock(block.coords, block.feats, y, block.extras)


@registry.register("PulseDatasetWFPairNorm", aliases=("PulseDataset.PulseDatasetWFPairNorm",))
class PulseDatasetWFPairNorm(PulseDataset):
    """*WFNorm.h5 normalized pairs, optional waveform_subset window slicing
   ."""

    def __init__(self, config, dataset_type, n_per_dir, data_name="pulse",
                 file_excludes=None, label_file_pattern=None, data_cache_size=3,
                 model_dir=None, data_dir=None, dataset_dir=None, use_half=False,
                 label_index=None, label_name="EZ", additional_fields=None,
                 label_map=None, waveform_subset=None):
        super().__init__(config, dataset_type, n_per_dir,
                         "*WFNorm.h5", "WaveformPairNorm", "coord", data_name,
                         file_excludes=file_excludes,
                         label_file_pattern=label_file_pattern,
                         data_cache_size=data_cache_size, model_dir=model_dir,
                         data_dir=data_dir, dataset_dir=dataset_dir,
                         use_half=use_half, label_name=label_name, normalize=False,
                         additional_fields=additional_fields, label_map=label_map)
        self.label_index = label_index
        self.waveform_subset = waveform_subset

    def __getitem__(self, idx):
        block = PulseDataset.__getitem__(self, idx)
        feats = block.feats
        if self.waveform_subset is not None:
            n = feats.shape[1] // 2
            lo, hi = self.waveform_subset
            keep = np.array([(lo <= i <= hi) for i in range(n)] * 2)
            feats = feats[:, keep]
        y = block.labels
        if self.label_index is not None and y.ndim == 2:
            y = y[:, self.label_index]
        return FileBlock(block.coords, feats, y, block.extras)


@registry.register("PulseDatasetWaveformNorm", aliases=("PulseDataset.PulseDatasetWaveformNorm",))
class PulseDatasetWaveformNorm(PulseDataset):
    """*PulseNorm.h5 single-waveform records with scalar ``det`` coordinate,
    event_based=False."""

    def __init__(self, config, dataset_type, n_per_dir, data_name="pulse",
                 file_excludes=None, label_file_pattern=None, data_cache_size=3,
                 model_dir=None, data_dir=None, dataset_dir=None, use_half=False,
                 label_index=None, label_name="EZ", additional_fields=None,
                 label_map=None):
        super().__init__(config, dataset_type, n_per_dir,
                         "*PulseNorm.h5", "WaveformNorm", "det", data_name,
                         file_excludes=file_excludes,
                         label_file_pattern=label_file_pattern,
                         data_cache_size=data_cache_size, model_dir=model_dir,
                         data_dir=data_dir, dataset_dir=dataset_dir,
                         use_half=use_half, label_name=label_name, normalize=False,
                         event_based=False, additional_fields=additional_fields,
                         label_map=label_map)
        self.label_index = label_index

    __getitem__ = _label_index_getitem


@registry.register("PulseDatasetNormFeatures", aliases=("PulseDataset.PulseDatasetNormFeatures",))
class PulseDatasetNormFeatures(PulseDataset):
    """*WFFeatures.h5 extracted per-segment feature vectors."""

    def __init__(self, config, dataset_type, n_per_dir, data_name="features",
                 file_excludes=None, label_file_pattern=None, data_cache_size=3,
                 model_dir=None, data_dir=None, dataset_dir=None, use_half=False,
                 label_index=None, label_name="EZ", additional_fields=None,
                 label_map=None):
        super().__init__(config, dataset_type, n_per_dir,
                         "*WFFeatures.h5", "NormFeatures", "coord", data_name,
                         file_excludes=file_excludes,
                         label_file_pattern=label_file_pattern,
                         data_cache_size=data_cache_size, model_dir=model_dir,
                         data_dir=data_dir, dataset_dir=dataset_dir,
                         use_half=use_half, label_name=label_name, normalize=False,
                         event_based=False, additional_fields=additional_fields,
                         label_map=label_map)
        self.label_index = label_index

    __getitem__ = _label_index_getitem
