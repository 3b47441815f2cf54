"""HDF5 event dataset: directories of HDF5 files → per-file-block numpy
arrays (the port's counterpart of waveformml_tpu/datasets/hdf5_dataset.py,
behaviour for behaviour).

One index is one *file block*, not one event: ``dataset[i]`` is a
``FileBlock`` of the rows of file i's allotted event range. It keeps:

* the round-robin file order across directories, which balances classes;
* per-file event accounting from the ``nevents`` attribute, capped per
  directory at ``events_per_dir``;
* an LRU cache of decoded files (``data_cache_size``);
* the directory index as the event label where there is no label field;
* labels from separate files (``label_file_pattern``);
* ``label_map`` remapping, ``normalize`` (× 1/16383), ``use_half``
  (float16 features) and ``additional_fields`` passed through as extras;
* the compound-table mode and the group mode (shuffled "Combined" files);
* ``retrieve_config`` / ``save_info_to_file``, the JSON metadata
  round-trip.

Everything stays on the host in numpy; the task pads blocks into device
batches. h5py is needed to read files (``io.hdf5.open_h5``), not to import
this module.
"""
from __future__ import annotations

import json
import logging
import os
import re
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from waveformml_tpu_torch.detector import MAX_RANGE
from waveformml_tpu_torch.io.hdf5 import is_group, open_h5
from waveformml_tpu_torch.utils.util import replace_file_pattern

FILENAME_SORT_REGEX = re.compile(r"_(\d+)")
MAX_RANGE_INV = 1.0 / MAX_RANGE


def _sort_pattern(name) -> Any:
    """Order of files in a directory: numbered names ('run_12_x.h5') by
    their first number, before unnumbered ones, which sort by name."""
    nums = FILENAME_SORT_REGEX.findall(str(name))
    return (0, int(nums[0]), "") if nums else (1, 0, str(name))


@dataclass
class FileBlock:
    """One dataset item: a multi-event block of pulse rows."""

    coords: np.ndarray                 # [N, 3] int32 (x, y, event) or [N] detector ids
    feats: np.ndarray                  # [N, F]
    labels: np.ndarray                 # [B] event labels, or per row
    extras: Dict[str, np.ndarray] = field(default_factory=dict)  # per-row fields, edge lists


class HDF5Dataset:
    """``len()`` file blocks; ``[i]`` the i-th ``FileBlock``."""

    def __init__(self, file_paths: Sequence[str], file_pattern: str, data_name: str,
                 coordinate_name: str, feature_name: str, events_per_dir: int,
                 recursive: bool = False, file_excludes: Optional[Sequence[str]] = None,
                 label_name: Optional[str] = None, label_file_pattern: Optional[str] = None,
                 data_cache_size: int = 3, normalize: bool = False, use_half: bool = False,
                 event_based: bool = True, additional_fields: Optional[Sequence[str]] = None,
                 label_map: Optional[Dict] = None):
        self.log = logging.getLogger(__name__)
        self.file_paths = [os.path.normpath(os.path.abspath(f)) for f in file_paths]
        self.num_dirs = len(self.file_paths)
        self.normalize = normalize
        self.half_precision = use_half
        self.n_events = [0] * self.num_dirs
        self.group_mode = False
        self.ordered_file_set: List[str] = []
        self._cache: "OrderedDict[str, Dict[str, np.ndarray]]" = OrderedDict()
        self._peeked: Dict[str, Tuple[int, bool]] = {}
        self.info: Dict[str, Any] = {
            "file_paths": self.file_paths,
            "data_info": [],
            "data_cache_size": data_cache_size,
            "data_name": data_name,
            "coord_name": coordinate_name,
            "feat_name": feature_name,
            "label_name": label_name,
            "label_file_pattern": label_file_pattern,
            "file_pattern": file_pattern,
            "events_per_dir": events_per_dir,
            "event_based": event_based,
            "additional_fields": list(additional_fields) if additional_fields else None,
            "label_map": {int(k): v for k, v in label_map.items()} if label_map else None,
        }
        if label_file_pattern and not label_name:
            raise ValueError("label_file_pattern requires label_name (the dataset name "
                             "inside the label files)")

        excludes = set(str(Path(f).resolve()) for f in (file_excludes or []))
        all_files: List[List[Path]] = []
        for file_path in self.file_paths:
            p = Path(file_path)
            if not p.is_dir():
                raise RuntimeError(f"{p.resolve()} is not a valid directory.")
            glob_pat = f"**/{file_pattern}" if recursive else file_pattern
            files = sorted(p.glob(glob_pat), key=_sort_pattern)
            files = [f for f in files if str(f.resolve()) not in excludes]
            if not files:
                if excludes:
                    raise RuntimeError("No remaining datasets available, lower the number of "
                                       "training and / or validation data")
                raise RuntimeError(f"No hdf5 datasets found in {file_path}")
            all_files.append(files)

        # each file keeps the index of the directory it was found in
        if len(all_files) == 1:
            ordered = [(f, 0) for f in all_files[0]]
        else:
            # round-robin across directories, each up to its event cap
            tally = [0] * len(all_files)
            queues = [list(fs) for fs in all_files]
            ordered = []
            while any(q and t < events_per_dir for q, t in zip(queues, tally)):
                for i, q in enumerate(queues):
                    while q and tally[i] < events_per_dir:
                        f = q.pop(0)
                        ordered.append((f, i))
                        tally[i] += self._peek_event_num(str(f.resolve()), data_name,
                                                         event_based)
                        if tally[i] >= max(tally):
                            break

        for f, dir_index in ordered:
            fp = str(Path(f).resolve())
            if self.n_events[dir_index] >= events_per_dir:
                continue
            self.ordered_file_set.append(fp)
            self._add_data_info(fp, dir_index)

    # -- metadata round-trip ----------------------------------------------------------
    @classmethod
    def retrieve_config(cls, config_path: str, use_half: bool = False) -> "HDF5Dataset":
        """A dataset restored from the JSON that ``save_info_to_file``
        wrote, without reading any file."""
        with open(config_path) as f:
            info = json.load(f)
        self = cls.__new__(cls)
        self.log = logging.getLogger(__name__)
        self.info = info
        self.file_paths = info["file_paths"]
        self.num_dirs = len(self.file_paths)
        self.normalize = info.get("normalize", False)
        self.half_precision = use_half
        self.n_events = info.get("n_events", [0] * self.num_dirs)
        self.group_mode = info.get("group_mode", False)
        self.ordered_file_set = [di["file_path"] for di in info["data_info"]]
        self._cache = OrderedDict()
        self._peeked = {}
        if info.get("label_map"):
            self.info["label_map"] = {int(k): v for k, v in info["label_map"].items()}
        return self

    def save_info_to_file(self, fpath: str) -> None:
        out = dict(self.info)
        out["normalize"] = self.normalize
        out["group_mode"] = self.group_mode
        out["n_events"] = self.n_events
        os.makedirs(os.path.dirname(os.path.abspath(fpath)), exist_ok=True)
        with open(fpath, "w") as f:
            json.dump(out, f, indent=2, default=str)

    # -- discovery ----------------------------------------------------------------------
    def _count_events(self, node, event_based: bool) -> Tuple[int, bool]:
        group_mode = is_group(node)
        if event_based:
            n = int(node.attrs.get("nevents")[0])
        elif group_mode:
            n = int(node[self.info["coord_name"]].shape[0])
        else:
            n = int(node.shape[0])
        return n, group_mode

    def _peek_event_num(self, fp: str, data_name: str, event_based: bool) -> int:
        with open_h5(fp, "r") as h5:
            self._peeked[fp] = self._count_events(h5[data_name], event_based)
        return self._peeked[fp][0]

    def _add_data_info(self, fp: str, dir_index: int) -> None:
        if fp not in self._peeked:
            with open_h5(fp, "r") as h5:
                self._peeked[fp] = self._count_events(h5[self.info["data_name"]],
                                                      self.info["event_based"])
        n_file_events, self.group_mode = self._peeked[fp]
        n = min(n_file_events, self.info["events_per_dir"] - self.n_events[dir_index])
        self.n_events[dir_index] += n
        self.info["data_info"].append({
            "file_path": fp,
            "modified": os.path.getmtime(fp),
            "n_events": n_file_events,
            "event_range": [0, n - 1],
            "dir_index": dir_index,
        })
        if self.info["label_file_pattern"]:
            lf = self._label_file_for(fp)
            if not os.path.exists(lf):
                raise RuntimeError(f"No corresponding label file found for file {fp}, "
                                   f"tried {lf}")

    def _label_file_for(self, fp: str) -> str:
        fname = replace_file_pattern(os.path.basename(fp), self.info["file_pattern"],
                                     self.info["label_file_pattern"])
        return os.path.join(os.path.dirname(fp), fname)

    # -- cache and decode ---------------------------------------------------------------
    def _decode_file(self, fp: str) -> Dict[str, np.ndarray]:
        """Every column the dataset needs of one file, as numpy arrays."""
        out: Dict[str, np.ndarray] = {}
        with open_h5(fp, "r") as h5:
            node = h5[self.info["data_name"]]
            if self.group_mode:
                out["coords"] = node[self.info["coord_name"]][()]
                out["feats"] = node[self.info["feat_name"]][()]
                if self.info["label_name"] and self.info["label_name"] in node:
                    out["labels"] = node[self.info["label_name"]][()]
            else:
                data = node[()]
                out["coords"] = np.ascontiguousarray(data[self.info["coord_name"]])
                out["feats"] = np.ascontiguousarray(data[self.info["feat_name"]])
                if self.info["label_name"] and self.info["label_name"] in (data.dtype.names
                                                                           or ()):
                    out["labels"] = np.ascontiguousarray(data[self.info["label_name"]])
                for f in self.info["additional_fields"] or []:
                    out[f] = np.ascontiguousarray(data[f])
        if "labels" not in out and self.info["label_file_pattern"]:
            with open_h5(self._label_file_for(fp), "r") as h5:
                data = h5[self.info["label_name"]][()]
                out["labels"] = (np.ascontiguousarray(data[data.dtype.names[0]])
                                 if data.dtype.names else data)
        return out

    def _get_file_data(self, fp: str) -> Dict[str, np.ndarray]:
        if fp in self._cache:
            self._cache.move_to_end(fp)
            return self._cache[fp]
        data = self._decode_file(fp)
        self._cache[fp] = data
        while len(self._cache) > max(1, int(self.info["data_cache_size"])):
            self._cache.popitem(last=False)
        return data

    # -- items --------------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.info["data_info"])

    def get_path_info(self, file_path: str) -> Optional[Dict[str, Any]]:
        for di in self.info["data_info"]:
            if di["file_path"].strip() == file_path.strip():
                return di
        return None

    def get_file_list(self) -> List[str]:
        return [di["file_path"] for di in self.info["data_info"]]

    def _row_range(self, coords: np.ndarray, di: Dict[str, Any]) -> Tuple[int, int]:
        """The [first, last) rows of a file's allotted event range."""
        lo_ev, hi_ev = di["event_range"]
        if not self.info["event_based"]:
            return lo_ev, hi_ev + 1
        ev = coords if coords.ndim == 1 else coords[:, -1]
        first = int(np.searchsorted(ev, lo_ev, side="left")) if lo_ev > 0 else 0
        if hi_ev + 1 < di["n_events"]:
            last = int(np.searchsorted(ev, hi_ev, side="right"))
        else:
            last = coords.shape[0]
        return first, last

    def convert_label(self, y: np.ndarray) -> np.ndarray:
        """``y`` with ``label_map`` applied (each key's value replaced)."""
        lm = self.info["label_map"]
        if lm is None:
            return y
        out = y.copy()
        for key, val in lm.items():
            out[y == key] = val
        return out

    def __getitem__(self, index: int) -> FileBlock:
        di = self.info["data_info"][index]
        data = self._get_file_data(di["file_path"])
        coords = data["coords"]
        first, last = self._row_range(coords, di)

        feat_dtype = np.float16 if self.half_precision else np.float32
        feats = data["feats"][first:last].astype(feat_dtype, copy=False)
        if self.normalize:
            feats = feats * feat_dtype(MAX_RANGE_INV)
        c = coords[first:last].astype(np.int32, copy=False)
        extras = {f: data[f][first:last] for f in self.info["additional_fields"] or []
                  if f in data}

        if "labels" in data:
            if self.info["label_file_pattern"] or self.group_mode:
                # label files and combined (group-mode) files hold one label an event
                lo_ev, hi_ev = di["event_range"]
                y = data["labels"][lo_ev:hi_ev + 1]
            else:
                y = data["labels"][first:last]
            y = self.convert_label(np.asarray(y))
            if y.ndim == 2 and y.shape[1] == 1:
                # a scalar label field stored as a (1,)-subarray
                y = y[:, 0]
            if np.issubdtype(y.dtype, np.integer):
                y = y.astype(np.int64, copy=False)
            else:
                y = y.astype(np.float32, copy=False)
        else:
            # the directory's index is the event label
            n_ev = di["event_range"][1] + 1 - di["event_range"][0]
            y = np.full((n_ev,), di["dir_index"], dtype=np.int64)

        return FileBlock(coords=c, feats=feats, labels=y, extras=extras)
