"""Disk-cached graph dataset (counterpart of
waveformml_tpu/datasets/graph_dataset.py): each block of a wrapped dataset
saved as an ``.npz`` (coords, feats, labels, extras) under ``processed/``
beside its source file, with the padded edge lists of ``edge_specs``
precomputed by the C++ library of ``ops.graph``, so that later epochs
neither read the source nor build edges.

A cache file is reused where its signature (the source's mtime, the event
range, the edge specs, ``use_self_loops``) equals the wanted one, as a
string byte for byte the JAX package's, so that each package reads the
cache the other wrote without a rebuild.
"""
from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.ops.graph import knn_graph, pad_edges, window_edges
from waveformml_tpu_torch.ops.sparse import bucket_size
from waveformml_tpu_torch.registry import registry


def _spec(req: Sequence) -> Tuple:
    """An edge spec with Python scalars (a numpy int's ``repr`` would
    change the signature)."""
    kind, size, flag = req
    return (str(kind), int(size), bool(flag))


@registry.register("GraphDataset", aliases=("GraphDataset.GraphDataset",))
class GraphDataset:
    """Wraps a block dataset and caches its processed blocks under
    ``<dir of the first file>/processed``. ``edge_specs``: edge lists to
    precompute, as models give them (``edge_requirements()``): ("knn", k,
    loop) or ("window", dist, self_loops)."""

    def __init__(self, dataset, file_list: Optional[List[str]] = None,
                 use_self_loops: bool = False, edge_specs: Optional[Sequence[Tuple]] = None):
        self.raw_dataset = dataset
        ds_files = list(dataset.get_file_list())
        files = file_list if file_list is not None else ds_files
        self.source_files = list(files)
        # each source file is its own block of the wrapped dataset, whatever
        # its position in file_list
        self._block_index = []
        for f in self.source_files:
            if f not in ds_files:
                raise ValueError(f"{f} is not a file of the wrapped dataset")
            self._block_index.append(ds_files.index(f))
        root = os.path.dirname(files[0]) if files else "."
        self.processed_dir = os.path.join(root, "processed")
        self.expected_file_names = [
            os.path.join(self.processed_dir, os.path.basename(f)[:-3] + f"_{i}.npz")
            for i, f in enumerate(files)]
        self.use_self_loops = use_self_loops
        self.edge_specs = [_spec(s) for s in edge_specs] if edge_specs else []
        self.log = logging.getLogger(__name__)
        self.process()

    @property
    def processed_file_names(self) -> List[str]:
        return self.expected_file_names

    def _signature(self, idx: int) -> str:
        """The cache key of block ``idx``: its source's mtime, its event
        range and the edge configuration."""
        src = self.source_files[idx]
        try:
            mtime = round(float(os.path.getmtime(src)), 6)
        except OSError:
            mtime = -1.0
        rng = None
        get_info = getattr(self.raw_dataset, "get_path_info", None)
        if callable(get_info):
            di = get_info(src)
            if di:
                rng = list(di.get("event_range") or [])
        return repr((mtime, rng, [tuple(s) for s in self.edge_specs],
                     bool(self.use_self_loops)))

    @staticmethod
    def _cached_signature(path: str) -> Optional[str]:
        try:
            with np.load(path, allow_pickle=False) as z:
                return str(z["_sig"])
        except Exception:
            # unreadable, truncated (zipfile.BadZipFile) or without a
            # signature: rebuild
            return None

    def process(self) -> None:
        os.makedirs(self.processed_dir, exist_ok=True)
        for idx, out_path in enumerate(self.expected_file_names):
            sig = self._signature(idx)
            if os.path.exists(out_path) and self._cached_signature(out_path) == sig:
                continue
            self.log.info("creating graph data from block %d", idx)
            block = self.raw_dataset[self._block_index[idx]]
            payload = {"coords": block.coords, "feats": block.feats,
                       "labels": block.labels, "_sig": np.array(sig)}
            for k, v in (block.extras or {}).items():
                payload[f"extra_{k}"] = v
            for e_name, e_arr, m_name, m_arr in self._build_edges(block):
                payload[e_name], payload[m_name] = e_arr, m_arr
            # written to a temporary name and renamed: an interrupted write
            # leaves no truncated file at the final path
            tmp = out_path + ".tmp.npz"
            np.savez(tmp, **payload)
            os.replace(tmp, out_path)
            self.log.info("created file %s", out_path)

    def _build_edges(self, block: FileBlock):
        coords = block.coords
        pos = coords[:, :2].astype(np.float64)
        batch_col = coords[:, -1].astype(np.int64)
        n = coords.shape[0]
        out = []
        for kind, size, flag in self.edge_specs:
            if kind == "knn":
                key = f"knn{size}"
                edges = (knn_graph(pos, size, batch_col, loop=flag) if n
                         else np.zeros((2, 0), np.int64))
            else:
                # named and built as TaskBase.add_graph_edges does
                key = f"w{size}"
                edges = (window_edges(coords[:, :2], batch_col, max_dist=size, self_loops=flag)
                         if n else np.zeros((2, 0), np.int64))
            e, m = pad_edges(edges, bucket_size(max(1, edges.shape[1])))
            out.append((f"edges_{key}", e, f"edge_mask_{key}", m))
        return out

    def __len__(self) -> int:
        return len(self.expected_file_names)

    def len(self) -> int:
        return len(self)

    def get(self, idx: int) -> FileBlock:
        return self[idx]

    def __getitem__(self, idx: int) -> FileBlock:
        with np.load(self.expected_file_names[idx], allow_pickle=False) as z:
            extras = {}
            for k in z.files:
                if k.startswith("extra_"):
                    extras[k[len("extra_"):]] = z[k]
                elif k.startswith(("edges_", "edge_mask_")):
                    extras[k] = z[k]
            return FileBlock(coords=z["coords"], feats=z["feats"], labels=z["labels"],
                             extras=extras)

    def get_file_list(self) -> List[str]:
        return self.raw_dataset.get_file_list()
