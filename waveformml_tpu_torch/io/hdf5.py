"""HDF5 access for the port's datasets and prediction writers (the port's
copy of waveformml_tpu/io/hdf5.py). h5py is imported inside ``open_h5``,
``is_group`` and ``_fixed_str_type`` only, so ``import
waveformml_tpu_torch`` works on machines without it; only reading or
writing HDF5 files needs it.

``H5Input`` reads a table in chunks that never split an event, ``H5Output``
appends rows to gzip-chunked tables and ``P2XTableWriter`` keeps the
experiment's PyTables attribute conventions (``CLASS``, ``FIELD_n_NAME``,
``TITLE``, ``VERSION``, ``abstime``, ``runtime``, ``calgrp``, ``nevents``).
Tables that are 1-D, chunked and deflate-only (the analysis chain's
layout) are decoded and encoded chunk by chunk on a thread pool through
direct chunk IO and zlib, which releases the GIL, so the deflate work runs
beside the rest of a streaming pipeline.
"""
from __future__ import annotations

import os
import zlib
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

_POOL: Optional[ThreadPoolExecutor] = None


def open_h5(path: str, mode: str = "r", **kwargs):
    """``h5py.File(path, mode)``; an ``OSError`` is raised again with the
    path and mode."""
    import h5py

    try:
        return h5py.File(path, mode, **kwargs)
    except OSError as e:
        raise OSError(f"failed to open HDF5 file '{path}' (mode={mode}): {e}") from e


def is_group(node: Any) -> bool:
    """Whether an HDF5 node is a group (of datasets) and not a dataset."""
    import h5py

    return isinstance(node, h5py.Group)


def available() -> bool:
    """Whether h5py is installed, found without importing it."""
    import importlib.util

    return importlib.util.find_spec("h5py") is not None


def _fixed_str_type(length: int):
    """An HDF5 fixed-length string type of ``length`` bytes (PyTables'
    string attributes)."""
    import h5py

    tid = h5py.h5t.C_S1.copy()
    tid.set_size(length)
    return h5py.Datatype(tid)


def _gzip_pool() -> ThreadPoolExecutor:
    """The shared deflate pool (``WFML_GZIP_WORKERS`` threads, default
    min(8, cores))."""
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(
            max_workers=int(os.environ.get("WFML_GZIP_WORKERS", min(8, os.cpu_count() or 4))),
            thread_name_prefix="wfml-gzip")
    return _POOL


def _gzip_only_dataset(ds) -> bool:
    """Whether a dataset is 1-D, chunked and deflate is its only filter, so
    that its raw chunks are plain zlib streams."""
    return (getattr(ds, "chunks", None) is not None and len(ds.shape) == 1
            and ds.compression == "gzip" and not ds.shuffle
            and not ds.fletcher32 and ds.scaleoffset is None)


class ParallelChunkReader:
    """Rows ``[lo, hi)`` of a gzip-chunked dataset, as a slice would give
    them, with each chunk inflated on the shared pool and the next
    ``readahead`` chunks decoded ahead of a sequential reader."""

    def __init__(self, ds, readahead: int = 8):
        self.ds = ds
        self.chunk = int(ds.chunks[0])
        self.n = int(ds.shape[0])
        self.n_chunks = -(-self.n // self.chunk)
        self.readahead = readahead
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._futures: Dict[int, Any] = {}

    def _decode(self, ci: int) -> np.ndarray:
        lo = ci * self.chunk
        try:
            fmask, raw = self.ds.id.read_direct_chunk((lo,))
        except Exception:
            return np.asarray(self.ds[lo:min(lo + self.chunk, self.n)])
        if fmask != 0:  # this chunk was stored without deflate
            return np.asarray(self.ds[lo:min(lo + self.chunk, self.n)])
        arr = np.frombuffer(zlib.decompress(raw), dtype=self.ds.dtype)
        return arr[:min(self.chunk, self.n - lo)]

    def _ensure(self, ci: int) -> None:
        if ci < self.n_chunks and ci not in self._cache and ci not in self._futures:
            self._futures[ci] = _gzip_pool().submit(self._decode, ci)

    def _get(self, ci: int) -> np.ndarray:
        if ci not in self._cache:
            self._ensure(ci)
            self._cache[ci] = self._futures.pop(ci).result()
            while len(self._cache) > 2 * self.readahead + 4:
                self._cache.popitem(last=False)
        return self._cache[ci]

    def read(self, lo: int, hi: int) -> np.ndarray:
        hi = min(hi, self.n)
        if hi <= lo:
            return np.empty((0,), dtype=self.ds.dtype)
        c0, c1 = lo // self.chunk, max(lo, hi - 1) // self.chunk
        for ci in range(c0, min(c1 + 1 + self.readahead, self.n_chunks)):
            self._ensure(ci)
        parts = []
        for ci in range(c0, c1 + 1):
            arr = self._get(ci)
            a = max(0, lo - ci * self.chunk)
            b = min(len(arr), hi - ci * self.chunk)
            parts.append(arr[a:b])
        out = parts[0].copy() if len(parts) == 1 else np.concatenate(parts)
        # once the last chunk is served nothing more is read: drop the
        # cache and the readahead
        if c1 + 1 >= self.n_chunks:
            self._futures.clear()
            self._cache.clear()
        else:
            for ci in [k for k in self._futures if k < c0]:
                self._futures.pop(ci, None)
        return out


class ParallelGzipAppender:
    """Sequential appends to a gzip-chunked dataset: each full chunk is
    deflated on the shared pool and committed with ``write_direct_chunk``;
    the trailing partial chunk goes through h5py's filters at
    ``checkpoint``/``finalize``."""

    def __init__(self, ds, level: int, max_inflight: int = 16):
        self.ds = ds
        self.chunk = int(ds.chunks[0])
        self.level = int(level)
        self.row0 = 0                       # the table row of buf's first row
        self.buf: List[np.ndarray] = []
        self.buffered = 0
        self.pending: deque = deque()       # (chunk offset, future)
        self.max_inflight = max_inflight

    def append(self, rows: np.ndarray) -> None:
        self.buf.append(rows)
        self.buffered += rows.shape[0]
        while self.buffered >= self.chunk:
            block = np.concatenate(self.buf) if len(self.buf) > 1 else self.buf[0]
            full, rest = block[:self.chunk], block[self.chunk:]
            self.pending.append((self.row0, _gzip_pool().submit(
                zlib.compress, full.tobytes(), self.level)))
            self.row0 += self.chunk
            self.buf = [rest] if rest.shape[0] else []
            self.buffered = rest.shape[0]
            while len(self.pending) > self.max_inflight:
                self._commit_one()

    def _commit_one(self) -> None:
        off, fut = self.pending.popleft()
        self.ds.id.write_direct_chunk((off,), fut.result(), filter_mask=0)

    def drain(self) -> None:
        while self.pending:
            self._commit_one()

    def checkpoint(self) -> None:
        """Write everything added so far: the committed chunks, and the
        partial chunk through h5py's filters (a later direct write of the
        completed chunk overwrites it)."""
        self.drain()
        if self.buffered:
            tail = np.concatenate(self.buf) if len(self.buf) > 1 else self.buf[0]
            self.ds[self.row0:self.row0 + tail.shape[0]] = tail

    def finalize(self) -> None:
        self.checkpoint()
        self.row0 += self.buffered
        self.buf, self.buffered = [], 0


class H5Base:
    """An open HDF5 file (``h5f``). ``_open`` opens it; an in-memory
    stand-in overrides it."""

    def __init__(self, path: str, access: str = "r", **kwargs):
        self.path = path
        self.h5f = self._open(path, access, **kwargs)

    def _open(self, path: str, access: str, **kwargs):
        return open_h5(path, access, **kwargs)

    def close(self) -> None:
        self.h5f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class H5Input(H5Base):
    """A sequential chunked reader over one table that never splits an
    event across chunks."""

    def __init__(self, path: str, **kwargs):
        super().__init__(path, **kwargs)
        self.record_type: Optional[np.dtype] = None
        self.table_name = ""
        self.table = None
        self.event_index_name = ""
        self.event_index_coord: Optional[int] = None
        self.current_index = -1  # -1: fresh, -2: exhausted (the next call restarts)
        self.table_length = 0
        self._par: Optional[ParallelChunkReader] = None

    def setup_table(self, name: str, data_type: np.dtype, event_index_name: str,
                    event_index_coord: Optional[int] = None, base: str = "/") -> None:
        self.record_type = data_type
        self.table_name = name
        self.table = self.h5f[base + name]
        self.table_length = self.table.shape[0]
        self.event_index_name = event_index_name
        self.event_index_coord = event_index_coord
        self.current_index = -1
        self._par = ParallelChunkReader(self.table) if _gzip_only_dataset(self.table) else None

    def _read(self, lo: int, hi: int) -> np.ndarray:
        if self._par is not None:
            return self._par.read(lo, hi)
        return self.table[lo:hi]

    def _event_numbers(self, rows: np.ndarray) -> np.ndarray:
        col = rows[self.event_index_name]
        if self.event_index_coord is not None and col.ndim > 1:
            col = col[:, self.event_index_coord]
        return col

    def get_event_number(self, row: np.ndarray):
        if self.event_index_coord is None:
            return row[self.event_index_name]
        return row[self.event_index_name][self.event_index_coord]

    def next_chunk(self, nrows: int = 2048, preserve_event="extend") -> Optional[np.ndarray]:
        """The next chunk of about ``nrows`` rows; None once after the last
        one, after which reading starts again at the first row.

        ``preserve_event``: True or "extend" grows the chunk until its last
        event is complete (chunks of nrows and a few rows); "truncate" cuts
        it back to its last complete event (nrows less a few rows, so that
        a chunk pads to exactly nrows), or extends where one event fills
        the whole read; False gives plain nrows slices."""
        if self.table is None:
            raise RuntimeError("No table opened!")
        if self.current_index == -2:
            self.current_index = -1
            return None
        if self.current_index == -1:
            self.current_index = 0
        if self.current_index + nrows >= self.table_length:
            ci = self.current_index
            self.current_index = -2
            return self._read(ci, self.table_length)
        data = self._read(self.current_index, self.current_index + nrows)
        self.current_index += nrows
        if preserve_event == "truncate":
            evts = self._event_numbers(data)
            first_of_last = int(np.argmax(evts == evts[-1]))
            if first_of_last > 0:
                self.current_index -= data.shape[0] - first_of_last
                return data[:first_of_last]
            preserve_event = True
        if preserve_event:
            last_event = self.get_event_number(data[-1])
            # read ahead in blocks and cut at the first row of another event
            ext_block = max(64, nrows // 8)
            while self.current_index < self.table_length:
                ahead = self._read(self.current_index,
                                   min(self.current_index + ext_block, self.table_length))
                differs = np.nonzero(self._event_numbers(ahead) != last_event)[0]
                if differs.size:
                    take = int(differs[0])
                    if take:
                        data = np.concatenate([data, ahead[:take]])
                        self.current_index += take
                    break
                data = np.concatenate([data, ahead])
                self.current_index += len(ahead)
            if self.current_index >= self.table_length:
                self.current_index = -2
        return data

    def iter_chunks(self, nrows: int = 2048, preserve_event="extend"):
        """Every chunk of one pass over the table."""
        while True:
            chunk = self.next_chunk(nrows, preserve_event)
            if chunk is None:
                return
            yield chunk


class H5Output(H5Base):
    """Tables written row block by row block, gzip-chunked."""

    def __init__(self, path: str):
        super().__init__(path, "w")
        self.tables: Dict[str, Any] = {}
        self.table_index: Dict[str, int] = {}
        self._appenders: Dict[str, ParallelGzipAppender] = {}

    def create_table(self, name: str, shape, data_type, compression: str = "gzip",
                     maxshape=(None,), compression_opts: int = 9, chunks=(1024,),
                     **kwargs) -> None:
        self.tables[name] = self.h5f.create_dataset(
            name, shape=shape, dtype=data_type, compression=compression, maxshape=maxshape,
            compression_opts=compression_opts, chunks=chunks, **kwargs)
        self.table_index[name] = 0
        if _gzip_only_dataset(self.tables[name]):
            self._appenders[name] = ParallelGzipAppender(self.tables[name],
                                                         level=int(compression_opts))

    def add_rows(self, name: str, rows: np.ndarray) -> None:
        i = self.table_index[name]
        tbl = self.tables[name]
        app = self._appenders.get(name)
        if i + rows.shape[0] > tbl.shape[0]:
            if app is not None:
                app.drain()  # committed chunks stay valid through a resize
            tbl.resize((i + rows.shape[0],))
        # a direct chunk holds rows.tobytes() as they are: only for rows of
        # the table's own dtype, written in order; others go through h5py,
        # which converts field by field
        if app is not None and app.row0 + app.buffered == i and rows.dtype == tbl.dtype:
            app.append(np.ascontiguousarray(rows))
        else:
            if app is not None:
                self._finalize_table(name)
            tbl[i:i + rows.shape[0]] = rows
        self.table_index[name] = i + rows.shape[0]

    def _finalize_table(self, name: str) -> None:
        app = self._appenders.pop(name, None)
        if app is not None:
            app.finalize()

    def close_table(self, name: str) -> None:
        self._finalize_table(name)
        self.table_index.pop(name)
        self.tables.pop(name)

    def flush(self, table: Optional[str] = None) -> None:
        """Write what the appenders hold (of one table, or of all), partial
        chunks included, and flush the file."""
        if table is not None:
            apps = [self._appenders[table]] if table in self._appenders else []
        else:
            apps = list(self._appenders.values())
        for app in apps:
            app.checkpoint()
        self.h5f.flush()

    def close(self) -> None:
        for name in list(self._appenders):
            self._finalize_table(name)
        super().close()

    def copy_attrs(self, table: str, h5input: H5Base, input_table: str,
                   names: Sequence[str], types: Sequence[Any], shapes: Sequence[Any]) -> None:
        src_attrs = h5input.h5f[input_table].attrs
        for n, t, s in zip(names, types, shapes):
            if n not in src_attrs.keys():
                continue
            kwargs = {}
            if t is not None:
                kwargs["dtype"] = t
            if s is not None:
                kwargs["shape"] = s
            self.tables[table].attrs.create(n, src_attrs[n], **kwargs)

    def copy_table(self, name: str, h5input: H5Base) -> None:
        src = h5input.h5f[name]
        self.create_table(name, src.shape, src.dtype)
        if src.shape[0] > 0:
            self.tables[name][...] = src[()]
            self.table_index[name] = src.shape[0]


class P2XTableWriter(H5Output):
    """An ``H5Output`` whose tables carry the experiment's PyTables
    attributes."""

    def copy_chanmap(self, h5input: H5Base) -> None:
        self.copy_table("Chanmap", h5input)
        self.copy_p2x_attrs(h5input, "Chanmap", "Chanmap")

    def _attr_str_type(self, h5input: H5Base, table: str, name: str):
        attrs = h5input.h5f[table].attrs
        if name in attrs.keys():
            return _fixed_str_type(len(attrs[name]) + 1)
        return None

    def write_field_names(self, table: str, dtype_names: Sequence[str]) -> None:
        """``FIELD_n_NAME`` attributes for a new table's fields."""
        for n, name in enumerate(dtype_names):
            self.tables[table].attrs.create(f"FIELD_{n}_NAME", name,
                                            dtype=_fixed_str_type(len(name) + 1))

    def copy_p2x_attrs(self, h5input: H5Base, table: str, input_table: str,
                       dtype_names: Optional[Sequence[str]] = None) -> None:
        """The input table's PyTables attributes onto ``table``: ``CLASS``,
        the field names (new ones from ``dtype_names``, else the input's),
        ``TITLE``, ``VERSION``, ``abstime``, ``runtime``, ``calgrp``,
        ``rname``, ``nevents`` and ``scalingfactor``, where the input has
        them."""
        names: List[str] = ["CLASS"]
        shapes: List[Any] = [None]
        types: List[Any] = [_fixed_str_type(6)]
        src_attrs = h5input.h5f[input_table].attrs
        if dtype_names is not None:
            self.write_field_names(table, dtype_names)
        else:
            n = 0
            while f"FIELD_{n}_NAME" in src_attrs.keys():
                key = f"FIELD_{n}_NAME"
                names.append(key)
                shapes.append(None)
                types.append(_fixed_str_type(len(src_attrs[key]) + 1))
                n += 1
        for key in ("TITLE", "VERSION"):
            if key in src_attrs.keys():
                names.append(key)
                shapes.append(None)
                types.append(_fixed_str_type(len(src_attrs[key]) + 1))
        for key in ("abstime", "runtime"):
            names.append(key)
            shapes.append((1,))
            types.append(np.float64)
        for key in ("calgrp", "rname"):
            t = self._attr_str_type(h5input, input_table, key)
            if t is not None:
                names.append(key)
                types.append(t)
                shapes.append(None)
        for key in ("nevents", "scalingfactor"):
            names.append(key)
            shapes.append((1,))
            types.append(np.float64)
        self.copy_attrs(table, h5input, input_table, names, types, shapes)
