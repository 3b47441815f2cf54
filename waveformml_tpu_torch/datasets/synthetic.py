"""Synthetic detector events for tests and the chip smoke run (numpy;
counterpart of the generators in waveformml_tpu/datasets/synthetic.py):
unlabelled events, labelled chunks of both particle kinds (also as the
3D nets' (x, y, t) rows), chunks with per-row (E, z) labels, chunks of
single waveforms with their detector channels, and an in-memory
data module for the trainer, the inputs that stress the kernels, and
directories of HDF5 files of each particle kind (``write_classification_dirs``,
which needs h5py), the prediction writers' input records (``WaveformPairCal``,
``WaveformPairNorm``) with their file writers, and in-memory stand-ins for
the writers' HDF5 input and output (``in_memory_writer``).

Waveforms are exponential-tail scintillation pulses on the raw ADC scale
whose left/right amplitude ratio encodes z and whose tail fraction depends
on the particle kind (the PSD handle).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from waveformml_tpu_torch.datasets.data_module import DataLoaderLite
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.detector import E_SCALE, MAX_RANGE, NX, NY, Z_SCALE
from waveformml_tpu_torch.io.compound_types import WaveformPairCal, WaveformPairNorm
from waveformml_tpu_torch.io.hdf5 import H5Input, open_h5


def synth_waveform_pair(rng: np.random.Generator, n_samples: int, energy: float,
                        z: float, kind: int = 0) -> np.ndarray:
    """One PMT pair's waveform [2*n_samples] (left samples, then right),
    values in [0, MAX_RANGE]."""
    t = np.arange(n_samples, dtype=np.float32)
    t0 = 6.0 + rng.uniform(-1, 1)
    rise = np.clip((t - t0) / 1.5, 0, None)
    fast = np.exp(-np.clip(t - t0, 0, None) / 3.0)
    slow = np.exp(-np.clip(t - t0, 0, None) / 25.0)
    tail_frac = 0.12 + 0.25 * kind  # particle-dependent slow component
    shape = (1 - np.exp(-rise)) * ((1 - tail_frac) * fast + tail_frac * slow)
    zn = z / (Z_SCALE / 2)  # [-1, 1]
    amp_l = energy * np.exp(-zn * 0.8)
    amp_r = energy * np.exp(+zn * 0.8)
    scale = MAX_RANGE / 40.0
    wf_l = amp_l * scale * shape + rng.normal(0, 12, n_samples)
    wf_r = amp_r * scale * shape + rng.normal(0, 12, n_samples)
    return np.clip(np.concatenate([wf_l, wf_r]), 0, MAX_RANGE).astype(np.float32)


def make_events(rng: np.random.Generator, n_events: int, n_samples: int,
                kind: int = 0, max_mult: int = 4,
                start_event: int = 0) -> Dict[str, np.ndarray]:
    """Sparse events with 1..max_mult pulses each at distinct sites: coords
    [N, 3] (x, y, event), waveforms [N, 2·n_samples], per-pulse E and z."""
    coords, wfs, es, zs = [], [], [], []
    for e in range(n_events):
        mult = int(rng.integers(1, max_mult + 1))
        sites = rng.choice(NX * NY, size=mult, replace=False)
        for s in sites:
            x, y = int(s % NX), int(s // NX)
            energy = float(rng.uniform(0.5, 10.0))
            z = float(rng.uniform(-Z_SCALE / 2, Z_SCALE / 2))
            coords.append([x, y, start_event + e])
            wfs.append(synth_waveform_pair(rng, n_samples, energy, z, kind))
            es.append(energy)
            zs.append(z)
    return {
        "coords": np.asarray(coords, dtype=np.int32),
        "waveforms": np.stack(wfs),
        "E": np.asarray(es, dtype=np.float32),
        "z": np.asarray(zs, dtype=np.float32),
    }


def write_waveform_pair_sim(path: str, n_events: int, n_samples: int, kind: int = 0,
                            seed: int = 0) -> None:
    """One ``*WaveformPairSim.h5`` file of ``n_events`` events of one
    particle kind: table "WaveformPairs" of (coord [3] int32, waveform
    [2·n_samples] float32) rows and its ``nevents`` attribute, the layout
    ``PulseDataset2D`` reads."""
    rng = np.random.default_rng(seed)
    ev = make_events(rng, n_events, n_samples, kind)
    rec = np.zeros(ev["coords"].shape[0], dtype=np.dtype(
        [("coord", np.int32, (3,)), ("waveform", np.float32, (2 * n_samples,))]))
    rec["coord"] = ev["coords"]
    rec["waveform"] = ev["waveforms"]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open_h5(path, "w") as h5:
        h5.create_dataset("WaveformPairs", data=rec)
        h5["WaveformPairs"].attrs.create("nevents", np.array([float(n_events)]))


def write_classification_dirs(base: str, type_names: Sequence[str], n_files: int,
                              events_per_file: int, n_samples: int,
                              seed: int = 0) -> Dict[str, str]:
    """One directory per particle kind under ``base``, named by
    ``type_names``, each with ``n_files`` ``*WaveformPairSim.h5`` files of
    ``events_per_file`` events (the directory-as-label layout of
    ``PulseDataset2D``); the same files, for the same arguments, as the JAX
    package's writer. Returns ``{type name: directory}``."""
    out = {}
    for k, name in enumerate(type_names):
        d = os.path.join(base, name)
        os.makedirs(d, exist_ok=True)
        for i in range(n_files):
            write_waveform_pair_sim(os.path.join(d, f"{name}_{i:05d}_WaveformPairSim.h5"),
                                    events_per_file, n_samples, kind=k,
                                    seed=seed + 1000 * k + i)
        out[name] = d
    return out


def labelled_block(rng: np.random.Generator, n_events: int, n_samples: int,
                   max_mult: int = 4) -> FileBlock:
    """A chunk of events of both particle kinds, interleaved (the kind of
    each event drawn at random, its label): coords [N, 3] (x, y, event),
    waveforms scaled to [0, 1] as features, labels [n_events] int64. Chunks
    of one kind do not train."""
    kinds = rng.integers(0, 2, n_events)
    coords, wfs = [], []
    for e, kind in enumerate(kinds):
        ev = make_events(rng, 1, n_samples, kind=int(kind), max_mult=max_mult, start_event=e)
        coords.append(ev["coords"])
        wfs.append(ev["waveforms"])
    return FileBlock(coords=np.concatenate(coords),
                     feats=(np.concatenate(wfs) / MAX_RANGE).astype(np.float32),
                     labels=kinds.astype(np.int64))


def segment_block(rng: np.random.Generator, n_events: int, n_samples: int,
                  label: str = "z", max_mult: int = 4) -> FileBlock:
    """A chunk of events with per-row labels, for the per-segment tasks:
    coords [N, 3], waveforms scaled to [0, 1] as features, and labels
    ``[N]`` z (``label="z"``, scaled to [0, 1]) or ``[N, 2]`` (E, z)
    (``label="ez"``, E over ``E_SCALE``), the layout of the EZ label
    field; the left/right amplitude ratio encodes z, the amplitude E."""
    ev = make_events(rng, n_events, n_samples, max_mult=max_mult)
    z = (ev["z"] / Z_SCALE + 0.5).astype(np.float32)
    labels = z if label == "z" else np.stack([ev["E"] / E_SCALE, z], 1).astype(np.float32)
    return FileBlock(coords=ev["coords"],
                     feats=(ev["waveforms"] / MAX_RANGE).astype(np.float32), labels=labels)


def waveform_block(rng: np.random.Generator, n_waveforms: int, n_samples: int,
                   max_mult: int = 4) -> FileBlock:
    """A chunk of about ``n_waveforms`` single waveforms, the rows of
    ``PulseDatasetWaveformNorm``: each pulse's two PMTs' waveforms as two
    rows, coords ``[N]`` their detector channel ids (2·(x + NX·y) + side),
    features scaled to [0, 1], labels ``[N]`` the pulse's z scaled to
    [0, 1] (the left/right amplitude ratio encodes it)."""
    n_events = max(1, int(round(n_waveforms / (max_mult + 1))))
    ev = make_events(rng, n_events, n_samples, max_mult=max_mult)
    c = ev["coords"].astype(np.int64)
    seg = c[:, 0] + NX * c[:, 1]
    det = np.stack([2 * seg, 2 * seg + 1], 1).reshape(-1).astype(np.int32)
    wfs = ev["waveforms"].reshape(-1, 2, n_samples).reshape(-1, n_samples)
    z = np.repeat((ev["z"] / Z_SCALE + 0.5).astype(np.float32), 2)
    return FileBlock(coords=det, feats=(wfs / MAX_RANGE).astype(np.float32), labels=z)


def rows_3d(coords: np.ndarray, waveforms: np.ndarray, n_samples: int,
            threshold: float = 30.0):
    """Pulses (coords ``[P, 3]``, waveform pairs ``[P, 2·S]`` on the ADC
    scale) as the rows of a ``*Waveform3DPairSim.h5`` file: one row per
    pulse and time sample where either PMT clears ``threshold`` (the
    largest sample where none does), coords ``[N, 4]`` (x, y, t, event),
    the two PMTs' samples ``[N, 2]``, sorted by (event, x, y, t). The port's
    copy of the JAX package's ``write_waveform_3d_pair_sim`` rows."""
    wf = waveforms.reshape(-1, 2, n_samples)
    rows_c, rows_w = [], []
    for p in range(coords.shape[0]):
        keep = np.flatnonzero(wf[p].max(axis=0) > threshold)
        if keep.size == 0:
            keep = np.array([int(wf[p].max(axis=0).argmax())])
        x, y, e = coords[p]
        c = np.empty((keep.size, 4), np.int32)
        c[:, 0], c[:, 1], c[:, 2], c[:, 3] = x, y, keep, e
        rows_c.append(c)
        rows_w.append(wf[p, :, keep])
    out_c = np.concatenate(rows_c)
    out_w = np.concatenate(rows_w).astype(np.float32)
    order = np.lexsort((out_c[:, 2], out_c[:, 1], out_c[:, 0], out_c[:, 3]))
    return out_c[order], out_w[order]


def labelled_block_3d(rng: np.random.Generator, n_events: int, n_samples: int,
                      max_mult: int = 4) -> FileBlock:
    """``labelled_block``'s events as ``PulseDataset3D`` gives them: the
    (x, y, t) rows of ``rows_3d``, their samples scaled to [0, 1], labels
    ``[n_events]`` the particle kinds."""
    kinds = rng.integers(0, 2, n_events)
    coords, wfs = [], []
    for e, kind in enumerate(kinds):
        ev = make_events(rng, 1, n_samples, kind=int(kind), max_mult=max_mult, start_event=e)
        coords.append(ev["coords"])
        wfs.append(ev["waveforms"])
    c, w = rows_3d(np.concatenate(coords), np.concatenate(wfs), n_samples)
    return FileBlock(coords=c, feats=(w / MAX_RANGE).astype(np.float32),
                     labels=kinds.astype(np.int64))


class BlockDataModule:
    """In-memory ``FileBlock``s behind the data-module interface the
    trainers take (``setup``, ``train_dataloader``, ``val_dataloader``,
    ``test_dataloader``). Without a ``batch_size`` each loader is the list
    of blocks, in order; with one, a ``DataLoaderLite`` over them that
    collates ``batch_size`` blocks a batch, shuffles the training blocks
    with ``seed`` where ``shuffle`` (never the validation or test blocks)
    and loads on a background thread where ``num_workers > 0``."""

    def __init__(self, train, val=(), test=(), batch_size: Optional[int] = None,
                 shuffle: bool = False, num_workers: int = 0, seed: int = 0):
        self.train, self.val, self.test = list(train), list(val), list(test)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed

    def setup(self, stage: Optional[str] = None) -> None:
        """Nothing to load: the blocks are in memory."""

    def _loader(self, blocks, shuffle: bool):
        if self.batch_size is None:
            return list(blocks)
        return DataLoaderLite(blocks, batch_size=self.batch_size, shuffle=shuffle,
                              num_workers=self.num_workers, seed=self.seed)

    def train_dataloader(self):
        return self._loader(self.train, self.shuffle)

    def val_dataloader(self):
        return self._loader(self.val, False)

    def test_dataloader(self):
        return self._loader(self.test, False)


def wfpair_cal_records(n_events: int, seed: int = 0) -> np.ndarray:
    """``WaveformPairCal`` records of ``n_events`` events of 1 to 4 pulses
    each (2.5 on average) at distinct sites: 65-sample raw int16 ADC pairs,
    E, z, EZ, PE, PSD and PID from each pulse's particle kind (its tail
    fraction); the records of the JAX package's ``write_wfpair_cal`` for
    the same seed."""
    rng = np.random.default_rng(seed)
    t = WaveformPairCal()
    coords, wfs, es, zs, kinds = [], [], [], [], []
    pid_of_kind = np.array([1, 4, 6])
    for e in range(n_events):
        mult = int(rng.integers(1, 5))
        sites = rng.choice(NX * NY, size=mult, replace=False)
        for s in sites:
            x, y = int(s % NX), int(s // NX)
            kind = int(rng.integers(0, 3))
            energy = float(rng.uniform(0.5, 10.0))
            z = float(rng.uniform(-Z_SCALE / 2, Z_SCALE / 2))
            coords.append([x, y, e])
            wfs.append(synth_waveform_pair(rng, 65, energy, z, kind))
            es.append(energy)
            zs.append(z)
            kinds.append(kind)
    c = np.asarray(coords, np.int32)
    n = c.shape[0]
    rec = np.zeros(n, dtype=t.type)
    rec["coord"] = c
    rec["evt"] = c[:, 2]
    rec["waveform"] = np.clip(np.stack(wfs), 0, MAX_RANGE).astype(np.int16)
    rec["E"] = np.asarray(es, np.float32)
    rec["z"] = np.asarray(zs, np.float32)
    rec["EZ"][:, 0] = rec["E"]
    rec["EZ"][:, 1] = rec["z"]
    rec["PE"] = rng.uniform(10, 1000, (n, 2)).astype(np.float32)
    rec["PSD"] = (0.12 + 0.25 * np.asarray(kinds) / 2 + rng.normal(0, 0.01, n)).astype(np.float32)
    rec["PID"] = pid_of_kind[np.asarray(kinds)].astype(np.int32)
    return rec


def write_wfpair_cal(path: str, n_events: int, seed: int = 0, file_tag: str = "WFPairSim",
                     compression: int = 0) -> None:
    """``wfpair_cal_records`` as the table "WaveformPairCal" of an HDF5 file
    with its ``nevents`` attribute; gzip-chunked (chunks of 1024 rows) at
    level ``compression`` where it is above 0, as the analysis chain writes
    it, else uncompressed."""
    rec = wfpair_cal_records(n_events, seed)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open_h5(path, "w") as h5:
        if compression:
            h5.create_dataset("WaveformPairCal", data=rec, chunks=(min(1024, rec.shape[0]),),
                              compression="gzip", compression_opts=compression)
        else:
            h5.create_dataset("WaveformPairCal", data=rec)
        h5["WaveformPairCal"].attrs.create("nevents", np.array([float(n_events)]))


def _phys_vector(E, z, psd, rng, n):
    """The AD1 phys vector (E, dt, PE0, PE1, z, PSD, t0) of ``n`` rows."""
    phys = np.zeros((n, 7), np.float32)
    phys[:, 0] = E
    phys[:, 1] = rng.normal(0, 1.0, n)          # dt
    phys[:, 2] = E * 120 * np.exp(-z / 600)     # PE0
    phys[:, 3] = E * 120 * np.exp(+z / 600)     # PE1
    phys[:, 4] = z
    phys[:, 5] = psd
    phys[:, 6] = rng.uniform(0, 50, n)          # t0
    return phys


def wfnorm_records(n_events: int, seed: int = 0) -> np.ndarray:
    """``WaveformPairNorm`` records of ``n_events`` events (``make_events``
    at 65 samples, pulses scaled to [0, 1]) with their phys vectors, EZ and
    PID; the records of the JAX package's ``write_wfnorm`` for the same
    seed."""
    rng = np.random.default_rng(seed)
    ev = make_events(rng, n_events, 65, kind=0)
    n = ev["coords"].shape[0]
    rec = np.zeros(n, dtype=WaveformPairNorm().type)
    rec["t"] = np.arange(n, dtype=np.float64)
    rec["coord"] = ev["coords"]
    rec["pulse"] = (ev["waveforms"] / MAX_RANGE).astype(np.float32)
    psd = rng.uniform(0.1, 0.4, n).astype(np.float32)
    rec["phys"] = _phys_vector(ev["E"], ev["z"], psd, rng, n)
    rec["EZ"][:, 0] = ev["E"]
    rec["EZ"][:, 1] = ev["z"]
    rec["PID"] = rng.choice([1, 4, 6], n).astype(np.int32)
    return rec


def write_wfnorm(path: str, n_events: int, seed: int = 0) -> None:
    """``wfnorm_records`` as the table "WaveformPairNorm" of a
    ``*WFNorm.h5`` file with its ``nevents`` attribute."""
    rec = wfnorm_records(n_events, seed)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open_h5(path, "w") as h5:
        h5.create_dataset("WaveformPairNorm", data=rec)
        h5["WaveformPairNorm"].attrs.create("nevents", np.array([float(n_events)]))


class _MemoryFile(dict):
    """Tables by name, read as an open HDF5 file's nodes ("/name" or
    "name")."""

    def __getitem__(self, name):
        return super().__getitem__(name.lstrip("/"))

    def close(self) -> None:
        """Nothing to close."""


class MemoryInput(H5Input):
    """An ``H5Input`` over in-memory tables (``{name: records}``) in place
    of a file: the same event-preserving chunks."""

    def __init__(self, path: str, tables: Dict[str, np.ndarray]):
        self._tables = tables
        super().__init__(path)

    def _open(self, path, access, **kwargs):
        return _MemoryFile(self._tables)


class MemoryTables:
    """A mixin that keeps a prediction writer's output tables in memory
    (``tables``: name → records) in place of an HDF5 file; the table
    attributes are not kept."""

    def _open(self, path, access, **kwargs):
        return _MemoryFile()

    def create_table(self, name, shape, data_type, **kwargs) -> None:
        self.tables[name] = np.zeros(shape, dtype=data_type)
        self.table_index[name] = 0

    def add_rows(self, name: str, rows: np.ndarray) -> None:
        i = self.table_index[name]
        self.tables[name][i:i + rows.shape[0]] = rows
        self.table_index[name] = i + rows.shape[0]

    def flush(self, table=None) -> None:
        """Nothing to write."""

    def copy_p2x_attrs(self, *args, **kwargs) -> None:
        """No attributes are kept."""

    def copy_chanmap(self, h5input) -> None:
        self.tables["Chanmap"] = np.array(h5input.h5f["Chanmap"])


def in_memory_writer(writer_cls, tables: Dict[str, np.ndarray]):
    """A subclass of a prediction writer class that streams its input from
    ``tables`` (``{table name: records}``) and keeps its output in memory
    (``writer.tables[writer.data_type.name]`` after ``write_predictions``),
    for machines without h5py; everything between, the model and the
    pipeline, is the writer's own. The input path still names the input's
    record type by its suffix."""

    class InMemory(MemoryTables, writer_cls):
        def _open_input(self, input_path: str) -> MemoryInput:
            return MemoryInput(input_path, tables)

    InMemory.__name__ = InMemory.__qualname__ = writer_cls.__name__
    return InMemory


def conv_case(rng: np.random.Generator, kind: str, n_events: int, k: int,
              cin: int, cout: int, n_rows: Optional[int] = None):
    """Inputs of a row-space SubM conv over sites that stress it, all numpy:
    coords [n_rows, 3] int32 (x, y, event; the neighbour plan is built from
    them), feats [n_rows, cin] (zero on padding rows), kernel [k², cin,
    cout], bias [cout] and the row mask, padding rows at the end.

    ``kind``: ``"clustered"`` (1-5 sites near one spot per event, so many
    taps present and some absent), ``"dense_cluster"`` (a full 3×3 block of
    sites per event, so a centre row has all 9 taps), ``"duplicate_sites"``
    (clustered, about a quarter of the rows repeated: the neighbour plan
    keeps the last row of a site, so the centre tap of the first copy names
    another row) or ``"isolated_sites"`` (one site per event, so every
    off-centre tap is absent). ``n_rows`` defaults to the rows + 11."""
    if kind not in ("clustered", "dense_cluster", "duplicate_sites", "isolated_sites"):
        raise ValueError(f"unknown conv case {kind!r}")
    rows = []
    for e in range(n_events):
        if kind == "dense_cluster":
            x0, y0 = int(rng.integers(0, NX - 2)), int(rng.integers(0, NY - 2))
            rows += [[x0 + dx, y0 + dy, e] for dx in range(3) for dy in range(3)]
            continue
        x0, y0 = int(rng.integers(0, NX)), int(rng.integers(0, NY))
        n_sites = 1 if kind == "isolated_sites" else int(rng.integers(1, 6))
        for _ in range(n_sites):
            rows.append([int(np.clip(x0 + rng.integers(-2, 3), 0, NX - 1)),
                         int(np.clip(y0 + rng.integers(-2, 3), 0, NY - 1)), e])
    coords = np.unique(np.asarray(rows, np.int32), axis=0)
    coords = coords[np.argsort(coords[:, 2], kind="stable")]
    if kind == "duplicate_sites":
        coords = np.repeat(coords, 1 + (rng.random(coords.shape[0]) < 0.25), axis=0)
    n = coords.shape[0]
    n_rows = n_rows or n + 11
    if n_rows < n:
        raise ValueError(f"{n} rows do not fit n_rows={n_rows}")
    c = np.zeros((n_rows, 3), np.int32)
    c[:n] = coords
    mask = np.zeros(n_rows, bool)
    mask[:n] = True
    feats = rng.normal(size=(n_rows, cin)).astype(np.float32)
    feats[n:] = 0
    kernel = (rng.normal(size=(k * k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    return c, feats, kernel, bias, mask


SITE_LAYOUT_FEATURES = ("duplicate_sites", "stitched_groups", "events_past_end",
                        "ragged_max")


def site_layout_case(rng: np.random.Generator, features, n_events: int, c: int, f: int):
    """Inputs of the site-grouped head on a slot layout made by hand to
    stress it, all numpy: rows [N, c] (11 zero padding rows at the end), k3
    [c, S, f], take1 and ev1 [G, MAX] int32 (1-based, 0 = empty), site1 [G]
    int32 (1-based) and bias [f].

    Every such layout has its filled slots at random places in their groups
    (not a prefix), rows in no event order, empty slots that name an event
    and filled slots that name none (both add nothing). ``features`` adds
    any of ``"duplicate_sites"`` (a third of the events have two rows at one
    site, so one group adds two slots into one event row),
    ``"stitched_groups"`` (G = 2·S + 7, as a stitched multi-host layout
    has: every site twice, and 7 groups whose site lies outside [1, S] and
    is clamped), ``"events_past_end"`` (a tenth of the filled slots name an
    event past ``n_events``: dropped) and ``"ragged_max"`` (MAX = 600, not a
    power of two, with each group's filled slots in its last 2·(largest
    group) ≤ 300 slots, so that the first 300 slots of every group, a whole
    tile of the CUDA kernel, are empty)."""
    unknown = set(features) - set(SITE_LAYOUT_FEATURES)
    if unknown:
        raise ValueError(f"unknown site layout features {sorted(unknown)}")
    s = NX * NY
    sites, events = [], []
    for e in range(n_events):
        at = rng.choice(s, size=int(rng.integers(1, 5)), replace=False)
        if "duplicate_sites" in features and rng.random() < 1 / 3:
            at = np.append(at, at[0])
        sites.append(at)
        events.append(np.full(at.shape, e))
    order = rng.permutation(sum(a.size for a in sites))
    sites = np.concatenate(sites)[order]
    events = np.concatenate(events)[order]
    n = sites.size
    if "events_past_end" in features:
        events = np.where(rng.random(n) < 0.1, n_events + rng.integers(0, 50, n), events)
    site1 = np.arange(1, s + 1)
    if "stitched_groups" in features:
        site1 = np.concatenate([site1, rng.permutation(site1),
                                [0, -3, s + 1, s + 9, 0, s + 2, 2 * s]])
    # each row goes to one of the groups of its site
    by_site = [np.flatnonzero(np.clip(site1 - 1, 0, s - 1) == k) for k in range(s)]
    group = np.asarray([rng.choice(by_site[k]) for k in sites])
    counts = np.bincount(group, minlength=site1.size)
    span = 2 * int(counts.max())
    max_slots = 600 if "ragged_max" in features else span
    if span > max_slots // 2 and "ragged_max" in features:
        raise ValueError(f"{n_events} events overflow the last half of MAX={max_slots}")
    take = np.zeros((site1.size, max_slots), np.int32)
    ev = np.zeros((site1.size, max_slots), np.int32)
    for g in np.flatnonzero(counts):
        rows_g = np.flatnonzero(group == g)
        slots = max_slots - span + rng.choice(span, size=rows_g.size, replace=False)
        take[g, slots] = rows_g + 1
        ev[g, slots] = events[rows_g] + 1
    filled = take > 0
    stray = ~filled & (rng.random(take.shape) < 0.05)
    ev[stray] = rng.integers(1, n_events + 1, size=int(stray.sum()))
    ev[filled & (rng.random(take.shape) < 0.03)] = 0
    rows = np.zeros((n + 11, c), np.float32)
    rows[:n] = rng.normal(size=(n, c))
    k3 = (rng.normal(size=(c, s, f)) / np.sqrt(c * s)).astype(np.float32)
    bias = rng.normal(size=(f,)).astype(np.float32)
    return rows, k3, take, ev, site1.astype(np.int32), bias


def adversarial_waveforms(rng: np.random.Generator, n: int, s: int) -> np.ndarray:
    """Rows [n, s] float64 that stress the waveform features: zeros,
    constant, delta spike, plateau, signed noise, sharp onset, tie comb and
    early onset, in turn."""
    t = np.arange(s, dtype=np.float64)
    out = []
    for i in range(n):
        kind = i % 8
        w = np.zeros(s)
        if kind == 1:
            w[:] = rng.uniform(0, 10)
        elif kind == 2:
            w[int(rng.integers(0, s))] = 100
        elif kind == 3:
            a = int(rng.integers(0, s - 6))
            w[a:a + 5] = 50.0
        elif kind == 4:
            w = rng.normal(0, 1, s)
        elif kind == 5:
            t0 = rng.uniform(1, s - 2)
            w = 100 * np.exp(-np.clip(t - t0, 0, None) / 5) * (t >= t0)
        elif kind == 6:
            w = np.resize([0.0, 30.0], s)
        elif kind == 7:
            dt = np.clip(t - 8, 0, None)
            w = rng.uniform(10, 300) * (1 - np.exp(-dt / 1.5)) * np.exp(-dt / 12)
        out.append(w)
    return np.stack(out)
