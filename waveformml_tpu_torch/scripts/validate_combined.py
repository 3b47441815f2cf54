"""Check the offline shuffle's output (the port's counterpart of
scripts/ValidateCombined.py):

    python -m waveformml_tpu_torch.scripts.validate_combined DIR [--dataset NAME]
        [--coord coord] [--feat waveform] [--label FIELD]

For each ``Combined_*.h5`` in DIR it replays the round-robin merge from its
JSON sidecar's source ranges (one event per class a round) and checks the
file against it event for event: every coordinate column but the event id,
the waveforms, the event ids renumbered 0..n-1 with the replay's rows per
event, the per-event class labels of the group layout, and the per-row
label field of the compound layout (the field that is neither coord nor
feat, unless ``--label`` names it). Prints ``<file>: OK`` per file and
raises ``ValueError`` at the first mismatch. Opens files through
``io.hdf5.open_h5`` (needs h5py).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def _read_range(fdat, dataset_name, coord_name, feat_name, batch_index=-1,
                label_name=None):
    """The rows of one sidecar entry ``[path, [first, last]]``: coords,
    feats and the label field (or None) of its events first..last."""
    from waveformml_tpu_torch.io.hdf5 import is_group, open_h5

    with open_h5(fdat[0], "r") as h5:
        ds = h5[dataset_name]
        if not is_group(ds) and ds.dtype.names:
            rec = ds[()]
            coords, feats = rec[coord_name], rec[feat_name]
            labels = (rec[label_name]
                      if label_name and label_name in rec.dtype.names else None)
        else:
            coords, feats = ds[coord_name][()], ds[feat_name][()]
            labels = (ds[label_name][()]
                      if label_name and label_name in ds else None)
    # the event id is the last coord column (3D files carry [x, y, t, event])
    sel = (coords[:, batch_index] >= fdat[1][0]) & (coords[:, batch_index] <= fdat[1][1])
    return coords[sel], feats[sel], labels[sel] if labels is not None else None


def expected_merge(sidecar: dict, dataset_name: str, coord_name: str,
                   feat_name: str, label_name=None):
    """Replay ``write_shuffled``'s round-robin: per class its events in
    order, one event of each class a round. Returns (coords, feats,
    per_event_class, per_row_labels_or_None, per_event_row_counts)."""
    cat_events = {}
    for cat in sorted(int(k) for k in sidecar):
        events = []
        for fdat in sidecar[str(cat)]:
            coords, feats, labels = _read_range(
                fdat, dataset_name, coord_name, feat_name, label_name=label_name)
            if coords.size == 0:
                continue
            ev = coords[:, -1]
            boundaries = np.flatnonzero(np.diff(ev)) + 1
            for rows in np.split(np.arange(ev.shape[0]), boundaries):
                events.append((coords[rows], feats[rows],
                               labels[rows] if labels is not None else None))
        cat_events[cat] = events
    out_c, out_f, out_l, cats = [], [], [], []
    pending = {c: iter(e) for c, e in cat_events.items()}
    while pending:
        done = []
        for c in list(pending):
            try:
                cc, ff, ll = next(pending[c])
            except StopIteration:
                done.append(c)
                continue
            out_c.append(cc)
            out_f.append(ff)
            if ll is not None:
                out_l.append(ll)
            cats.append(c)
        for c in done:
            pending.pop(c)
    if not out_c:
        return (np.zeros((0, 3), np.int64), np.zeros((0, 1), np.float32), [], None, [])
    rows = np.concatenate(out_l) if len(out_l) == len(out_c) else None
    ev_sizes = [c.shape[0] for c in out_c]
    return np.concatenate(out_c), np.concatenate(out_f), cats, rows, ev_sizes


def check_file(sidecar: dict, merged_coords, merged_feats, labels, path: Path,
               dataset_name: str, coord_name: str, feat_name: str, label_name=None,
               row_labels=None) -> None:
    """Raise ``ValueError`` where a combined file's contents differ from the
    replay of its sidecar."""
    src_coords, src_feats, cats, src_rows, ev_sizes = expected_merge(
        sidecar, dataset_name, coord_name, feat_name, label_name=label_name)
    if src_coords.shape[0] != merged_coords.shape[0]:
        raise ValueError(f"File {path} has {merged_coords.shape[0]} rows, sources have "
                         f"{src_coords.shape[0]}")
    # every coordinate column but the (renumbered) event id replays exactly
    if not np.array_equal(src_coords[:, :-1], merged_coords[:, :-1]):
        raise ValueError(f"File {path} contained incorrect coords")
    if not np.allclose(src_feats, merged_feats):
        raise ValueError(f"File {path} contained incorrect waveforms")
    # the event ids are the replay's events numbered 0..n-1, each over its
    # own rows: a shifted boundary keeps coords and feats row-identical but
    # gives rows to the wrong events
    if src_coords.shape[0]:
        expected_ids = np.repeat(np.arange(len(cats)), ev_sizes)
        if not np.array_equal(merged_coords[:, -1], expected_ids):
            bad = int(np.flatnonzero(merged_coords[:, -1] != expected_ids)[0])
            raise ValueError(
                f"File {path} row {bad} has event id {int(merged_coords[bad, -1])}, "
                f"replay expects {int(expected_ids[bad])} — event boundaries are corrupted")
    # per-event class labels (group layout), where every label is a class
    # index (label files may remap them)
    if labels is not None and len(labels) == len(cats) and \
            set(np.unique(labels)).issubset(set(cats)):
        if not np.array_equal(np.asarray(labels), np.asarray(cats)):
            raise ValueError(f"File {path} labels do not interleave classes")
    # the per-row label field (compound layout) replays exactly
    if row_labels is not None and src_rows is not None:
        a = np.asarray(row_labels).reshape(len(row_labels), -1)
        b = np.asarray(src_rows).reshape(len(src_rows), -1)
        if a.shape != b.shape or not np.allclose(a, b, equal_nan=True):
            raise ValueError(f"File {path} contained incorrect labels")


def validate_dir(directory: str, dataset: str = "WaveformPairs", coord: str = "coord",
                 feat: str = "waveform", label=None) -> int:
    """Check every ``Combined_*.h5`` in ``directory`` against its sidecar;
    returns the number of files checked."""
    from waveformml_tpu_torch.io.hdf5 import is_group, open_h5

    n_checked = 0
    for f in sorted(Path(directory).glob("Combined_*.h5")):
        with open(str(f)[:-3] + ".json") as jf:
            sidecar = json.load(jf)
        with open_h5(str(f), "r") as h5:
            ds = h5[dataset]
            if not is_group(ds) and ds.dtype.names:
                rec = ds[()]
                coords, feats = rec[coord], rec[feat]
                labels = None  # per-event class labels: group layout only
                # the compound layout's label field is its third
                label_name = label or next(
                    (n for n in rec.dtype.names if n not in (coord, feat)), None)
                row_labels = rec[label_name] if label_name else None
            else:
                coords, feats = ds[coord][()], ds[feat][()]
                labels = ds["labels"][()]
                label_name, row_labels = None, None
        check_file(sidecar, coords, feats, labels, f, dataset, coord, feat,
                   label_name=label_name, row_labels=row_labels)
        n_checked += 1
        print(f"{f.name}: OK")
    return n_checked


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("dir", help="directory of Combined_*.h5 files")
    parser.add_argument("--dataset", default="WaveformPairs")
    parser.add_argument("--coord", default="coord")
    parser.add_argument("--feat", default="waveform")
    parser.add_argument("--label", default=None,
                        help="per-row label field of a compound layout (default: the "
                             "field that is neither coord nor feat)")
    args = parser.parse_args(argv)
    n_checked = validate_dir(args.dir, args.dataset, args.coord, args.feat, args.label)
    print(f"validated {n_checked} combined files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
