"""Overlay the average waveforms of PMT channels in two HDF5 files, e.g. a
simulation against data (the port's counterpart of
scripts/Compare_PMT_WF.py):

    python -m waveformml_tpu_torch.scripts.compare_pmt_wf a.h5 b.h5 [-ch 0 1] [--n_max N] [-o out.png]

reads up to N records of each file's table (the record type its name gives,
``io.compound_types.extension_type_map``, else ``--table``; needs h5py) and
plots each channel's mean half-waveform (needs matplotlib).
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, Sequence

import numpy as np


def average_waveforms(path: str, table: str, n_max: int,
                      channels: Sequence[int]) -> Dict[int, np.ndarray]:
    """``{channel: mean waveform}`` over the first ``n_max`` records of a
    file, channel 2·seg + side reading the side's half of each record at
    the segment's (x, y); channels without a record are left out."""
    from waveformml_tpu_torch.detector import seg_to_xy
    from waveformml_tpu_torch.io.compound_types import extension_type_map
    from waveformml_tpu_torch.io.hdf5 import open_h5

    t = extension_type_map(path)
    with open_h5(path, "r") as h5:
        rec = h5[t.name][:n_max] if t.name in h5 else h5[table][:n_max]
    wf_field = "waveform" if "waveform" in rec.dtype.names else "pulse"
    wfs = rec[wf_field].astype(np.float64)
    coords = rec["coord"]
    n_samples = wfs.shape[1] // 2
    out = {}
    for ch in channels:
        seg, side = ch // 2, ch % 2
        x, y = seg_to_xy(seg)
        sel = (coords[:, 0] == x) & (coords[:, 1] == y)
        if not sel.any():
            continue
        out[ch] = wfs[sel, side * n_samples:(side + 1) * n_samples].mean(axis=0)
    return out


def main(argv=None) -> int:
    from waveformml_tpu_torch.utils.plot import plot_waveforms

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("file1")
    parser.add_argument("file2")
    parser.add_argument("--channels", "-ch", type=int, nargs="*", default=[0])
    parser.add_argument("--table", default="WaveformPairCal")
    parser.add_argument("--n_max", type=int, default=10000)
    parser.add_argument("--out", "-o", default="compare_pmt_wf.png")
    args = parser.parse_args(argv)
    avg1 = average_waveforms(args.file1, args.table, args.n_max, args.channels)
    avg2 = average_waveforms(args.file2, args.table, args.n_max, args.channels)
    wfs, labels = [], []
    for ch in args.channels:
        for path, avg in ((args.file1, avg1), (args.file2, avg2)):
            if ch in avg:
                wfs.append(avg[ch])
                labels.append(f"{path} ch{ch}")
    if not wfs:
        print("no matching channels found")
        return 1
    fig = plot_waveforms(wfs, labels)
    fig.savefig(args.out)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
