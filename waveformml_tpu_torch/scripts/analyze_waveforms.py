"""Per-class average waveforms and DSP feature means from directories of
simulation files: ``python -m waveformml_tpu_torch.scripts.analyze_waveforms
DIR [DIR ...] [--type 2d|3d|pmt|det] [-o OUTDIR] [--n_max N] [--device D]``
(the port's counterpart of scripts/AnalyzeWaveforms.py).

Each directory is a class. ``analyze_dir`` reads its files' waveform
records (h5py, through ``io.hdf5``) in file order, up to ``n_max``, and
hands them to ``analyze_records``, which sums them into the class's
average waveform with Poisson errors (mean = Σwf/n, err = sqrt(Σwf)/n) and
streams the per-waveform features (arrival, PSD, total, peak) of the first
PMT's half of each record through ``ops.waveform_features`` on the device:
kernel K3 on the card, its plain version on the CPU. Writes
``average_waveforms.npz``, ``waveform_features.json`` and, where matplotlib
is installed, ``average_waveforms.png`` under the output directory.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, Iterable, Optional

import numpy as np
import torch

#: --type → (file pattern, table, waveform field)
TYPE_INFO = {
    "2d": ("*WaveformPairSim.h5", "WaveformPairs", "waveform"),
    "3d": ("*Waveform3DPairSim.h5", "Waveform3DPairs", "waveform"),
    "pmt": ("*PMTCoordSim.h5", "DetPulseCoord", "pulse"),
    "det": ("*DetCoordSim.h5", "DetPulseCoord", "pulse"),
}


class WaveformAccumulator:
    """Σwf / n with Poisson error sqrt(Σwf) / n over the waveforms added
    (ref: AnalyzeWaveforms.py:26-45, which counted batches, not
    waveforms)."""

    def __init__(self, n_samples: int):
        self.n_samples = n_samples
        self.clear()

    def add(self, wfs: np.ndarray) -> None:
        self.wf += wfs.sum(axis=0)
        self.total += wfs.shape[0]

    def compute(self):
        if self.total == 0:
            return np.zeros(self.n_samples), np.zeros(self.n_samples)
        return self.wf / self.total, np.sqrt(np.clip(self.wf, 0, None)) / self.total

    def clear(self) -> None:
        self.wf = np.zeros((self.n_samples,), dtype=np.float64)
        self.total = 0


def analyze_records(wfs_chunks: Iterable[np.ndarray],
                    device: Optional[str] = None) -> Dict:
    """The average waveform and feature means of chunks of waveform records
    (``[n, S]``, or ``[n]`` for one sample a record): ``{"mean", "err",
    "n", "features"}``, ``features`` the means of arrival, psd, total and
    peak over the first half of records of an even width of at least 8
    samples (the whole record at an odd width), summed in float64 on
    ``device`` (None: the card) and empty where no record has 8 samples.
    Raises ``IOError`` where no record came."""
    from waveformml_tpu_torch.device import resolve_device
    from waveformml_tpu_torch.ops.waveform_features import waveform_features

    dev = resolve_device(device)
    acc = None
    # feature sums stream chunk by chunk: keeping every waveform for one
    # mean would cost ~1 GB at the default n_max
    feat_sums = torch.zeros(4, dtype=torch.float64, device=dev)
    feat_n = 0
    for wfs in wfs_chunks:
        wfs = np.asarray(wfs, dtype=np.float64)
        if wfs.ndim == 1:
            wfs = wfs[:, None]
        if acc is None:
            acc = WaveformAccumulator(wfs.shape[1])
        acc.add(wfs)
        if wfs.shape[1] >= 8 and wfs.shape[0]:
            half = wfs.shape[1] // 2 if wfs.shape[1] % 2 == 0 else wfs.shape[1]
            x = torch.from_numpy(np.ascontiguousarray(wfs[:, :half], dtype=np.float32)).to(dev)
            feat_sums += torch.stack([f.to(torch.float64).sum() for f in waveform_features(x)])
            feat_n += wfs.shape[0]
    if acc is None:
        raise IOError("no waveforms read (no file holds the table, or n_max <= 0)")
    mean, err = acc.compute()
    features = {}
    if feat_n:
        means = (feat_sums / feat_n).tolist()
        features = dict(zip(("arrival", "psd", "total", "peak"), means))
    return {"mean": mean, "err": err, "n": acc.total, "features": features}


def _read_dir(d: str, file_mask: str, table: str, field: str, n_max: int):
    """The waveform field of each matching file's table, in file order, up
    to n_max records in all."""
    from waveformml_tpu_torch.io.hdf5 import open_h5

    files = sorted(glob.glob(os.path.join(d, file_mask)))
    if not files:
        raise IOError(f"no files matching {file_mask} under {d}")
    seen = 0
    for fp in files:
        if seen >= n_max:
            return
        with open_h5(fp) as h5:
            if table not in h5:
                continue
            rec = h5[table][: max(0, n_max - seen)]
        seen += rec.shape[0]
        yield rec[field]


def analyze_dir(d: str, file_mask: str, table: str, field: str, n_max: int,
                device: Optional[str] = None) -> Dict:
    """``analyze_records`` over the waveforms of a directory's files."""
    return analyze_records(_read_dir(d, file_mask, table, field, n_max), device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("dirs", nargs="+", help="directories of data (one per class)")
    parser.add_argument("--type", "-t", default="2d", choices=sorted(TYPE_INFO))
    parser.add_argument("--outdir", "-o", default=None,
                        help="output dir (default ./analysis/<combined name>)")
    parser.add_argument("--n_max", type=int, default=1_000_000)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (the card, the default) or cpu")
    args = parser.parse_args(argv)

    from waveformml_tpu_torch.utils.util import unique_path_combine

    dirs = [os.path.normpath(os.path.abspath(os.path.expanduser(p))) for p in args.dirs]
    for d in dirs:
        if not os.path.isdir(d):
            raise IOError(f"Invalid directory {d}")
    outdir = args.outdir or os.path.join("./analysis", unique_path_combine(dirs))
    os.makedirs(outdir, exist_ok=True)
    file_mask, table, field = TYPE_INFO[args.type]

    results = {}
    for d in dirs:
        name = os.path.basename(d)
        r = results[name] = analyze_dir(d, file_mask, table, field, args.n_max, args.device)
        feats = r["features"]
        print(f"{name}: n={r['n']}"
              + (f"  arrival={feats['arrival']:.2f} psd={feats['psd']:.4f}"
                 f" total={feats['total']:.1f} peak={feats['peak']:.1f}" if feats else ""))

    np.savez(os.path.join(outdir, "average_waveforms.npz"),
             **{f"{k}_mean": v["mean"] for k, v in results.items()},
             **{f"{k}_err": v["err"] for k, v in results.items()})
    with open(os.path.join(outdir, "waveform_features.json"), "w") as f:
        json.dump({k: {"n": v["n"], **v["features"]} for k, v in results.items()}, f, indent=1)
    written = ["average_waveforms.npz", "waveform_features.json"]
    try:
        from waveformml_tpu_torch.utils.plot import _pyplot

        plt = _pyplot()
    except ImportError:
        print("matplotlib is not installed: average_waveforms.png not drawn")
    else:
        fig, ax = plt.subplots(figsize=(8, 5))
        for name, r in results.items():
            ax.plot(r["mean"], label=f"{name} (n={r['n']})")
            ax.fill_between(np.arange(len(r["mean"])), r["mean"] - r["err"],
                            r["mean"] + r["err"], alpha=0.25)
        ax.set_xlabel("sample")
        ax.set_ylabel("amplitude")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, "average_waveforms.png"), dpi=120)
        plt.close(fig)
        written.append("average_waveforms.png")
    print(f"wrote {outdir}/{', '.join(written)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
