"""Overlay one kind of calibration curve of two calibration groups, channel
by channel (the port's counterpart of scripts/CompareCalibrationCurves.py):

    python -m waveformml_tpu_torch.scripts.compare_calibration_curves \\
        cal1.db calA cal2.db calB [-ch 0 1] [--curve atten|time|lsum] [-o DIR]

writes ``DIR/compare_<curve>_ch<ch>.png`` (needs matplotlib) for each
channel that both groups have a curve for.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    from waveformml_tpu_torch.evaluation.calibrator import Calibrator
    from waveformml_tpu_torch.io.sql import CalibrationDB
    from waveformml_tpu_torch.utils.plot import plot_lines

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("cal1", help="calibration db path 1")
    parser.add_argument("calname1", help="calibration group 1")
    parser.add_argument("cal2", help="calibration db path 2")
    parser.add_argument("calname2", help="calibration group 2")
    parser.add_argument("--channels", "-ch", type=int, nargs="*", default=[0, 1],
                        help="PMT channels to plot")
    parser.add_argument("--curve", default="atten", choices=["atten", "time", "lsum"])
    parser.add_argument("--out_dir", "-o", default=".")
    args = parser.parse_args(argv)
    curves = []
    for path, name in ((args.cal1, args.calname1), (args.cal2, args.calname2)):
        c = Calibrator(CalibrationDB(path, name))
        curves.append({"atten": c.atten_curves, "time": c.time_curves,
                       "lsum": c.lsum_curves}[args.curve])
    os.makedirs(args.out_dir, exist_ok=True)
    for ch in args.channels:
        a, b = curves[0].get(ch), curves[1].get(ch)
        if not a or not b:
            print(f"channel {ch}: missing curve, skipping")
            continue
        a.sort()
        b.sort()
        xs = np.linspace(max(a.xs[0], b.xs[0]), min(a.xs[-1], b.xs[-1]), 100)
        fig = plot_lines(xs, [np.asarray(a.eval(xs)), np.asarray(b.eval(xs))],
                         [args.calname1, args.calname2], xlabel="z [mm]", ylabel=args.curve,
                         title=f"{args.curve} channel {ch}")
        out = os.path.join(args.out_dir, f"compare_{args.curve}_ch{ch}.png")
        fig.savefig(out)
        print("wrote", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
