"""Compare a simulated calibration's curves with a reference calibration's,
channel by channel (the port's counterpart of scripts/CompareSimCalCurve.py):

    python -m waveformml_tpu_torch.scripts.compare_sim_cal_curve sim.db simcal ref.db refcal [--seg S]

prints the normalised difference (``curve_normed_diff``) of each channel's
attenuation and time curves.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def curve_normed_diff(c1, c2, n_points: int = 50) -> float:
    """Mean |c1 − c2| / max|c1| over ``n_points`` points of the two curves'
    common domain; inf where they share none."""
    c1.sort()
    c2.sort()
    lo = max(c1.xs[0], c2.xs[0])
    hi = min(c1.xs[-1], c2.xs[-1])
    if hi <= lo:
        return float("inf")
    xs = np.linspace(lo, hi, n_points)
    y1 = np.asarray(c1.eval(xs))
    y2 = np.asarray(c2.eval(xs))
    scale = np.abs(y1).max() or 1.0
    return float(np.abs(y1 - y2).mean() / scale)


def load_curves(db: str, calname: str):
    """The curves of group ``calname`` in ``db`` (``CalibrationDB.get_curves``);
    an unknown group raises IOError."""
    from waveformml_tpu_torch.io.sql import CalibrationDB

    try:
        return CalibrationDB(db, calname).get_curves()
    except KeyError as e:
        raise IOError(f"calgroup {calname!r} not found in {db}") from e


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("sim_db", help="simulated calibration db")
    parser.add_argument("sim_calname")
    parser.add_argument("ref_db", help="reference calibration db")
    parser.add_argument("ref_calname")
    parser.add_argument("--seg", type=int, default=None, help="restrict to one segment")
    args = parser.parse_args(argv)
    sim = load_curves(args.sim_db, args.sim_calname)
    ref = load_curves(args.ref_db, args.ref_calname)
    sim_atten, sim_time = sim[0], sim[2]
    ref_atten, ref_time = ref[0], ref[2]
    chans = sorted(set(sim_atten) & set(ref_atten))
    if args.seg is not None:
        chans = [c for c in chans if c // 2 == args.seg]
    for ch in chans:
        if not sim_atten.get(ch) or not ref_atten.get(ch):
            continue
        att_nd = curve_normed_diff(sim_atten[ch], ref_atten[ch])
        t_nd = (curve_normed_diff(sim_time[ch], ref_time[ch])
                if sim_time.get(ch) and ref_time.get(ch) else float("nan"))
        print(f"chan {ch}: atten normed diff {att_nd:.5f}, time normed diff {t_nd:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
