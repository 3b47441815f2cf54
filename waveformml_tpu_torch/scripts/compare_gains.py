"""Compare the per-PMT gains of one calibration group in two calibration
databases (the port's counterpart of scripts/CompareGains.py):

    python -m waveformml_tpu_torch.scripts.compare_gains cal1.db cal2.db calname

prints each PMT's relative difference and the largest.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from waveformml_tpu_torch.detector import NX, NY
    from waveformml_tpu_torch.evaluation.calibrator import Calibrator
    from waveformml_tpu_torch.io.sql import CalibrationDB

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("cal1", help="calibration db path 1")
    parser.add_argument("cal2", help="calibration db path 2")
    parser.add_argument("calname", help="calibration group name")
    args = parser.parse_args(argv)
    cal1 = Calibrator(CalibrationDB(args.cal1, args.calname))
    cal2 = Calibrator(CalibrationDB(args.cal2, args.calname))
    max_diff, max_det = 0.0, 0
    for i in range(NX):
        for j in range(NY):
            for k in range(2):
                if cal1.gains[i, j, k] == 0:
                    continue
                diff = (cal1.gains[i, j, k] - cal2.gains[i, j, k]) / cal1.gains[i, j, k]
                det = 2 * (NX * j + i) + k
                if abs(diff) > max_diff:
                    max_det, max_diff = det, abs(diff)
                print(f"det {det} gain diff {diff}")
    print(f"max diff is det {max_det} diff {max_diff}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
