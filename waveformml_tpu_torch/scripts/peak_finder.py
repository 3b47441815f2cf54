"""The peak finder on a hand-written waveform (the port's counterpart of
scripts/test_peak_finder.py):

    python -m waveformml_tpu_torch.scripts.peak_finder

finds the peaks of a vector with peaks at samples 20 and 60 and a smaller
one at 25, inside the first's separation window, checks that 20 and 60 are
selected and 25 is not, prints the culled peaks and ``OK``.
"""
from __future__ import annotations

import sys

import numpy as np


def example_waveform() -> np.ndarray:
    wf = np.zeros(100)
    wf[20], wf[19], wf[21] = 10.0, 5.0, 5.0
    wf[60], wf[59], wf[61] = 8.0, 4.0, 4.0
    wf[25] = 6.0  # within the separation window of the peak at 20
    return wf


def main(argv=None) -> int:
    from waveformml_tpu_torch.ops.dsp import cull_peaks, find_peaks, strip_sentinel

    wf = example_waveform()
    gmax, locs = find_peaks(wf, sep=10)
    print("global max:", gmax, "selected peaks:", locs)
    assert gmax == 20
    assert locs[0] == 20 and locs[1] == 60
    assert 25 not in locs.tolist()
    culled = strip_sentinel(cull_peaks(locs, wf, gmax))
    print("culled:", culled)
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
