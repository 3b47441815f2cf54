"""Calibration-based conversions of served outputs (numpy; the port's copy
of the part of waveformml_tpu/ops/calibration.py that the prediction
writers use). The classical (z, E) reconstruction of that module comes with
the evaluation."""
from __future__ import annotations

from typing import Optional

import numpy as np


def convert_wf_phys_SE_classifier(coord, E_in, E_out, rand_out, dt_in, dt_out,
                                  z_in, z_out, PSD_in, PSD_out, E_SE_out,
                                  z_SE_out, Esmear_SE_out, PSD_SE_out, nn_z,
                                  nn_out, blind_detl, blind_detr,
                                  rng: Optional[np.random.Generator] = None) -> None:
    """Fill PhysPulse fields in place from a segment classifier's 5 scores
    a row. At single-ended segments (one PMT blind) the scores go to (E,
    rand, dt, y, PSD), the raw E and PSD to the seeing side of ``E_SE`` and
    ``PSD_SE``, a uniform draw to that side of ``Esmear_SE`` and the
    network's z to ``y_SE``; double-ended rows pass E, dt, z and PSD
    through and draw ``rand`` uniform in [0, 1); rows of dead segments
    (both PMTs blind) are left as they are. ``rng`` is the generator of
    the draws (a fresh, unseeded one by default)."""
    rng = rng or np.random.default_rng()
    x = coord[:, 0].astype(np.int64)
    y = coord[:, 1].astype(np.int64)
    bl = blind_detl[x, y] == 1
    br = blind_detr[x, y] == 1
    dead = bl & br
    se = (bl | br) & ~dead
    de = ~bl & ~br
    E_out[se] = nn_out[se, 0]
    rand_out[se] = nn_out[se, 1]
    dt_out[se] = nn_out[se, 2]
    z_out[se] = nn_out[se, 3]
    PSD_out[se] = nn_out[se, 4]
    z_SE_out[se] = nn_z[se]
    # the seeing side: 1 where the left PMT is blind
    side = np.where(bl, 1, 0)
    rows = np.flatnonzero(se)
    E_SE_out[rows, side[rows]] = E_in[rows]
    Esmear_SE_out[rows, side[rows]] = rng.uniform(0.0, 1.0, rows.size)
    PSD_SE_out[rows, side[rows]] = PSD_in[rows]
    E_out[de] = E_in[de]
    rand_out[de] = rng.uniform(0.0, 1.0, int(de.sum()))
    dt_out[de] = dt_in[de]
    z_out[de] = z_in[de]
    PSD_out[de] = PSD_in[de]
