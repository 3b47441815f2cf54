"""Classical calibration-based (z, E) reconstruction, the physics baseline
the evaluators compare the networks against, and the conversion of served
classifier scores to PhysPulse fields (numpy, host side; the port's copy
of waveformml_tpu/ops/calibration.py).

The reconstruction chain follows the reference's numba functions
(src/utils/SparseUtils.py): peak_to_dt :769-794, peak_to_z :797-845,
z_from_total_light :876-896, z_dt_to_z/dt_to_z :916-927, calc_calib_z_E
:939-1027, E_basic_prediction(_dense) :1030-1076, z_basic_prediction(_dense)
:1079-1154. The algorithms are branchy per waveform (peak finding, culling,
matching, per-peak interpolation) and run on the host on the eval path.

Calibration inputs are the per-segment interpolation tables of
``evaluation.calibrator.Calibrator`` (light ratio → z, dt → z, light sum
of z, per-channel time interpolation) plus gains, energy resolutions and
timing offsets.
"""
from __future__ import annotations

from dataclasses import dataclass
from math import exp, floor, log, sqrt
from typing import Optional, Tuple

import numpy as np

from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.ops.dsp import (
    calc_arrival_from_peak, calc_size, cull_peaks, find_peaks,
    lin_interp, lin_interp_inverse, match_peaks, strip_sentinel, sum_range)


def _fdiv(a: float, b: float) -> float:
    """C/numba float division: a zero denominator yields ±inf (nan for 0/0)
    instead of Python's ZeroDivisionError. The reference's numba kernels run
    nopython with exactly these semantics (SparseUtils.py), so an event at a
    segment with no calibration curve produces an inf/nan energy that flows
    into the histogram margin bins (+inf the overflow bin, nan the underflow
    bin — NaN fails every comparison in the reference's get_bin_index scan,
    SparseUtils.py:139-154) — never a crash that aborts the evaluator."""
    if b != 0.0:
        return a / b
    if a == 0.0:
        return float("nan")
    return float("inf") if a > 0 else float("-inf")


@dataclass
class CalibrationTables:
    """Per-segment calibration arrays (see evaluation.calibrator.Calibrator).

    t_interp_curves: [NX, NY, 2, n, 2] per-channel time interpolation
    sample_times:    [NX, NY, 2] sample time micro-adjustment period
    rel_times:       [NX, NY] PMT pair relative time offset
    gain_factors:    [NX, NY, 2] normalization/gain factors
    eres:            [NX, NY, 2] photons-per-MeV energy resolution factors
    time_pos_curves: [NX, NY, n, 2] dt [ns] → z [mm]
    light_pos_curves:[NX, NY, n, 2] log light ratio → z [mm]
    light_sum_curves:[NX, NY, n, 2] z [mm] → light sum normalization
    """

    t_interp_curves: np.ndarray
    sample_times: np.ndarray
    rel_times: np.ndarray
    gain_factors: np.ndarray
    eres: np.ndarray
    time_pos_curves: np.ndarray
    light_pos_curves: np.ndarray
    light_sum_curves: np.ndarray
    sample_width: float = 4.0


def _corrected_times(wf, m0, m1, x, y, cal: CalibrationTables, n_samples: int):
    t = [calc_arrival_from_peak(wf[:n_samples], m0) * cal.sample_width,
         calc_arrival_from_peak(wf[n_samples:], m1) * cal.sample_width]
    for i in range(2):
        if cal.t_interp_curves[x, y, i, 10, 0] == 0:
            continue
        st = cal.sample_times[x, y, i]
        t0 = st * floor(t[i] / st)
        t[i] = t0 + lin_interp(cal.t_interp_curves[x, y, i], t[i] - t0)
    return t


def peak_to_dt(wf, m0, m1, x, y, cal: CalibrationTables, n_samples: int
               ) -> Tuple[float, float]:
    """(dt [ns], light sum) from one matched peak pair (ref :769-794)."""
    t = _corrected_times(wf, m0, m1, x, y, cal, n_samples)
    L = [calc_size(wf[:n_samples], m0) * cal.gain_factors[x, y, 0],
         calc_size(wf[n_samples:], m1) * cal.gain_factors[x, y, 1]]
    return t[1] - t[0] - cal.rel_times[x, y], L[0] + L[1]


def peak_to_z_parts(wf, m0, m1, x, y, cal: CalibrationTables, n_samples: int
                    ) -> Tuple[float, float, float, float]:
    """(z, E, z_dt, z_light) from one matched peak pair — the combined
    inverse-variance-weighted z (ref :797-845) plus its two ingredients,
    the dt-derived position and the light-ratio position, separately."""
    t = _corrected_times(wf, m0, m1, x, y, cal, n_samples)
    dt = t[1] - t[0] - cal.rel_times[x, y]
    tpos = lin_interp(cal.time_pos_curves[x, y], dt)
    L = [calc_size(wf[:n_samples], m0) * cal.gain_factors[x, y, 0],
         calc_size(wf[n_samples:], m1) * cal.gain_factors[x, y, 1]]
    if L[0] == 0 or L[1] == 0:
        E0 = _fdiv(L[0] + L[1], lin_interp(cal.light_sum_curves[x, y], 0.0))
        return 0.0, E0, tpos, 0.0
    PE = [L[0] * cal.eres[x, y, 0], L[1] * cal.eres[x, y, 1]]
    # a culled window summing negative (baseline noise) makes the ratio
    # non-positive; the reference's numba np.log yields NaN caught by its
    # R == R guard, but math.log RAISES — guard before taking the log
    ratio = L[1] / L[0]
    validratio = ratio > 0
    R = log(ratio) if validratio else 0.0
    dR = sqrt(1.0 / max(PE[0], 1.0) + 1.0 / max(PE[1], 1.0))
    Rpos = lin_interp(cal.light_pos_curves[x, y], R) if validratio else 0.0
    dRpos = abs(lin_interp(cal.light_pos_curves[x, y], R + 0.5 * dR)
                - lin_interp(cal.light_pos_curves[x, y], R - 0.5 * dR)) \
        if validratio else 0.0
    Rweight = 1.0 / (dRpos * dRpos) if dRpos > 0 else 0.0
    tweight = 1.0 / (60 * 60)
    z = (Rweight * Rpos + tweight * tpos) / (Rweight + tweight)
    z = max(-650.0, min(650.0, z))
    E = _fdiv(PE[0] + PE[1], lin_interp(cal.light_sum_curves[x, y], z))
    return z, E, tpos, Rpos


def peak_to_z(wf, m0, m1, x, y, cal: CalibrationTables, n_samples: int
              ) -> Tuple[float, float]:
    """(z [mm], E [MeV]) from one matched peak pair: light-ratio position and
    dt position combined by inverse-variance weights (ref :797-845)."""
    z, E, _, _ = peak_to_z_parts(wf, m0, m1, x, y, cal, n_samples)
    return z, E


def z_from_total_light(wf, x, y, cal: CalibrationTables, n_samples: int
                       ) -> Tuple[float, float, float]:
    """(z, weight, E) from the light ratio alone (ref :876-896)."""
    L = [sum_range(wf[:n_samples], 0, n_samples - 1) * cal.gain_factors[x, y, 0],
         sum_range(wf[n_samples:], 0, n_samples - 1) * cal.gain_factors[x, y, 1]]
    if L[0] == 0 or L[1] == 0:
        return 0.0, 1.0 / 100000.0, \
            _fdiv(L[0] + L[1], lin_interp(cal.light_sum_curves[x, y], 0.0))
    PE = [L[0] * cal.eres[x, y, 0], L[1] * cal.eres[x, y, 1]]
    ratio = L[1] / L[0]  # see peak_to_z_parts: math.log raises on <= 0
    validratio = ratio > 0
    R = log(ratio) if validratio else 0.0
    z = lin_interp(cal.light_pos_curves[x, y], R) if validratio else 0.0
    z = max(-650.0, min(650.0, z))
    dR = sqrt(1.0 / max(PE[0], 1.0) + 1.0 / max(PE[1], 1.0))
    dRpos = abs(lin_interp(cal.light_pos_curves[x, y], R + 0.5 * dR)
                - lin_interp(cal.light_pos_curves[x, y], R - 0.5 * dR)) \
        if validratio else 0.0
    Rweight = 1.0 / (dRpos * dRpos) if dRpos > 0 else 0.0
    E = _fdiv(PE[0] + PE[1], lin_interp(cal.light_sum_curves[x, y], z))
    return z, Rweight, E


def dt_to_z(wf, dt, x, y, cal: CalibrationTables, n_samples: int
            ) -> Tuple[float, float]:
    """Combine a dt-derived position with the light-ratio position (ref :922-927)."""
    z_dt = lin_interp(cal.time_pos_curves[x, y], dt)
    return z_dt_to_z(wf, z_dt, x, y, cal, n_samples)


def z_dt_to_z(wf, z_dt, x, y, cal: CalibrationTables, n_samples: int
              ) -> Tuple[float, float]:
    """(ref :916-919)"""
    z_dt_weight = 1.0 / (60.0 * 60.0)
    z_light, z_light_weight, E = z_from_total_light(wf, x, y, cal, n_samples)
    z = (z_dt_weight * z_dt + z_light * z_light_weight) / (z_light_weight + z_dt_weight)
    return z, E


def calc_calib_z_E(coordinates: np.ndarray, waveforms: np.ndarray,
                   z_out: np.ndarray, E_out: np.ndarray,
                   cal: CalibrationTables, z_scale: float, n_samples: int,
                   minsep: int = 10,
                   z_dt_out: Optional[np.ndarray] = None,
                   z_light_out: Optional[np.ndarray] = None) -> None:
    """Full classical reconstruction per pulse into dense [B, NX, NY] maps
    (ref :939-1027): find/cull peaks per PMT, pair or match them, reconstruct
    per-peak (z, E), energy-weight, normalize z to [0, 1].

    z_dt_out / z_light_out, when given, additionally receive the SEPARATED
    baselines — the dt-derived position alone and the light-ratio position
    alone (the two ingredients peak_to_z combines, ref :797-845) — so the
    evaluators can plot each classical method against the NN."""
    sep = z_dt_out is not None
    for coord, wf in zip(coordinates, waveforms):
        x, y, b = int(coord[0]), int(coord[1]), int(coord[2])
        maxloc0, peaks0 = find_peaks(wf[:n_samples], minsep)
        maxloc1, peaks1 = find_peaks(wf[n_samples:], minsep)
        peaks0 = strip_sentinel(cull_peaks(peaks0, wf[:n_samples], maxloc0))
        peaks1 = strip_sentinel(cull_peaks(peaks1, wf[n_samples:], maxloc1))
        if peaks0 is None or peaks1 is None:
            if peaks0 is None and peaks1 is None:
                continue
            r = 1 if peaks0 is None else 0
            z_out[b, x, y] = 0.5
            if sep:
                z_dt_out[b, x, y] = 0.5
                z_light_out[b, x, y] = 0.5
            L = sum_range(wf[n_samples * r: n_samples + n_samples * r],
                          0, n_samples - 1) * cal.gain_factors[x, y, r]
            PE = L * cal.eres[x, y, r]
            E_out[b, x, y] = _fdiv(PE, lin_interp(cal.light_sum_curves[x, y], 0))
            continue
        peaks0 = np.sort(peaks0)
        peaks1 = np.sort(peaks1)
        if peaks0.shape[0] == peaks1.shape[0]:
            z_weighted, total = 0.0, 0.0
            zdt_weighted, zlight_weighted = 0.0, 0.0
            for m0, m1 in zip(peaks0, peaks1):
                pz, pE, pzdt, pzlight = peak_to_z_parts(
                    wf, int(m0), int(m1), x, y, cal, n_samples)
                z_weighted += pz * pE
                zdt_weighted += pzdt * pE
                zlight_weighted += pzlight * pE
                total += pE
            z_out[b, x, y] = _fdiv(z_weighted, total) / z_scale + 0.5
            E_out[b, x, y] = total
            if sep:
                z_dt_out[b, x, y] = max(-650.0, min(
                    650.0, _fdiv(zdt_weighted, total))) / z_scale + 0.5
                z_light_out[b, x, y] = max(-650.0, min(
                    650.0, _fdiv(zlight_weighted, total))) / z_scale + 0.5
        else:
            z_weighted, total = 0.0, 0.0
            if peaks0.shape[0] < peaks1.shape[0]:
                inds = match_peaks(peaks0, peaks1)
                pairs = [(int(peaks0[i]), int(peaks1[inds[i]]))
                         for i in range(peaks0.shape[0])]
            else:
                inds = match_peaks(peaks1, peaks0)
                pairs = [(int(peaks0[inds[i]]), int(peaks1[i]))
                         for i in range(peaks1.shape[0])]
            for m0, m1 in pairs:
                pdt, parea = peak_to_dt(wf, m0, m1, x, y, cal, n_samples)
                z_weighted += pdt * parea
                total += parea
            z_dt = _fdiv(z_weighted, total)
            z, E = z_dt_to_z(wf, z_dt, x, y, cal, n_samples)
            z_out[b, x, y] = z / z_scale + 0.5
            E_out[b, x, y] = E
            if sep:
                # the separated dt baseline is a POSITION: map the averaged dt
                # [ns] through the dt->z curve first, like the matched branch's
                # tpos (the combined z_out keeps the reference's raw-dt combine,
                # ref :1023 + :910, for parity)
                tpos = lin_interp(cal.time_pos_curves[x, y], z_dt)
                z_dt_out[b, x, y] = max(-650.0, min(650.0, tpos)) / z_scale + 0.5
                zl, _w, _E = z_from_total_light(wf, x, y, cal, n_samples)
                z_light_out[b, x, y] = zl / z_scale + 0.5


# ---------------------------------------------------------------------------------
# basic (non-waveform) baselines used by the evaluators
# ---------------------------------------------------------------------------------

def E_basic_prediction_dense(E: np.ndarray, z: np.ndarray, blind_detl, blind_detr,
                             light_pos_curves, light_sum_curves,
                             pred: np.ndarray) -> None:
    """Reconstruct E from a predicted z at single-ended segments by inverting
    the light-ratio curve (ref :1030-1056). E: [B, 3, NX, NY] (E, PE0, PE1)."""
    for b in range(E.shape[0]):
        for x in range(E.shape[2]):
            for y in range(E.shape[3]):
                if E[b, 0, x, y] == 0:
                    continue
                if blind_detl[x, y] == 1 and blind_detr[x, y] == 1:
                    continue
                if blind_detl[x, y] == 1 or blind_detr[x, y] == 1:
                    logR = lin_interp_inverse(light_pos_curves[x, y], z[b, x, y])
                    if blind_detl[x, y] == 1:
                        P0 = E[b, 2, x, y] / exp(logR)
                        pred[b, x, y] = _fdiv(P0 + E[b, 2, x, y], lin_interp(
                            light_sum_curves[x, y], z[b, x, y]))
                    else:
                        P1 = E[b, 1, x, y] * exp(logR)
                        pred[b, x, y] = _fdiv(E[b, 1, x, y] + P1, lin_interp(
                            light_sum_curves[x, y], z[b, x, y]))
                else:
                    pred[b, x, y] = E[b, 0, x, y]


def E_basic_prediction(coo, E, PE0, PE1, z, seg_status, light_pos_curves,
                       light_sum_curves, pred) -> None:
    """Sparse-row variant (ref :1058-1076)."""
    for i in range(coo.shape[0]):
        x, y = int(coo[i, 0]), int(coo[i, 1])
        if seg_status[x, y] > 0:
            if PE0[i] == 0 and PE1[i] == 0:
                continue
            logR = lin_interp_inverse(light_pos_curves[x, y], z[i])
            if PE0[i] == 0:
                P0 = PE1[i] / exp(logR)
                pred[i] = _fdiv(P0 + PE1[i], lin_interp(light_sum_curves[x, y], z[i]))
            else:
                P1 = PE0[i] * exp(logR)
                pred[i] = _fdiv(PE0[i] + P1, lin_interp(light_sum_curves[x, y], z[i]))
        else:
            pred[i] = E[i]


def z_basic_prediction(coo: np.ndarray, feat: np.ndarray, pred: np.ndarray) -> None:
    """Fill unknown (0.5) per-row z with the mean of |dx|<=1, |dy|<=1
    neighbor rows (orthogonal AND diagonal — the reference's sparse variant,
    ref :1124-1154, deliberately differs from its strictly-diagonal dense
    twin :1079-1121; both quirks reproduced) in the same event."""
    ev = coo[:, 2]
    # group rows per event once (rows are event-sorted in practice; the
    # stable argsort makes no assumption) — a whole-batch `ev == ev[i]` scan
    # per row would be O(N²) in batch rows
    order = np.argsort(ev, kind="stable")
    bounds = np.flatnonzero(np.diff(ev[order])) + 1
    for grp in np.split(order, bounds):
        for i in grp:
            if feat[i] != 0.5:
                pred[i] = feat[i]
                continue
            near = [j for j in grp if j != i
                    and abs(coo[j, 0] - coo[i, 0]) <= 1
                    and abs(coo[j, 1] - coo[i, 1]) <= 1
                    and feat[j] != 0.5]
            pred[i] = float(np.mean([feat[j] for j in near])) if near else 0.5


def z_basic_prediction_dense(coo: np.ndarray, z_pred: np.ndarray,
                             z_truth: Optional[np.ndarray] = None,
                             truth_is_cal: bool = False) -> None:
    """Dense variant: replace 0.5 (unknown, single-ended) sites with the mean
    of strictly-diagonal neighbors known in the same event; optionally seed
    known sites from the calibration truth (ref :1079-1121)."""
    ev = coo[:, 2]
    for b in np.unique(ev):
        rows = np.flatnonzero(ev == b)
        xs, ys = coo[rows, 0], coo[rows, 1]
        known = [(x, y) for x, y in zip(xs, ys) if z_pred[b, x, y] != 0.5]
        if truth_is_cal and z_truth is not None:
            for x, y in known:
                z_pred[b, x, y] = z_truth[b, x, y]
        if not known:
            continue
        for x, y in zip(xs, ys):
            if z_pred[b, x, y] != 0.5:
                continue
            vals = [z_pred[b, j, k] for j, k in known
                    if abs(int(x) - int(j)) == 1 and abs(int(y) - int(k)) == 1]
            if vals:
                z_pred[b, x, y] = float(np.mean(vals))


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


def make_synthetic_tables(rng: Optional[np.random.Generator] = None,
                          n_points: int = 21) -> CalibrationTables:
    """Physically-shaped synthetic calibration tables for hermetic tests:
    linear light-ratio→z and dt→z, flat light-sum, unit gains."""
    rng = rng or np.random.default_rng(0)
    zs = np.linspace(-650, 650, n_points)
    light_pos = np.zeros((NX, NY, n_points, 2))
    time_pos = np.zeros((NX, NY, n_points, 2))
    light_sum = np.zeros((NX, NY, n_points, 2))
    for x in range(NX):
        for y in range(NY):
            # R = log(r/l) = 1.6 * z / 600 (matches the synthetic data
            # generator's exp(±0.8 z / 600) attenuation)
            R = 1.6 * zs / 600.0
            light_pos[x, y, :, 0] = R
            light_pos[x, y, :, 1] = zs
            dt = zs / 100.0  # 10 mm/ns propagation
            time_pos[x, y, :, 0] = dt
            time_pos[x, y, :, 1] = zs
            light_sum[x, y, :, 0] = zs
            light_sum[x, y, :, 1] = 1.0
    t_interp = np.zeros((NX, NY, 2, n_points, 2))
    sample_times = np.full((NX, NY, 2), 4.0)
    rel_times = np.zeros((NX, NY))
    # gain_factors undo the 1/MAX_RANGE waveform normalization (the reference
    # passes "gains multiplied by 2**14-1", SparseUtils.py:806)
    from waveformml_tpu_torch.detector import MAX_RANGE

    gains = np.full((NX, NY, 2), float(MAX_RANGE))
    eres = np.ones((NX, NY, 2))
    return CalibrationTables(t_interp, sample_times, rel_times, gains, eres,
                             time_pos, light_pos, light_sum)
