"""Calibrator: precompute per-segment interpolation tables from the DB curves.

Port of src/evaluation/Calibrator.py:36-133 — light-ratio→z
(``calc_light_pos_curve`` :68-89), PMT dt→z (``calc_time_pos_curve`` :91-113),
light-sum vs z (``calc_light_sum_curve`` :115-133), per-channel time-interp
tables (:58-66). Output arrays feed ops.calibration.CalibrationTables.
"""
from __future__ import annotations

import logging
from typing import Dict

import numpy as np

from waveformml_tpu_torch.detector import MAX_RANGE, NX, NY
from waveformml_tpu_torch.io.sql import CalCurve, CalibrationDB, chan_to_coords
from waveformml_tpu_torch.ops.calibration import CalibrationTables

log = logging.getLogger(__name__)

N_LIGHT_POS = 51
N_CURVE = 50


class Calibrator:
    def __init__(self, calibdb: CalibrationDB):
        self.calibdb = calibdb
        self.gains, self.eres, self.rel_times, self.seg_times = \
            calibdb.get_seg_cal_values()
        (self.atten_curves, self.lsum_curves, self.time_curves, self.lin_curves,
         self.psd_curves, t_interp_curves, self.e_ncapt) = calibdb.get_curves()
        self.sampletime = np.zeros((NX, NY, 2), dtype=np.float32)
        self.light_pos_curves = np.zeros((NX, NY, N_LIGHT_POS, 2), dtype=np.float32)
        self.time_pos_curves = np.zeros((NX, NY, N_CURVE, 2), dtype=np.float32)
        self.light_sum_curves = np.zeros((NX, NY, N_CURVE, 2), dtype=np.float32)
        self.t_interp_curves = np.zeros((NX, NY, 2, N_CURVE, 2), dtype=np.float32)
        self.calc_light_pos_curve(self.atten_curves)
        self.calc_time_pos_curve(self.time_curves)
        self.calc_light_sum_curve(self.lsum_curves, self.atten_curves)
        self.calc_t_interp_curve(t_interp_curves)
        for chan, curve in t_interp_curves.items():
            if curve:
                x, y, r = chan_to_coords(chan)
                self.sampletime[x, y, r] = round(max(curve.xs))
        # tables() output is immutable once the curves above are filled
        # (nothing mutates them after __init__); memoize — evaluators call
        # tables() once per batch on the host eval path
        self._tables_cache: Dict[tuple, "CalibrationTables"] = {}

    # -- tables --------------------------------------------------------------------
    def calc_light_pos_curve(self, atten_curves: Dict[int, CalCurve]) -> None:
        """log(light_r / light_l)(z) sampled on a z grid, stored as
        (logR, z) pairs (ref :68-89)."""
        for seg in range(NX * NY):
            l, r = 2 * seg, 2 * seg + 1
            curvel, curver = atten_curves.get(l), atten_curves.get(r)
            if not curvel or not curver:
                continue
            curvel.sort()
            curver.sort()
            x, y, _ = chan_to_coords(l)
            zmin = max(curvel.xs[0], curver.xs[0])
            zmax = min(curvel.xs[-1], curver.xs[-1])
            zs = np.linspace(zmin, zmax, N_LIGHT_POS)
            logr = np.log(np.asarray(curver.eval(zs)) / np.asarray(curvel.eval(zs)))
            self.light_pos_curves[x, y, :, 0] = logr
            self.light_pos_curves[x, y, :, 1] = zs

    def calc_time_pos_curve(self, time_curves: Dict[int, CalCurve]) -> None:
        """dt(z) = t_r(z) − t_l(z), stored as (dt, z) pairs sampled zmax→zmin
        (ref :91-113)."""
        for seg in range(NX * NY):
            l, r = 2 * seg, 2 * seg + 1
            curvel, curver = time_curves.get(l), time_curves.get(r)
            if not curvel or not curver:
                continue
            curvel.sort()
            curver.sort()
            x, y, _ = chan_to_coords(l)
            zmin = max(curvel.xs[0], curver.xs[0])
            zmax = min(curvel.xs[-1], curver.xs[-1])
            assert zmin < zmax
            zs = np.linspace(zmax, zmin, N_CURVE)
            dts = np.asarray(curver.eval(zs)) - np.asarray(curvel.eval(zs))
            self.time_pos_curves[x, y, :, 0] = dts
            self.time_pos_curves[x, y, :, 1] = zs

    def calc_light_sum_curve(self, lsum_curves: Dict[int, CalCurve],
                             atten_curves: Dict[int, CalCurve]) -> None:
        """eres-weighted total light vs z (ref :115-133); falls back to the
        attenuation curves when no dedicated light-sum curves exist."""
        for seg in range(NX * NY):
            l, r = 2 * seg, 2 * seg + 1
            cl = lsum_curves.get(l) or atten_curves.get(l)
            cr = lsum_curves.get(r) or atten_curves.get(r)
            if not cl or not cr:
                continue
            x, y, _ = chan_to_coords(l)
            zs = np.linspace(-650, 650, N_CURVE)
            ys = self.eres[x, y, 0] * np.asarray(cl.eval(zs)) + \
                self.eres[x, y, 1] * np.asarray(cr.eval(zs))
            self.light_sum_curves[x, y, :, 0] = zs
            self.light_sum_curves[x, y, :, 1] = ys

    def calc_t_interp_curve(self, t_interp_curves: Dict[int, CalCurve]) -> None:
        """Per-channel sub-sample time interpolation tables (ref :58-66)."""
        for chan, curve in t_interp_curves.items():
            if not curve:
                continue
            curve.sort()
            x, y, r = chan_to_coords(chan)
            xs = np.linspace(curve.xs[0], curve.xs[-1], N_CURVE)
            self.t_interp_curves[x, y, r, :, 0] = xs
            self.t_interp_curves[x, y, r, :, 1] = curve.eval(xs)

    # -- export --------------------------------------------------------------------
    def tables(self, sample_width: float = 4.0,
               normalize_gains: bool = True) -> CalibrationTables:
        """Package everything for ops.calibration. With normalize_gains the
        gain factors undo the 1/MAX_RANGE waveform normalization."""
        key = (float(sample_width), bool(normalize_gains))
        cached = self._tables_cache.get(key)
        if cached is not None:
            return cached
        gains = self.gains.astype(np.float64).copy()
        factors = np.where(gains != 0,
                           MAX_RANGE / np.where(gains == 0, 1.0, gains),
                           0.0) if normalize_gains else gains
        sample_times = np.where(self.sampletime > 0, self.sampletime, 4.0)
        self._tables_cache[key] = CalibrationTables(
            t_interp_curves=self.t_interp_curves.astype(np.float64),
            sample_times=sample_times.astype(np.float64),
            rel_times=self.rel_times.astype(np.float64),
            gain_factors=factors,
            eres=self.eres.astype(np.float64),
            time_pos_curves=self.time_pos_curves.astype(np.float64),
            light_pos_curves=self.light_pos_curves.astype(np.float64),
            light_sum_curves=self.light_sum_curves.astype(np.float64),
            sample_width=sample_width)
        return self._tables_cache[key]
