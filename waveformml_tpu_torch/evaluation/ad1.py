"""Detector-level evaluator bases.

``AD1Evaluator`` (ref: src/evaluation/AD1Evaluator.py:20-130): the phys-feature
schema (7-vector E/dt/PE0/PE1/z/PSD/t0 with normalization scales), the
calibration bootstrap (PROSPECT_CALDB env + calgroup → Calibrator), dense
scatter helper, default bin ranges with ``bin_overrides``, and per-detector
metric registration. ``SingleEndedEvaluator`` (ref:
src/evaluation/SingleEndedEvaluator.py): seg_status / blind maps from the
dead-PMT list.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.engineering.se_mask import SE_DEAD_PMTS, seg_status_maps
from waveformml_tpu_torch.evaluation.stats import StatsAggregator

def select_rows(values, mask: np.ndarray) -> np.ndarray:
    """The rows of a test output that ``mask`` selects. ``mask`` is a
    padded batch's prefix mask (its real events or rows); ``values`` holds
    at least those rows, padded or not (the port's ``Trainer`` hands over
    only the real ones)."""
    v = np.asarray(values)
    return v[np.asarray(mask, dtype=bool)[:v.shape[0]]]


E_NORMALIZATION_FACTOR = 12.0
Z_NORMALIZATION_FACTOR = 1200.0
CELL_LENGTH = 1176.0


class AD1Evaluator(StatsAggregator):
    """Physics-feature schema + calibration bootstrap (ref: AD1Evaluator.py:20-130).

    physcoord layout: [E/12, dt/30+0.5, PE0/5000, PE1/5000, z/1200+0.5, PSD,
    (t−toffset)/30] (ref docstring :21-29).
    """

    def __init__(self, logger=None, calgroup: Optional[str] = None,
                 e_scale: Optional[float] = None, **kwargs):
        super().__init__(logger)
        self.nx, self.ny = NX, NY
        self.z_scale = Z_NORMALIZATION_FACTOR
        self.E_scale = E_NORMALIZATION_FACTOR
        if e_scale:
            self.E_adjust = self.E_scale / e_scale
            self.E_scale = e_scale
        else:
            self.E_adjust = 1.0
        self.dt_scale = 30.0
        self.toffset_scale = 30.0
        self.PE_scale = 5000.0 / self.E_adjust
        self.dp_scale = CELL_LENGTH
        self.E_index, self.dt_index = 0, 1
        self.PE0_index, self.PE1_index = 2, 3
        self.z_index, self.PSD_index = 4, 5
        self.toffset_index, self.dp_index = 6, 7
        self.phys_names = ["Energy", "dt", "PE0", "PE1", "z", "PSD",
                           "t offset", "distance to PMT"]
        self.phys_units = ["MeV", "ns", "", "", "mm", "", "ns", "mm"]
        self.default_bins = [
            [0.0, self.E_scale, 100], [-self.dt_scale / 2, self.dt_scale / 2, 100],
            [0.0, self.PE_scale, 100], [0.0, self.PE_scale, 100],
            [-self.z_scale / 2, self.z_scale / 2, 100], [0.0, 0.6, 100],
            [0.0, self.toffset_scale, 100], [0.0, CELL_LENGTH, 100]]
        if kwargs.get("bin_overrides"):
            self.override_default_bins(kwargs["bin_overrides"])
        self.hascal = False
        self.calibrator = None
        if calgroup is not None:
            self._bootstrap_calibration(calgroup)

    def _bootstrap_calibration(self, calgroup: str) -> None:
        """(ref: AD1Evaluator.py:67-75)"""
        if "PROSPECT_CALDB" not in os.environ:
            raise ValueError(
                "PROSPECT_CALDB environment variable must point at the "
                "calibration sqlite database when calgroup is set")
        from waveformml_tpu_torch.evaluation.calibrator import Calibrator
        from waveformml_tpu_torch.io.sql import CalibrationDB

        db = CalibrationDB(os.environ["PROSPECT_CALDB"], calgroup)
        self.calibrator = Calibrator(db)
        self.hascal = True

    def override_default_bins(self, overrides) -> None:
        """(ref: AD1Evaluator.py:64-66)"""
        items = overrides.items() if hasattr(overrides, "items") else overrides
        for key, val in items:
            idx = int(key) if str(key).isdigit() else self.phys_names.index(key)
            self.default_bins[idx] = list(val)

    def get_dense_matrix(self, values: np.ndarray, coords: np.ndarray,
                         n_events: Optional[int] = None) -> np.ndarray:
        """Scatter per-row values to [B, C, NX, NY] (ref :84-95)."""
        from waveformml_tpu_torch.ops.sparse import consecutive_event_index

        v = np.asarray(values)
        if v.ndim == 1:
            v = v[:, None]
        b = consecutive_event_index(coords[:, 2])
        B = n_events if n_events is not None else (int(b[-1]) + 1 if len(b) else 0)
        out = np.zeros((B, v.shape[1], NX, NY), dtype=np.float64)
        out[b, :, coords[:, 0].astype(np.int64), coords[:, 1].astype(np.int64)] = v
        return out

    def register_segment_metric(self, name: str, metric_name: str,
                                metric_units: str = "", n_extra: int = 0,
                                extra_bins=None) -> None:
        """Per-detector (NX×NY[, extra]) accumulator (ref :115-130)."""
        if n_extra:
            lo, hi, nb = extra_bins
            self.register_aggregator(
                name, (NX, NY, nb), (0, 0, lo), (NX, NY, hi), 3,
                ("x segment", "y segment", "extra"), ("", "", ""),
                metric_name, metric_units, underflow=(0, 0, 1), overflow=(0, 0, 1))
        else:
            self.register_aggregator(
                name, (NX, NY), (0, 0), (NX, NY), 2,
                ("x segment", "y segment"), ("", ""), metric_name, metric_units,
                underflow=(0, 0), overflow=(0, 0))


class SingleEndedEvaluator(AD1Evaluator):
    """seg_status / blind maps (ref: SingleEndedEvaluator.py:8-58)."""

    def __init__(self, logger=None, calgroup: Optional[str] = None,
                 e_scale: Optional[float] = None, **kwargs):
        super().__init__(logger, calgroup=calgroup, e_scale=e_scale, **kwargs)
        dead = kwargs.get("excludes", SE_DEAD_PMTS)
        self.seg_status, self.blind_detl, self.blind_detr = seg_status_maps(dead)

    def num_left_right_SE(self):
        n_left = int(((self.seg_status == 0.5) & (self.blind_detr == 1)).sum())
        n_right = int(((self.seg_status == 0.5) & (self.blind_detr == 0)).sum())
        return n_left, n_right

    def retrieve_SE_inds(self, coo: np.ndarray) -> np.ndarray:
        return self.seg_status[coo[:, 0], coo[:, 1]] == 0.5
