"""Per-segment regression + real-data evaluators.

``SegEvaluator`` (ref: src/evaluation/SegEvaluator.py, 108 LoC): regression
MAE vs phys parameters per PID class + ErrorAggregator.
``RealDataEvaluator`` (ref: src/evaluation/RealDataEvaluator.py, 91 LoC):
dense per-segment metrics with PID categories for real data.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from waveformml_tpu_torch.evaluation.ad1 import SingleEndedEvaluator, select_rows
from waveformml_tpu_torch.evaluation.metric_agg import MetricAggregator, MetricPairAggregator
from waveformml_tpu_torch.evaluation.pid_eval import PID_MAPPED_NAMES, map_pid
from waveformml_tpu_torch.evaluation.stats import ErrorAggregator
from waveformml_tpu_torch.ops.sparse import consecutive_event_index


class SegEvaluator(SingleEndedEvaluator):
    """Segment scalar-regression evaluation per PID class (ref: SegEvaluator.py:51-108)."""

    def __init__(self, logger=None, calgroup=None, metric_name: str = "MAE",
                 metric_unit: str = "", scale_factor: float = 1.0,
                 target_index: Optional[int] = None, SE_only: bool = False, **kwargs):
        super().__init__(logger, calgroup=calgroup, **kwargs)
        self.SE_only = SE_only
        self.target_index = target_index
        self.class_names = list(PID_MAPPED_NAMES.values())
        aggs = []
        for idx in (self.E_index, self.PSD_index, self.z_index):
            lo, hi, nb = self.default_bins[idx]
            aggs.append(MetricAggregator(self.phys_names[idx], lo, hi, 25,
                                         self.class_names,
                                         metric_name=metric_name,
                                         metric_unit=metric_unit,
                                         parameter_unit=self.phys_units[idx],
                                         scale_factor=scale_factor))
        self.pair = MetricPairAggregator(aggs, metric_name=metric_name,
                                         metric_unit=metric_unit)
        self.error = ErrorAggregator("segment", 0.0, 1.0, 50, self.class_names,
                                     metric_name=metric_name,
                                     metric_unit=metric_unit,
                                     scale_factor=scale_factor)

    def add(self, coords: np.ndarray, predictions: np.ndarray,
            targets: np.ndarray, pid: Optional[np.ndarray] = None,
            phys: Optional[np.ndarray] = None) -> None:
        x = coords[:, 0].astype(np.int64)
        y = coords[:, 1].astype(np.int64)
        keep = (self.seg_status[x, y] == 0.5) if self.SE_only \
            else np.ones(len(coords), dtype=bool)
        if not keep.any():
            return
        err = np.abs(predictions[keep] - targets[keep])
        classes = map_pid(pid[keep]) if pid is not None \
            else np.zeros(keep.sum(), dtype=np.int64)
        if phys is not None:
            params = np.stack([
                phys[keep, self.E_index] * self.E_scale,
                phys[keep, self.PSD_index],
                (phys[keep, self.z_index] - 0.5) * self.z_scale])
            for ci, cname in enumerate(self.class_names):
                sel = classes == ci
                if sel.any():
                    self.pair.add(err[sel], params[:, sel], cname)
        for ci, cname in enumerate(self.class_names):
            sel = classes == ci
            if sel.any():
                self.error.add_norm(predictions[keep][sel], targets[keep][sel],
                                    cname)

    def add_batch(self, block, db, test_out) -> None:
        """One test batch: ``db`` the host arrays ``prepare_block`` made,
        ``test_out`` the per-row outputs over at least the real rows."""
        mask = np.asarray(db["mask"], dtype=bool)
        if not mask.any():
            return
        pred = select_rows(test_out["predictions"], mask)
        if pred.ndim == 2:
            pred = pred[:, 0]
        targets = np.asarray(db["labels_rows"])[mask]
        if targets.ndim == 2:
            targets = targets[:, self.target_index if self.target_index is not None else 0]
        phys = np.asarray(db["extra_phys"])[mask] if "extra_phys" in db else None
        # datasets configured with additional_fields=["PID"] ship the raw
        # per-row PID as an extra; without it every row accumulates under
        # class 0 (ref SegEvaluator.add reads additional_fields,
        # SegEvaluator.py:73-85)
        pid = np.asarray(db["extra_PID"])[mask] if "extra_PID" in db else None
        self.add(np.asarray(db["coords"])[mask], pred, targets, pid=pid, phys=phys)

    def dump(self) -> None:
        if self.logger is None:
            return
        self.pair.plot(self.logger)
        self.error.plot(self.logger)


class RealDataEvaluator(SingleEndedEvaluator):
    """Dense per-segment metric accumulation with PID categories for real data
    (ref: RealDataEvaluator.py:27-91)."""

    def __init__(self, logger=None, calgroup=None, metric_name: str = "MAE",
                 scale_factor: float = 1.0, **kwargs):
        super().__init__(logger, calgroup=calgroup, **kwargs)
        self.class_names = list(PID_MAPPED_NAMES.values())
        eb = self.default_bins[self.E_index]
        self.metric_vs_E = MetricAggregator("energy", eb[0], eb[1], 25,
                                            self.class_names,
                                            metric_name=metric_name,
                                            parameter_unit="MeV",
                                            scale_factor=scale_factor)
        self.metric_vs_mult = MetricAggregator("multiplicity", 0.5, 5.5, 5,
                                               self.class_names,
                                               metric_name=metric_name,
                                               scale_factor=scale_factor)
        self.register_segment_metric("seg_metric", metric_name)

    def add(self, coords: np.ndarray, results: np.ndarray,
            pid: Optional[np.ndarray] = None, E: Optional[np.ndarray] = None) -> None:
        x = coords[:, 0].astype(np.int64)
        y = coords[:, 1].astype(np.int64)
        b = consecutive_event_index(coords[:, 2])
        mult = np.bincount(b)[b].astype(np.float64)
        classes = map_pid(pid) if pid is not None \
            else np.zeros(len(coords), dtype=np.int64)
        for ci, cname in enumerate(self.class_names):
            sel = classes == ci
            if not sel.any():
                continue
            self.metric_vs_mult.add(results[sel], np.clip(mult[sel], 1, 5), cname)
            if E is not None:
                self.metric_vs_E.add(results[sel], E[sel], cname)
        self.accumulate("seg_metric", results, (x, y))

    def dump(self) -> None:
        if self.logger is None:
            return
        self.metric_vs_E.plot(self.logger)
        self.metric_vs_mult.plot(self.logger)
        self.log_segment_metric("seg_metric", "segment_metric", "metric by segment")
