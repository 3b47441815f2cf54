"""The per-waveform evaluator of ``LitWaveform`` (counterpart of
waveformml_tpu/evaluation/tensor_eval.py): each row's loss binned over the
phys parameters (where the targets are phys records), over the target, and
by detector segment."""
from __future__ import annotations

from typing import Optional

import numpy as np

from waveformml_tpu_torch.detector import NX
from waveformml_tpu_torch.evaluation.ad1 import AD1Evaluator, select_rows
from waveformml_tpu_torch.evaluation.metric_agg import MetricAggregator, MetricPairAggregator


class TensorEvaluator(AD1Evaluator):
    def __init__(self, logger=None, calgroup=None, e_scale=None,
                 target_has_phys: bool = False, target_index: Optional[int] = None,
                 metric_name: str = "metric", **kwargs):
        super().__init__(logger, calgroup=calgroup, e_scale=e_scale, **kwargs)
        self.target_has_phys = target_has_phys
        self.target_index = target_index
        self.metric_name = metric_name
        cats = ["all"]
        aggs = []
        for idx in (self.E_index, self.PSD_index, self.z_index):
            lo, hi, _ = self.default_bins[idx]
            aggs.append(MetricAggregator(self.phys_names[idx], lo, hi, 25, cats,
                                         metric_name=metric_name,
                                         parameter_unit=self.phys_units[idx]))
        self.pair = MetricPairAggregator(aggs, metric_name=metric_name)
        self.target_agg = MetricAggregator("target", 0.0, 1.0, 50, cats,
                                           metric_name=metric_name)
        self.register_segment_metric("det_metric", metric_name)

    def add(self, c: np.ndarray, f: np.ndarray, target: np.ndarray,
            results: np.ndarray) -> None:
        """``c`` the rows' detector channel ids ``[N]`` (or coords ``[N,
        3]``), ``target`` their labels, ``results`` their losses ``[N]``
        (a mean over any further axes)."""
        results = np.asarray(results, dtype=np.float64)
        if results.ndim > 1:
            results = results.mean(axis=tuple(range(1, results.ndim)))
        if target.ndim == 2 and self.target_has_phys:
            phys = target
            params = np.stack([phys[:, self.E_index] * self.E_scale,
                               phys[:, self.PSD_index],
                               (phys[:, self.z_index] - 0.5) * self.z_scale])
            self.pair.add(results, params, "all")
            t = (phys[:, self.target_index] if self.target_index is not None
                 else phys[:, self.z_index])
        else:
            t = target if target.ndim == 1 else target[:, 0]
        self.target_agg.add(results, np.clip(t, 0.0, 1.0), "all")
        c = np.asarray(c)
        if c.ndim == 1:  # detector channel ids → (x, y)
            seg = c.astype(np.int64) // 2
            x, y = seg % NX, seg // NX
        else:
            x, y = c[:, 0].astype(np.int64), c[:, 1].astype(np.int64)
        self.accumulate("det_metric", results, (x, y))

    def add_batch(self, block, db, test_out) -> None:
        """One test batch: ``db`` the host arrays ``prepare_block`` made,
        ``test_out`` the per-row outputs over at least the real rows."""
        mask = np.asarray(db["mask"], dtype=bool)
        if not mask.any():
            return
        c = np.asarray(db["det"] if "det" in db else db["coords"])[mask]
        self.add(c, np.asarray(db["feats"])[mask], np.asarray(db["labels"])[mask],
                 select_rows(test_out["loss_no_reduce"], mask))

    def dump(self) -> None:
        if self.logger is None:
            return
        if self.target_has_phys:
            self.pair.plot(self.logger)
        self.target_agg.plot(self.logger)
        self.log_segment_metric("det_metric", "metric_by_detector",
                                f"{self.metric_name} by detector segment")
