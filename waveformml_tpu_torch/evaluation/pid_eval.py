"""Per-segment PID evaluator (ref: src/evaluation/PIDEvaluator.py, 169 LoC).

PID bitmask → 5 classes (PID_MAP, ref :9-23); per-class accuracy vs energy /
PSD / multiplicity / z on single-ended segments only; SE/energy-binned
confusion matrices (ref :93-169).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from waveformml_tpu_torch.evaluation.ad1 import SingleEndedEvaluator, select_rows
from waveformml_tpu_torch.evaluation.metric_agg import MetricAggregator
from waveformml_tpu_torch.ops.dsp import confusion_accumulate, confusion_accumulate_1d
from waveformml_tpu_torch.ops.sparse import consecutive_event_index
from waveformml_tpu_torch.utils.plot import plot_confusion_matrix

#: PID bitmask → class index (ref: PIDEvaluator.py:9-16)
PID_MAP: Dict[int, int] = {1: 0, 4: 1, 6: 2, 256: 3, 258: 2, 512: 4}
PID_MAPPED_NAMES: Dict[int, str] = {0: "Ionization", 1: "Recoil",
                                    2: "Neutron Capture", 3: "Ingress", 4: "Muon"}


def retrieve_class_names_PIDS():
    """(class names, PID lists per class) (ref :25-37)."""
    class_names = list(PID_MAPPED_NAMES.values())
    class_pids: List[Optional[List[int]]] = [None] * len(class_names)
    for key, val in PID_MAP.items():
        if class_pids[val] is None:
            class_pids[val] = [key]
        else:
            class_pids[val].append(key)
    return class_names, class_pids


def map_pid(pid: np.ndarray) -> np.ndarray:
    out = np.full(pid.shape, -1, dtype=np.int64)
    for raw, cls in PID_MAP.items():
        out[pid == raw] = cls
    return out


class PIDEvaluator(SingleEndedEvaluator):
    def __init__(self, logger=None, calgroup=None, SE_only: bool = True, **kwargs):
        super().__init__(logger, calgroup=calgroup, **kwargs)
        self.SE_only = SE_only
        self.class_names = list(PID_MAPPED_NAMES.values())
        nc = len(self.class_names)
        self.acc_vs_E = MetricAggregator("energy", 0.0, self.E_scale, 25,
                                         self.class_names, metric_name="accuracy",
                                         parameter_unit="MeV")
        self.acc_vs_psd = MetricAggregator("PSD", 0.0, 0.6, 25, self.class_names,
                                           metric_name="accuracy")
        self.acc_vs_mult = MetricAggregator("multiplicity", 0.5, 5.5, 5,
                                            self.class_names, metric_name="accuracy")
        self.acc_vs_z = MetricAggregator("z", -self.z_scale / 2, self.z_scale / 2,
                                         25, self.class_names,
                                         metric_name="accuracy",
                                         parameter_unit="mm")
        self.confusion = np.zeros((nc, nc))
        self.confusion_vs_E = np.zeros((5 + 1, nc, nc))

    def add(self, coords: np.ndarray, labels: np.ndarray, predictions: np.ndarray,
            phys: Optional[np.ndarray] = None) -> None:
        """Per-row labels/predictions (already class indices)."""
        x = coords[:, 0].astype(np.int64)
        y = coords[:, 1].astype(np.int64)
        if self.SE_only:
            keep = self.seg_status[x, y] == 0.5
        else:
            keep = np.ones(len(coords), dtype=bool)
        if not keep.any():
            return
        lab = labels[keep].astype(np.int64)
        pred = predictions[keep].astype(np.int64)
        acc = (lab == pred).astype(np.float64)
        b = consecutive_event_index(coords[:, 2])
        mult = np.bincount(b)[b][keep].astype(np.float64)
        if phys is not None:
            E = phys[keep, self.E_index] * self.E_scale
            psd = phys[keep, self.PSD_index]
            z = (phys[keep, self.z_index] - 0.5) * self.z_scale
        else:
            E = psd = z = None
        for ci, cname in enumerate(self.class_names):
            sel = lab == ci
            if not sel.any():
                continue
            self.acc_vs_mult.add(acc[sel], np.clip(mult[sel], 1, 5), cname)
            if E is not None:
                self.acc_vs_E.add(acc[sel], E[sel], cname)
                self.acc_vs_psd.add(acc[sel], psd[sel], cname)
                self.acc_vs_z.add(acc[sel], z[sel], cname)
        confusion_accumulate(pred, lab, self.confusion)
        if E is not None:
            confusion_accumulate_1d(pred, lab, E, self.confusion_vs_E,
                                    (0.0, self.E_scale), 5)

    def add_batch(self, block, db, test_out) -> None:
        """One test batch: ``db`` the host arrays ``prepare_block`` made,
        ``test_out`` the per-row outputs over at least the real rows."""
        mask = np.asarray(db["mask"], dtype=bool)
        if not mask.any():
            return
        labels = np.asarray(db["labels_rows"])[mask]
        if labels.ndim == 2:
            labels = labels[:, 0]
        phys = np.asarray(db["extra_phys"])[mask] if "extra_phys" in db else None
        self.add(np.asarray(db["coords"])[mask], labels, select_rows(test_out["pred"], mask),
                 phys=phys)

    def dump(self) -> None:
        if self.logger is None:
            return
        for agg in (self.acc_vs_E, self.acc_vs_psd, self.acc_vs_mult, self.acc_vs_z):
            agg.plot(self.logger)
        if self.confusion.sum() > 0:
            self.logger.log_figure(self.namespace + "pid_confusion",
                                   plot_confusion_matrix(self.confusion,
                                                         self.class_names))
            # un-normalized counts (ref: PIDEvaluator.py:145 *_totals figures)
            self.logger.log_figure(
                self.namespace + "pid_confusion_totals",
                plot_confusion_matrix(self.confusion, self.class_names,
                                      normalize=False, title="Counts"))
        for e in range(5):
            if self.confusion_vs_E[e].sum() > 0:
                self.logger.log_figure(
                    self.namespace + f"pid_confusion_E{e}",
                    plot_confusion_matrix(self.confusion_vs_E[e], self.class_names))
                self.logger.log_figure(
                    self.namespace + f"pid_confusion_E{e}_totals",
                    plot_confusion_matrix(self.confusion_vs_E[e],
                                          self.class_names, normalize=False,
                                          title="Counts"))
