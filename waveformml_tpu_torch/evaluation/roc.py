"""One-vs-rest ROC from thresholded confusion counts
(ref: src/evaluation/ROCCurve.py:6-50 — a torchmetrics Metric accumulating 100
thresholded confusion matrices; here plain numpy accumulation)."""
from __future__ import annotations

from typing import Sequence

import numpy as np


class ROCCurve:
    def __init__(self, n_classes: int, n_thresholds: int = 100):
        self.n_classes = n_classes
        self.n_thresholds = n_thresholds
        self.thresholds = np.linspace(0.0, 1.0, n_thresholds)
        # per class, per threshold: TP, FP, FN, TN
        self.counts = np.zeros((n_classes, n_thresholds, 4), dtype=np.int64)

    def update(self, logits: np.ndarray, labels: np.ndarray) -> None:
        logits = np.asarray(logits, dtype=np.float64)
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        probs /= probs.sum(axis=1, keepdims=True)
        labels = np.asarray(labels).astype(np.int64)
        for c in range(self.n_classes):
            p = probs[:, c]
            is_pos = labels == c
            pred_pos = p[None, :] >= self.thresholds[:, None]  # [T, N]
            tp = (pred_pos & is_pos[None, :]).sum(axis=1)
            fp = (pred_pos & ~is_pos[None, :]).sum(axis=1)
            fn = (~pred_pos & is_pos[None, :]).sum(axis=1)
            tn = (~pred_pos & ~is_pos[None, :]).sum(axis=1)
            self.counts[c, :, 0] += tp
            self.counts[c, :, 1] += fp
            self.counts[c, :, 2] += fn
            self.counts[c, :, 3] += tn

    def compute(self):
        """Per class: (fpr [T], tpr [T]) sorted by threshold."""
        tp = self.counts[..., 0].astype(np.float64)
        fp = self.counts[..., 1].astype(np.float64)
        fn = self.counts[..., 2].astype(np.float64)
        tn = self.counts[..., 3].astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            tpr = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
            fpr = np.where(fp + tn > 0, fp / np.maximum(fp + tn, 1), 0.0)
        return fpr, tpr

    def auc(self) -> np.ndarray:
        fpr, tpr = self.compute()
        out = np.zeros(self.n_classes)
        for c in range(self.n_classes):
            # sort by (fpr, tpr) so tied-fpr points are in ascending-tpr order
            order = np.lexsort((tpr[c], fpr[c]))
            # np.trapezoid is numpy>=2 only; fall back on 1.x's np.trapz
            _trap = getattr(np, "trapezoid", None) or np.trapz
            out[c] = abs(float(_trap(tpr[c][order], fpr[c][order])))
        return out

    def plot(self, logger, class_names: Sequence[str], namespace: str = "evaluation/"):
        if self.counts.sum() == 0 or logger is None:
            return
        from waveformml_tpu_torch.utils.plot import plot_roc_curve

        fpr, tpr = self.compute()
        order = [np.argsort(fpr[c]) for c in range(self.n_classes)]
        logger.log_figure(namespace + "roc",
                          plot_roc_curve([fpr[c][order[c]] for c in range(self.n_classes)],
                                         [tpr[c][order[c]] for c in range(self.n_classes)],
                                         class_names))
