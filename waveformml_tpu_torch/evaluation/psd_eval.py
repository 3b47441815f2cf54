"""Event-classification evaluators (ref: src/evaluation/PSDEvaluator.py, 485 LoC).

``PSDEvaluator``: numba ``average_pulse`` summarized each event (summed
gain-corrected pulses, PSD l/r, dt, multiplicity, spreads, moments — here the
vectorized ops.dsp.average_pulse); accuracy binned vs energy / PSD /
multiplicity / position; per-energy and per-n_SE confusion matrices;
average-pulse figures; ROC/PR hooks (ref :101-253). ``PhysEvaluator``: the
same on phys features with energy-weighted averaging (ref :301-485).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from waveformml_tpu_torch.detector import MAX_RANGE, NX, NY
from waveformml_tpu_torch.evaluation.ad1 import SingleEndedEvaluator, select_rows
from waveformml_tpu_torch.evaluation.metric_agg import MetricAggregator
from waveformml_tpu_torch.evaluation.roc import ROCCurve
from waveformml_tpu_torch.ops.dsp import (
    average_pulse, confusion_accumulate, confusion_accumulate_1d,
    weighted_average_quantities)
from waveformml_tpu_torch.ops.sparse import consecutive_event_index
from waveformml_tpu_torch.utils.plot import plot_confusion_matrix, plot_waveforms

N_MULT = 5
N_E_CONF = 5  # energy-binned confusion slices


class PSDEvaluator(SingleEndedEvaluator):
    def __init__(self, class_names: Sequence[str], logger=None,
                 calgroup: Optional[str] = None, has_SE: bool = True, **kwargs):
        super().__init__(logger, calgroup=calgroup, **kwargs)
        self.class_names = list(class_names)
        nc = len(self.class_names)
        self.E_max = 10.0
        self.acc_vs_E = MetricAggregator("summed_energy", 0.0, self.E_max, 25,
                                         self.class_names,
                                         metric_name="accuracy")
        self.acc_vs_psd = MetricAggregator("PSD", 0.0, 0.6, 25, self.class_names,
                                           metric_name="accuracy")
        self.acc_vs_mult = MetricAggregator("multiplicity", 0.5, N_MULT + 0.5,
                                            N_MULT, self.class_names,
                                            metric_name="accuracy")
        self.acc_vs_x = MetricAggregator("x position", -0.5, NX - 0.5, NX,
                                         self.class_names, metric_name="accuracy")
        self.acc_vs_y = MetricAggregator("y position", -0.5, NY - 0.5, NY,
                                         self.class_names, metric_name="accuracy")
        # 2-D E x PSD and x x y accuracy surfaces (ref: PSDEvaluator.py
        # :202-216 energy_psd_accuracy / position_accuracy; the per-class
        # planes feed EPSD_classes + energy_psd_precision, ref :437-456)
        from waveformml_tpu_torch.evaluation.metric_agg import Metric2DAggregator

        self.acc_E_psd = Metric2DAggregator(
            "energy [MeV]", "PSD", (0.0, self.E_max, 25), (0.0, 0.6, 25),
            ["all"] + self.class_names, metric_name="accuracy")
        self.acc_pos = Metric2DAggregator(
            "x", "y", (-0.5, NX - 0.5, NX), (-0.5, NY - 0.5, NY), ["all"],
            metric_name="accuracy")
        self.confusion = np.zeros((nc, nc))
        self.confusion_vs_E = np.zeros((N_E_CONF + 1, nc, nc))
        self.confusion_vs_nSE = np.zeros((4, nc, nc))
        self.avg_pulse_sum = np.zeros((nc, 1))
        self.avg_pulse_n = np.zeros(nc)
        # predicted-class averages + grand total with Poisson errors
        # (ref: PSDEvaluator.py:223-233 average_pulses_labelled / pulse)
        self.labelled_pulse_sum = np.zeros((nc, 1))
        self.labelled_pulse_n = np.zeros(nc)
        self.total_pulse_sum = np.zeros((1,))
        self.total_pulse_n = 0.0
        # bounded sample reservoirs for the energy / per-class output
        # histograms (ref :136, :158)
        self._hist_cap = 100_000
        self._energy_samples: list = []
        self._output_samples: list = []
        self.roc = ROCCurve(nc)
        self._avg_initialized = False

    # -- accumulation --------------------------------------------------------------
    def add(self, coords: np.ndarray, pulses: np.ndarray, labels: np.ndarray,
            predictions: np.ndarray, logits: Optional[np.ndarray] = None) -> None:
        """coords [N, 3], pulses [N, 2S] (normalized), labels/predictions [B]."""
        c = coords.copy()
        c[:, 2] = consecutive_event_index(c[:, 2])
        B = labels.shape[0]
        gains = self.calibrator.gains if self.hascal else np.ones((NX, NY, 2))
        n_samples = pulses.shape[1] // 2
        times = np.arange(2, n_samples * 4 + 2, 4, dtype=np.float64)
        summary = average_pulse(c, pulses * MAX_RANGE, gains, times,
                                self.seg_status, B)
        summed_E = summary["pulses"].sum(axis=1) / MAX_RANGE
        psd = 0.5 * (summary["psdl"] + summary["psdr"])
        acc = (labels == predictions).astype(np.float64)
        if not self._avg_initialized:
            nc = len(self.class_names)
            self.avg_pulse_sum = np.zeros((nc, pulses.shape[1]))
            self.labelled_pulse_sum = np.zeros((nc, pulses.shape[1]))
            self.total_pulse_sum = np.zeros((pulses.shape[1],))
            self._avg_initialized = True
        self.total_pulse_sum += summary["pulses"].sum(axis=0)
        self.total_pulse_n += float(B)
        if sum(len(e) for e in self._energy_samples) < self._hist_cap:
            self._energy_samples.append(summed_E)
            if logits is not None:
                ex = np.exp(logits - logits.max(axis=1, keepdims=True))
                self._output_samples.append(ex / ex.sum(axis=1, keepdims=True))
        for ci, cname in enumerate(self.class_names):
            sel = labels == ci
            if not sel.any():
                continue
            self.acc_vs_E.add(acc[sel], summed_E[sel], cname)
            self.acc_vs_psd.add(acc[sel], psd[sel], cname)
            self.acc_vs_mult.add(acc[sel],
                                 np.clip(summary["multiplicity"][sel], 1, N_MULT),
                                 cname)
            self.acc_vs_x.add(acc[sel], summary["coords"][sel, 0], cname)
            self.acc_vs_y.add(acc[sel], summary["coords"][sel, 1], cname)
            self.avg_pulse_sum[ci] += summary["pulses"][sel].sum(axis=0)
            self.avg_pulse_n[ci] += sel.sum()
            sel_p = predictions == ci
            if sel_p.any():
                self.labelled_pulse_sum[ci] += summary["pulses"][sel_p].sum(axis=0)
                self.labelled_pulse_n[ci] += sel_p.sum()
            self.acc_E_psd.add(acc[sel], summed_E[sel], psd[sel], cname)
        self.acc_E_psd.add(acc, summed_E, psd, "all")
        self.acc_pos.add(acc, summary["coords"][:, 0], summary["coords"][:, 1],
                         "all")
        confusion_accumulate(predictions, labels, self.confusion)
        confusion_accumulate_1d(predictions, labels, summed_E,
                                self.confusion_vs_E, (0.0, self.E_max), N_E_CONF)
        n_se_cat = np.clip(summary["n_SE"], 0, 3)
        np.add.at(self.confusion_vs_nSE,
                  (n_se_cat, labels.astype(np.int64),
                   predictions.astype(np.int64)), 1)
        if logits is not None:
            self.roc.update(logits, labels)

    def add_batch(self, block, db, test_out) -> None:
        """One test batch: ``db`` the host arrays ``prepare_block`` made
        (padded, no device axis), ``test_out`` the task's test outputs over
        at least the batch's real events."""
        ymask = np.asarray(db["label_mask"], dtype=bool)
        if not ymask.any():
            return
        mask = np.asarray(db["mask"], dtype=bool)
        self.add(np.asarray(db["coords"])[mask], np.asarray(db["feats"])[mask],
                 np.asarray(db["labels"])[ymask], select_rows(test_out["pred"], ymask),
                 logits=select_rows(test_out["logits"], ymask))

    # -- rendering -----------------------------------------------------------------
    def dump(self) -> None:
        if self.logger is None:
            return
        for agg in (self.acc_vs_E, self.acc_vs_psd, self.acc_vs_mult,
                    self.acc_vs_x, self.acc_vs_y):
            agg.plot(self.logger)
        if self.confusion.sum() > 0:
            self.logger.log_figure(
                self.namespace + "confusion",
                plot_confusion_matrix(self.confusion, self.class_names))
            # un-normalized counts (ref: PSDEvaluator.py:247 *_totals)
            self.logger.log_figure(
                self.namespace + "confusion_totals",
                plot_confusion_matrix(self.confusion, self.class_names,
                                      normalize=False, title="Counts"))
        for e in range(N_E_CONF):
            if self.confusion_vs_E[e].sum() > 0:
                lo = e * self.E_max / N_E_CONF
                hi = (e + 1) * self.E_max / N_E_CONF
                self.logger.log_figure(
                    self.namespace + f"confusion_E_{lo:.0f}_{hi:.0f}",
                    plot_confusion_matrix(self.confusion_vs_E[e],
                                          self.class_names,
                                          title=f"E ∈ [{lo:.1f}, {hi:.1f}) MeV"))
        for k in range(4):
            if self.confusion_vs_nSE[k].sum() > 0:
                self.logger.log_figure(
                    self.namespace + f"confusion_nSE_{k}",
                    plot_confusion_matrix(self.confusion_vs_nSE[k],
                                          self.class_names,
                                          title=f"n_SE = {k}"))
        present = self.avg_pulse_n > 0
        if self._avg_initialized and present.any():
            wfs = [self.avg_pulse_sum[i] / self.avg_pulse_n[i]
                   for i in range(len(self.class_names)) if present[i]]
            names = [n for i, n in enumerate(self.class_names) if present[i]]
            self.logger.log_figure(self.namespace + "average_pulse",
                                   plot_waveforms(wfs, names))
            self.logger.log_figure(
                self.namespace + "average_pulse_normalized",
                plot_waveforms(wfs, names, normalize=True,
                               title="Average waveform (peak-normalized)"))
        lab_present = self.labelled_pulse_n > 0
        if self._avg_initialized and lab_present.any():
            wfs = [self.labelled_pulse_sum[i] / self.labelled_pulse_n[i]
                   for i in range(len(self.class_names)) if lab_present[i]]
            names = [n for i, n in enumerate(self.class_names) if lab_present[i]]
            self.logger.log_figure(
                self.namespace + "average_pulse_labelled",
                plot_waveforms(wfs, names,
                               title="Average waveform by predicted class"))
        if self._avg_initialized and self.total_pulse_n > 0:
            mean = self.total_pulse_sum / self.total_pulse_n
            err = np.sqrt(np.clip(self.total_pulse_sum, 0, None)) / self.total_pulse_n
            self.logger.log_figure(
                self.namespace + "pulse",
                plot_waveforms([mean], ["total"], errors=[err],
                               title="Total average waveform"))
        if self._energy_samples:
            self.logger.log_histogram(self.namespace + "energy",
                                      np.concatenate(self._energy_samples))
        if self._output_samples:
            outs = np.concatenate(self._output_samples, axis=0)
            for i, name in enumerate(self.class_names):
                self.logger.log_histogram(self.namespace + f"output_{name}",
                                          outs[:, i])
        self._dump_2d_surfaces()
        self.roc.plot(self.logger, self.class_names, self.namespace)

    def _dump_2d_surfaces(self) -> None:
        """The reference's 2-D figure set (ref: PSDEvaluator.py:402-476):
        E x PSD accuracy contour + totals, per-class planes, x x y accuracy,
        multiplicity totals, per-class precision curves."""
        from waveformml_tpu_torch.ops.dsp import safe_divide
        from waveformml_tpu_torch.utils.plot import (plot_contour, plot_hist1d,
                                               plot_hist2d, plot_lines,
                                               plot_n_contour, plot_n_hist2d)

        a2 = self.acc_E_psd
        i_all = a2.class_names.index("all")
        if a2.count[i_all].sum() > 0:
            xs = 0.5 * (a2.edges_x[:-1] + a2.edges_x[1:])
            ys = 0.5 * (a2.edges_y[:-1] + a2.edges_y[1:])
            acc = safe_divide(a2.total[i_all], a2.count[i_all])[1:-1, 1:-1]
            self.logger.log_figure(
                self.namespace + "energy_psd_accuracy",
                plot_contour(xs, ys, acc, "energy [MeV]", "PSD", "accuracy"))
            self.logger.log_figure(
                self.namespace + "EPSD",
                plot_hist2d(a2.edges_x, a2.edges_y,
                            a2.count[i_all][1:-1, 1:-1],
                            xlabel="Energy [MeV]", ylabel="PSD",
                            title="Total"))
            per_class = [ci for ci, n in enumerate(a2.class_names)
                         if n != "all" and a2.count[ci].sum() > 0]
            if per_class:
                names = [a2.class_names[ci] for ci in per_class]
                self.logger.log_figure(
                    self.namespace + "EPSD_classes",
                    plot_n_hist2d(a2.edges_x, a2.edges_y,
                                  [a2.count[ci][1:-1, 1:-1] for ci in per_class],
                                  names, xlabel="Energy [MeV]", ylabel="PSD"))
                self.logger.log_figure(
                    self.namespace + "energy_psd_precision",
                    plot_n_contour(xs, ys,
                                   [safe_divide(a2.total[ci],
                                                a2.count[ci])[1:-1, 1:-1]
                                    for ci in per_class],
                                   xlabel="Energy [MeV]", ylabel="PSD",
                                   titles=names))
        pos = self.acc_pos
        if pos.count[0].sum() > 0:
            self.logger.log_figure(
                self.namespace + "position_accuracy",
                plot_contour(np.arange(NX), np.arange(NY),
                             safe_divide(pos.total[0], pos.count[0])[1:-1, 1:-1],
                             "x", "y", "accuracy", filled=False))
        # multiplicity totals + per-class precision curves from the 1-D aggs
        # (MetricAggregator keeps Welford MEANS per bin, not sums)
        m = self.acc_vs_mult
        tot = m.count.sum(axis=0)[1:-1]
        if tot.sum() > 0:
            edges = np.linspace(0.5, N_MULT + 0.5, N_MULT + 1)
            self.logger.log_figure(
                self.namespace + "multiplicity",
                plot_hist1d(edges, tot, xlabel="Multiplicity", ylabel="total",
                            title="Total"))
            mults = np.arange(1, N_MULT + 1)
            present = [ci for ci in range(len(m.class_names))
                       if m.count[ci].sum() > 0]
            names = [m.class_names[ci] for ci in present]
            self.logger.log_figure(
                self.namespace + "multiplicity_precision",
                plot_lines(mults, [m.mean[ci][1:-1] for ci in present], names,
                           "multiplicity", "precision"))
            self.logger.log_figure(
                self.namespace + "multiplicity_classes",
                plot_lines(mults, [m.count[ci][1:-1] for ci in present], names,
                           "multiplicity", "total"))
        e = self.acc_vs_E
        if e.count.sum() > 0:
            centers = 0.5 * (e.bin_edges[:-1] + e.bin_edges[1:])
            present = [ci for ci in range(len(e.class_names))
                       if e.count[ci].sum() > 0]
            self.logger.log_figure(
                self.namespace + "energy_precision",
                plot_lines(centers, [e.mean[ci][1:-1] for ci in present],
                           [e.class_names[ci] for ci in present],
                           "energy [MeV]", "precision"))


class PhysEvaluator(PSDEvaluator):
    """Phys-feature analog with energy-weighted event averaging (ref :301-485)."""

    def add(self, coords, feats, labels, predictions, logits=None) -> None:
        c = coords.copy()
        c[:, 2] = consecutive_event_index(c[:, 2])
        B = labels.shape[0]
        # feats rows are phys 7-vectors; quantities matrix is [F, N]
        q = np.asarray(feats).T.astype(np.float64)
        out_c, out_q, out_m = weighted_average_quantities(c, q, B)
        summed_E = out_q[self.E_index] * self.E_scale
        psd = out_q[self.PSD_index]
        acc = (labels == predictions).astype(np.float64)
        if not self._avg_initialized:
            self.avg_pulse_sum = np.zeros((len(self.class_names), feats.shape[1]))
            self._avg_initialized = True
        for ci, cname in enumerate(self.class_names):
            sel = labels == ci
            if not sel.any():
                continue
            self.acc_vs_E.add(acc[sel], summed_E[sel], cname)
            self.acc_vs_psd.add(acc[sel], psd[sel], cname)
            self.acc_vs_mult.add(acc[sel], np.clip(out_m[sel], 1, N_MULT), cname)
            self.acc_vs_x.add(acc[sel], out_c[sel, 0], cname)
            self.acc_vs_y.add(acc[sel], out_c[sel, 1], cname)
            self.acc_E_psd.add(acc[sel], summed_E[sel], psd[sel], cname)
        self.acc_E_psd.add(acc, summed_E, psd, "all")
        self.acc_pos.add(acc, out_c[:, 0], out_c[:, 1], "all")
        if sum(len(x) for x in self._energy_samples) < self._hist_cap:
            self._energy_samples.append(summed_E)
            if logits is not None:
                ex = np.exp(logits - logits.max(axis=1, keepdims=True))
                self._output_samples.append(ex / ex.sum(axis=1, keepdims=True))
        confusion_accumulate(predictions, labels, self.confusion)
        confusion_accumulate_1d(predictions, labels, summed_E,
                                self.confusion_vs_E, (0.0, self.E_max), N_E_CONF)
        if logits is not None:
            self.roc.update(logits, labels)
