"""Per-segment energy evaluators (ref: src/evaluation/EnergyEvaluator.py).

E MAPE binned by (E, multiplicity), (E, z), and segment; calibration-E
baseline via light-curve inversion (E_basic_prediction*, ref :53-69);
WF and Phys variants (ref :127-181).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.evaluation.ad1 import SingleEndedEvaluator
from waveformml_tpu_torch.evaluation.metric_agg import Metric2DAggregator, MetricAggregator
from waveformml_tpu_torch.evaluation.stats import ErrorAggregator
from waveformml_tpu_torch.ops.calibration import E_basic_prediction
from waveformml_tpu_torch.ops.sparse import consecutive_event_index

N_MULT = 5


class EnergyEvaluatorBase(SingleEndedEvaluator):
    def __init__(self, logger=None, calgroup: Optional[str] = None,
                 e_scale=None, namespace=None, **kwargs):
        super().__init__(logger, calgroup=calgroup, e_scale=e_scale, **kwargs)
        if namespace:
            self.namespace = namespace
        cats = ["single ended", "double ended"]
        eb = self.default_bins[self.E_index]
        zb = self.default_bins[self.z_index]
        self.E_mape = MetricAggregator("energy", eb[0], eb[1], 50, cats,
                                       metric_name="E MAPE", metric_unit="%",
                                       parameter_unit="MeV", scale_factor=100.0)
        self.mult_mape = MetricAggregator("multiplicity", 0.5, N_MULT + 0.5, N_MULT,
                                          cats, metric_name="E MAPE",
                                          metric_unit="%", scale_factor=100.0)
        self.z_mape = MetricAggregator("cal_z", zb[0], zb[1], 50, cats,
                                       metric_name="E MAPE", metric_unit="%",
                                       parameter_unit="mm", scale_factor=100.0)
        self.Ez_2d = Metric2DAggregator("energy", "z", (eb[0], eb[1], 25),
                                        (zb[0], zb[1], 25), cats,
                                        metric_name="E MAPE", metric_unit="%",
                                        scale_factor=100.0)
        self.error = ErrorAggregator("E", 0.0, 1.0, 50, cats, metric_name="E",
                                     metric_unit="MeV", scale_factor=self.E_scale)
        self.register_segment_metric("seg_mape", "E MAPE", "%")
        self._has_cal = self.hascal
        if self._has_cal:
            self.E_mape_cal = MetricAggregator(
                "energy_cal", eb[0], eb[1], 50, cats, metric_name="E MAPE (cal)",
                metric_unit="%", scale_factor=100.0)

    def add(self, predictions, target, c, f=None, z_pred=None) -> None:
        """predictions/target dense [B, 1, NX, NY] normalized E. ``z_pred``
        is the NN z prediction — it feeds the cal-E baseline (ref
        EZEvaluator.py:39-54 builds E_basic_prediction from the NN z). The
        z BINNING of the MAPE uses the CALIBRATION z estimate when a
        calgroup is available (ref EnergyEvaluator.py:127-180 bins
        E_deviation_with_z by z_E_from_cal / z_basic_prediction output),
        falling back to the NN z without one."""
        x = c[:, 0].astype(np.int64)
        y = c[:, 1].astype(np.int64)
        b = consecutive_event_index(c[:, 2])
        pred = predictions[b, 0, x, y]
        targ = target[b, 0, x, y]
        nonzero = targ != 0
        ape = np.zeros_like(targ)
        ape[nonzero] = np.abs(pred[nonzero] - targ[nonzero]) / targ[nonzero]
        is_se = self.seg_status[x, y] == 0.5
        mult = np.bincount(b)[b]
        mult_cat = np.clip(mult, 1, N_MULT).astype(np.float64)
        E_true = targ * self.E_scale
        z_bins = self.z_for_bins(c, f)
        if z_bins is not None:
            z_rows = z_bins[b, x, y]
        elif z_pred is not None:
            z_rows = z_pred[b, x, y]
        else:
            z_rows = None
        z_val = ((z_rows - 0.5) * self.z_scale if z_rows is not None
                 else None)
        for se_val, cat in ((True, "single ended"), (False, "double ended")):
            sel = (is_se == se_val) & nonzero
            if not sel.any():
                continue
            self.E_mape.add(ape[sel], E_true[sel], cat)
            self.mult_mape.add(ape[sel], mult_cat[sel], cat)
            if z_val is not None:
                self.z_mape.add(ape[sel], z_val[sel], cat)
                self.Ez_2d.add(ape[sel], E_true[sel], z_val[sel], cat)
            self.error.add_norm(pred[sel], targ[sel], cat)
        self.accumulate("seg_mape", ape[nonzero], (x[nonzero], y[nonzero]))
        if self._has_cal:
            z_rows_nn = z_pred[b, x, y] if z_pred is not None else None
            cal_pred = self.E_from_cal(c, pred, targ, z_rows_nn)
            if cal_pred is not None:
                cal_ape = np.zeros_like(targ)
                cal_ape[nonzero] = np.abs(cal_pred[nonzero] - targ[nonzero]) / targ[nonzero]
                for se_val, cat in ((True, "single ended"), (False, "double ended")):
                    sel = (is_se == se_val) & nonzero
                    if sel.any():
                        self.E_mape_cal.add(cal_ape[sel], E_true[sel], cat)

    def z_for_bins(self, c, f):
        """Dense [B, NX, NY] calibration z used to bin the MAPE; variants
        override (WF: waveform calibration chain, Phys: z feature +
        diagonal fill). None → fall back to the NN z."""
        return None

    def E_from_cal(self, c, pred, targ, z_rows):
        """Light-curve-inversion baseline (ref :53-69); needs PE info — phys
        variant overrides. ``z_rows`` is the NN z per row (may be None)."""
        return None

    def add_batch(self, block, db, test_out) -> None:
        """One test batch: ``db`` the host arrays ``prepare_block`` made,
        ``test_out`` the dense ``[B, C, NX, NY]`` predictions and targets
        over at least the batch's real events."""
        mask = np.asarray(db["mask"], dtype=bool)
        if not mask.any():
            return
        self.add(np.asarray(test_out["predictions"]), np.asarray(test_out["target"]),
                 np.asarray(db["coords"])[mask], np.asarray(db["feats"])[mask])

    def dump(self) -> None:
        if self.logger is None:
            return
        self.E_mape.plot(self.logger)
        self.mult_mape.plot(self.logger)
        self.z_mape.plot(self.logger)
        self.Ez_2d.plot(self.logger)
        self.error.plot(self.logger)
        self.log_segment_metric("seg_mape", "E_mape_segment", "E MAPE by segment")
        if self._has_cal:
            self.E_mape_cal.plot(self.logger)
        self._dump_summary()

    def _dump_summary(self) -> None:
        """Summary scalars + the combined per-multiplicity figure
        (ref: EnergyEvaluator.py:94-121 single/dual_E_MAPE +
        E_error_summary_mult)."""
        from waveformml_tpu_torch.utils.plot import plot_lines

        def overall(agg, ci):
            cnt = agg.count[ci].sum()
            return float((agg.mean[ci] * agg.count[ci]).sum() / cnt
                         * agg.scale_factor) if cnt > 0 else None

        for ci, key in ((0, "single"), (1, "dual")):
            v = overall(self.E_mape, ci)
            if v is not None:
                self.logger.log_scalar(self.namespace + f"{key}_E_MAPE", v, 0)
            if self._has_cal:
                vc = overall(self.E_mape_cal, ci)
                if vc is not None:
                    self.logger.log_scalar(
                        self.namespace + f"{key}_E_MAPE_cal", vc, 0)
        m = self.mult_mape
        present = [ci for ci in range(len(m.class_names))
                   if m.count[ci].sum() > 0]
        if present:
            mults = np.arange(1, N_MULT + 1)
            self.logger.log_figure(
                self.namespace + "E_error_summary_mult",
                plot_lines(mults,
                           [m.mean[ci][1:-1] * m.scale_factor for ci in present],
                           [m.class_names[ci] for ci in present],
                           "multiplicity", "E MAPE [%]"))


class EnergyEvaluatorWF(EnergyEvaluatorBase):
    """Waveform-feature variant (ref :127-146): with a calgroup, the
    calibration chain over the raw waveforms provides BOTH the z binning
    and the cal-E baseline (ref z_E_from_cal feeding
    calc_deviation_with_z)."""

    def add(self, predictions, target, c, f=None, z_pred=None, **kwargs) -> None:
        self._zE_cache = None
        if self.hascal and f is not None:
            from waveformml_tpu_torch.ops.calibration import calc_calib_z_E

            n_samples = f.shape[1] // 2
            b = consecutive_event_index(c[:, 2])
            B = int(b[-1]) + 1 if len(b) else 0
            Z = np.full((B, NX, NY), 0.0)
            E = np.zeros((B, NX, NY))
            coords3 = np.stack([c[:, 0], c[:, 1], b], axis=1).astype(np.int64)
            calc_calib_z_E(coords3, np.asarray(f, dtype=np.float64), Z, E,
                           self.calibrator.tables(), self.z_scale, n_samples)
            self._zE_cache = (Z, E)
        super().add(predictions, target, c, f, z_pred=z_pred)

    def z_for_bins(self, c, f):
        return self._zE_cache[0] if getattr(self, "_zE_cache", None) else None

    def E_from_cal(self, c, pred, targ, z_rows):
        if not getattr(self, "_zE_cache", None):
            return None
        E = self._zE_cache[1]
        b = consecutive_event_index(c[:, 2])
        rows = E[b, c[:, 0].astype(np.int64), c[:, 1].astype(np.int64)]
        return rows / self.E_scale


class EnergyEvaluatorPhys(EnergyEvaluatorBase):
    """Phys-feature variant with the calibrated-E baseline from PE features
    (ref :148-181)."""

    def __init__(self, logger=None, calgroup=None, e_scale=None, namespace=None,
                 **kwargs):
        super().__init__(logger, calgroup=calgroup, e_scale=e_scale,
                         namespace=namespace, **kwargs)
        self._last_feats: Optional[np.ndarray] = None

    def add(self, predictions, target, c, f=None, z_pred=None, **kwargs) -> None:
        self._last_feats = f
        super().add(predictions, target, c, f, z_pred=z_pred)

    def z_for_bins(self, c, f):
        """Calibration z from the phys z feature with single-ended sites
        filled from diagonal neighbors (ref :159-178 z_basic_prediction)."""
        if f is None or not self.hascal:
            return None
        from waveformml_tpu_torch.ops.calibration import z_basic_prediction

        b = consecutive_event_index(c[:, 2])
        B = int(b[-1]) + 1 if len(b) else 0
        z = np.asarray(f)[:, self.z_index].astype(np.float64)
        pred = np.zeros_like(z)
        z_basic_prediction(c.astype(np.int64), z, pred)
        out = np.zeros((B, NX, NY))
        out[b, c[:, 0].astype(np.int64), c[:, 1].astype(np.int64)] = pred
        return out

    def E_from_cal(self, c, pred, targ, z_rows):
        if self._last_feats is None or not self.hascal or z_rows is None:
            return None
        f = self._last_feats
        x = c[:, 0].astype(np.int64)
        y = c[:, 1].astype(np.int64)
        E = f[:, self.E_index] * self.E_scale
        PE0 = f[:, self.PE0_index] * self.PE_scale
        PE1 = f[:, self.PE1_index] * self.PE_scale
        z_mm = (z_rows - 0.5) * self.z_scale
        out = np.zeros_like(E)
        cal = self.calibrator
        E_basic_prediction(np.stack([x, y, c[:, 2]], axis=1), E, PE0, PE1, z_mm,
                           self.seg_status, cal.light_pos_curves.astype(np.float64),
                           cal.light_sum_curves.astype(np.float64), out)
        return out / self.E_scale
