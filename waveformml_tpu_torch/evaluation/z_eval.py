"""Per-segment Z evaluators (ref: src/evaluation/ZEvaluator.py, 754 LoC).

MAE binned by (segment, multiplicity), z, and E; single- vs double-ended
split; per-sample error histograms; and the classical-calibration baseline
(``*_cal`` metrics via ops.calibration.calc_calib_z_E) computed alongside the
NN predictions when a calgroup is available (ref :126-139, :414-451, :502-526).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.evaluation.ad1 import SingleEndedEvaluator
from waveformml_tpu_torch.evaluation.metric_agg import MetricAggregator
from waveformml_tpu_torch.evaluation.stats import ErrorAggregator
from waveformml_tpu_torch.ops.calibration import calc_calib_z_E
from waveformml_tpu_torch.ops.dsp import get_bin_index
from waveformml_tpu_torch.ops.sparse import consecutive_event_index
from waveformml_tpu_torch.utils.util import get_bin_midpoints, get_bins, safe_divide

N_MULT = 5  # multiplicity categories 1..4 and 5+ (ref: _init_results)
NMULT_REF = 6          # ref ZEvaluatorBase.nmult (ZEvaluator.py:29)
SAMPLE_SEGS = np.array([[5, 4], [10, 3], [7, 5]], dtype=np.int64)  # ref :93


# reference binning (0 = underflow, n+1 = overflow, exact edges promote):
# one implementation in ops.dsp, shared here (ref SparseUtils.py:1275-1284)
_bin_index = get_bin_index


class ZDeviationAccumulator:
    """Vectorized equivalent of the reference's z_deviation_with_E + z_error
    numba kernels (ref SparseUtils.py:1260-1419, 1422-1456): per-segment ×
    multiplicity MAE, (z, mult) and (E, mult) binned MAE split single/dual
    ended, and per-sample-segment signed error histograms."""

    def __init__(self, nmult: int = NMULT_REF, n_bins: int = 20,
                 n_err_bins: int = 50, z_scale: float = 1200.0,
                 E_low: float = 0.0, E_high: float = 10.0,
                 error_low: float = -1000.0, error_high: float = 1000.0):
        self.nmult, self.n_bins, self.n_err_bins = nmult, n_bins, n_err_bins
        self.z_scale = z_scale
        self.E_low, self.E_high = E_low, E_high
        self.error_low, self.error_high = error_low, error_high
        self.seg_mult = (np.zeros((NX, NY, nmult + 1)),
                         np.zeros((NX, NY, nmult + 1), np.int64))
        mk = lambda: (np.zeros((n_bins + 2, nmult + 1)),
                      np.zeros((n_bins + 2, nmult + 1), np.int64))
        self.z_mult = {"single": mk(), "dual": mk()}
        self.E_mult = {"single": mk(), "dual": mk()}
        self.seg_sample_error = np.zeros(
            (len(SAMPLE_SEGS), nmult + 1, n_err_bins + 2), np.int64)

    @property
    def z_bin_edges(self):
        return get_bins(-self.z_scale / 2, self.z_scale / 2, self.n_bins)

    @property
    def E_bin_edges(self):
        return get_bins(self.E_low, self.E_high, self.n_bins)

    @property
    def mult_bin_edges(self):
        return get_bins(0.5, self.nmult + 0.5, self.nmult)

    @property
    def z_err_edges(self):
        return get_bins(self.error_low, self.error_high, self.n_err_bins)

    def add(self, pred: np.ndarray, targ: np.ndarray, x: np.ndarray,
            y: np.ndarray, mult: np.ndarray, is_single: np.ndarray,
            E: Optional[np.ndarray] = None) -> None:
        err = np.abs(pred - targ)
        mcat = np.where((mult >= 1) & (mult <= self.nmult), mult - 1, self.nmult)
        true_z = (targ - 0.5) * self.z_scale
        z_bin = _bin_index(true_z, -self.z_scale / 2, self.z_scale / 2, self.n_bins)
        np.add.at(self.seg_mult[0], (x, y, mcat), err)
        np.add.at(self.seg_mult[1], (x, y, mcat), 1)
        for sel, name in ((is_single, "single"), (~is_single, "dual")):
            if sel.any():
                np.add.at(self.z_mult[name][0], (z_bin[sel], mcat[sel]), err[sel])
                np.add.at(self.z_mult[name][1], (z_bin[sel], mcat[sel]), 1)
                if E is not None:
                    e_bin = _bin_index(E[sel], self.E_low, self.E_high, self.n_bins)
                    np.add.at(self.E_mult[name][0], (e_bin, mcat[sel]), err[sel])
                    np.add.at(self.E_mult[name][1], (e_bin, mcat[sel]), 1)
        signed = (pred - targ) * self.z_scale
        err_bin = _bin_index(signed, self.error_low, self.error_high,
                             self.n_err_bins)
        for si, (sx, sy) in enumerate(SAMPLE_SEGS):
            sel = (x == sx) & (y == sy)
            if sel.any():
                np.add.at(self.seg_sample_error, (si, mcat[sel], err_bin[sel]), 1)

    def summary(self, which: str) -> Tuple[float, list]:
        """(overall MAE [mm], per-mult MAE list [mm]) for 'single'/'dual'."""
        dev, cnt = self.z_mult[which]
        total = float(safe_divide(dev.sum(), cnt.sum())) * self.z_scale
        per_mult = [float(safe_divide(dev[:, m].sum(), cnt[:, m].sum()))
                    * self.z_scale for m in range(self.nmult)]
        return total, per_mult

    def mae_vs_E(self, which: str) -> list:
        dev, cnt = self.E_mult[which]
        return [float(safe_divide(dev[i, :].sum(), cnt[i, :].sum())) * self.z_scale
                for i in range(1, self.n_bins + 1)]


class ZEvaluatorBase(SingleEndedEvaluator):
    """Common accumulators + dump (ref: ZEvaluator.py:24-424)."""

    def __init__(self, logger=None, calgroup: Optional[str] = None,
                 e_scale=None, **kwargs):
        super().__init__(logger, calgroup=calgroup, e_scale=e_scale, **kwargs)
        cats = ["single ended", "double ended"]
        zb = self.default_bins[self.z_index]
        eb = self.default_bins[self.E_index]
        self.z_mae = MetricAggregator("true_z", zb[0], zb[1], 50, cats,
                                      metric_name="z MAE", metric_unit="mm",
                                      parameter_unit="mm", scale_factor=self.z_scale)
        self.E_mae = MetricAggregator("energy", eb[0], eb[1], 50, cats,
                                      metric_name="z MAE", metric_unit="mm",
                                      parameter_unit="MeV", scale_factor=self.z_scale)
        self.mult_mae = MetricAggregator("multiplicity", 0.5, N_MULT + 0.5, N_MULT,
                                         cats, metric_name="z MAE",
                                         metric_unit="mm",
                                         scale_factor=self.z_scale)
        self.error = ErrorAggregator("z", 0.0, 1.0, 50, cats, metric_name="z",
                                     metric_unit="mm", scale_factor=self.z_scale)
        self.register_segment_metric("seg_mae", "z MAE", "mm",
                                     n_extra=N_MULT, extra_bins=(0.5, N_MULT + 0.5, N_MULT))
        # full-depth reference accumulators (ZEvaluator.py:93-125): segment ×
        # mult MAE, (z|E) × mult single/dual MAE, sample-segment error hists —
        # one for the NN and a parallel one for the calibration baseline
        self.dev = ZDeviationAccumulator(z_scale=self.z_scale)
        self._has_cal_metrics = False
        if self.hascal:
            self.z_mae_cal = MetricAggregator(
                "true_z_cal", zb[0], zb[1], 50, cats, metric_name="z MAE (cal)",
                metric_unit="mm", parameter_unit="mm", scale_factor=self.z_scale)
            self.dev_cal = ZDeviationAccumulator(z_scale=self.z_scale)
            self._has_cal_metrics = True

    # -- core accumulation ---------------------------------------------------------
    def add(self, predictions: np.ndarray, target: np.ndarray, c: np.ndarray,
            f: Optional[np.ndarray] = None, E: Optional[np.ndarray] = None,
            additional_fields=None, target_is_cal: bool = False) -> None:
        """predictions/target: dense [B, 1, NX, NY] normalized z; c: [N, 3]."""
        x = c[:, 0].astype(np.int64)
        y = c[:, 1].astype(np.int64)
        b = consecutive_event_index(c[:, 2])
        pred = predictions[b, 0, x, y]
        targ = target[b, 0, x, y]
        err = np.abs(pred - targ)
        is_se = self.seg_status[x, y] == 0.5
        mult = np.bincount(b)[b]
        mult_cat = np.clip(mult, 1, N_MULT).astype(np.float64)
        z_true = (targ - 0.5) * self.z_scale
        # compute the calibration baseline FIRST: its cal_E stands in for a
        # missing true E in the NN accumulators too (ref ZEvaluatorWF.add
        # sets E = z_from_cal(...)'s cal_E before the NN
        # z_deviation_with_E, ZEvaluator.py:543-555)
        cal = None
        if self._has_cal_metrics and f is not None:
            cal = self.z_from_cal(c, f, target)
        cal_z = cal_E = cal_sep = None
        if cal is not None:
            cal_sep = cal if isinstance(cal, dict) else None
            if cal_sep is not None:
                cal_z, cal_E = cal_sep["z"], cal_sep.get("E")
            else:
                cal_z, cal_E = cal if isinstance(cal, tuple) else (cal, None)
        E_rows = E if E is not None else (
            cal_E[b, x, y] if cal_E is not None else None)
        for se_val, cat in ((True, "single ended"), (False, "double ended")):
            sel = is_se == se_val
            if not sel.any():
                continue
            self.z_mae.add(err[sel], z_true[sel], cat)
            self.mult_mae.add(err[sel], mult_cat[sel], cat)
            if E_rows is not None:
                self.E_mae.add(err[sel], E_rows[sel], cat)
            self.error.add_norm(pred[sel], targ[sel], cat)
        self.accumulate("seg_mae", err, (x, y, mult_cat))
        # ref increments single for any seg_status > 0 (SE or dead)
        is_single = self.seg_status[x, y] > 0
        self.dev.add(pred, targ, x, y, mult, is_single, E=E_rows)
        if cal is not None:
            if target_is_cal:
                # real data (ref: ZEvaluator.py:513-517): targets ARE the
                # calibration z at dual-ended segments, so the baseline is
                # the diagonal-neighbor mean fill of DE targets — exact
                # (zero-error) at DE sites, interpolated at SE sites
                from waveformml_tpu_torch.ops.calibration import \
                    z_basic_prediction_dense

                B = target.shape[0]
                densez = np.full((B, NX, NY), 0.5)
                de = self.seg_status != 0.5  # DE + dead (ref :514)
                densez[:, de] = target[:, 0, de]
                coords3 = np.stack([x, y, b], axis=1).astype(np.int64)
                z_basic_prediction_dense(coords3, densez, target[:, 0],
                                         truth_is_cal=True)
                cal_z = densez
            cal_pred = cal_z[b, x, y]
            cal_err = np.abs(cal_pred - targ)
            for se_val, cat in ((True, "single ended"), (False, "double ended")):
                sel = is_se == se_val
                if sel.any():
                    self.z_mae_cal.add(cal_err[sel], z_true[sel], cat)
            self.dev_cal.add(cal_pred, targ, x, y, mult, is_single, E=E_rows)
            if cal_sep is not None and not target_is_cal:
                # separated classical baselines (dt-only / light-ratio-only
                # z, the two methods peak_to_z combines — ref :797-845)
                if not hasattr(self, "dev_cal_dt"):
                    self.dev_cal_dt = ZDeviationAccumulator(z_scale=self.z_scale)
                    self.dev_cal_light = ZDeviationAccumulator(z_scale=self.z_scale)
                self.dev_cal_dt.add(cal_sep["z_dt"][b, x, y], targ, x, y,
                                    mult, is_single, E=E_rows)
                self.dev_cal_light.add(cal_sep["z_light"][b, x, y], targ,
                                       x, y, mult, is_single, E=E_rows)

    def z_from_cal(self, c, f, targ, E=None):
        return None

    # -- trainer adapter -----------------------------------------------------------
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
        self.z_mae.plot(self.logger)
        self.E_mae.plot(self.logger)
        self.mult_mae.plot(self.logger)
        self.error.plot(self.logger)
        self.log_segment_metric("seg_mae", "z_mae_segment", "z MAE by segment")
        if self._has_cal_metrics:
            self.z_mae_cal.plot(self.logger)
        self._retrieve_error_metrics()
        self._dump_deviation(self.dev, prefix="")
        if self._has_cal_metrics:
            self._dump_deviation(self.dev_cal, prefix="cal_")

    def _retrieve_error_metrics(self) -> None:
        """Summary scalars + NN-vs-cal MultiLine figures
        (ref: ZEvaluator.py:140-230 retrieve_error_metrics)."""
        from waveformml_tpu_torch.utils.plot import plot_lines

        single, single_mult = self.dev.summary("single")
        dual, dual_mult = self.dev.summary("dual")
        self.logger.log_scalar(self.namespace + "single_mae", single, 0)
        self.logger.log_scalar(self.namespace + "dual_mae", dual, 0)
        mults = list(range(1, self.dev.nmult + 1))
        # per-multiplicity MAE scalar SERIES, one point per global_step=mult
        # (ref: ZEvaluator.py:165-204) — in addition to the summary figures
        for m in range(self.dev.nmult):
            self.logger.log_scalar(self.namespace + "single_mae_mult",
                                   single_mult[m], m + 1)
            self.logger.log_scalar(self.namespace + "dual_mae_mult",
                                   dual_mult[m], m + 1)
        if self._has_cal_metrics:
            single_cal, single_mult_cal = self.dev_cal.summary("single")
            dual_cal, dual_mult_cal = self.dev_cal.summary("dual")
            self.logger.log_scalar(self.namespace + "single_mae_cal", single_cal, 0)
            self.logger.log_scalar(self.namespace + "dual_mae_cal", dual_cal, 0)
            for m in range(self.dev.nmult):
                self.logger.log_scalar(self.namespace + "single_mae_mult_cal",
                                       single_mult_cal[m], m + 1)
                self.logger.log_scalar(self.namespace + "dual_mae_mult_cal",
                                       dual_mult_cal[m], m + 1)
            # per-energy-bin MAE scalar series (ref :186-204, cal branch only)
            nn_E = {w: self.dev.mae_vs_E(w) for w in ("single", "dual")}
            cal_E = {w: self.dev_cal.mae_vs_E(w) for w in ("single", "dual")}
            for i in range(self.dev.n_bins):
                self.logger.log_scalar(self.namespace + "single_mae_E",
                                       nn_E["single"][i], i + 1)
                self.logger.log_scalar(self.namespace + "dual_mae_E",
                                       nn_E["dual"][i], i + 1)
                self.logger.log_scalar(self.namespace + "single_mae_E_cal",
                                       cal_E["single"][i], i + 1)
                self.logger.log_scalar(self.namespace + "dual_mae_E_cal",
                                       cal_E["dual"][i], i + 1)
            self.logger.log_figure(
                self.namespace + "z_error_summary_mult",
                plot_lines(mults, [single_mult, dual_mult, single_mult_cal,
                                   dual_mult_cal],
                           ["single NN", "dual NN", "single cal", "dual cal"],
                           "multiplicity", "MAE [mm]"))
            centers = get_bin_midpoints(self.dev.E_low, self.dev.E_high,
                                        self.dev.n_bins)
            for which, title in (("single", "Single Ended"), ("dual", "Dual Ended")):
                self.logger.log_figure(
                    self.namespace + f"z_error_summary_E_{which}",
                    plot_lines(centers,
                               [nn_E[which], cal_E[which]],
                               ["NN", "calibration"],
                               "Visible Energy [MeV]", "MAE [mm]",
                               title=title))
            if hasattr(self, "dev_cal_dt"):
                # separated classical baselines: dt-only z vs light-ratio-only
                # z beside the combined calibration and the NN
                _, sm_dt = self.dev_cal_dt.summary("single")
                _, dm_dt = self.dev_cal_dt.summary("dual")
                _, sm_li = self.dev_cal_light.summary("single")
                _, dm_li = self.dev_cal_light.summary("dual")
                self.logger.log_figure(
                    self.namespace + "z_error_summary_mult_baselines",
                    plot_lines(mults,
                               [single_mult, dual_mult, sm_dt, dm_dt,
                                sm_li, dm_li],
                               ["single NN", "dual NN", "single dt-z",
                                "dual dt-z", "single light-z", "dual light-z"],
                               "multiplicity", "MAE [mm]"))
                for name, dev_sep in (("dt", self.dev_cal_dt),
                                      ("light", self.dev_cal_light)):
                    s_tot, _ = dev_sep.summary("single")
                    d_tot, _ = dev_sep.summary("dual")
                    self.logger.log_scalar(
                        self.namespace + f"single_mae_cal_{name}", s_tot, 0)
                    self.logger.log_scalar(
                        self.namespace + f"dual_mae_cal_{name}", d_tot, 0)
        else:
            self.logger.log_figure(
                self.namespace + "error_summary_mult",
                plot_lines(mults, [single_mult, dual_mult],
                           ["single NN", "dual NN"], "multiplicity", "MAE [mm]"))

    def _dump_deviation(self, dev: ZDeviationAccumulator, prefix: str) -> None:
        """Per-mult segment matrices, sample-segment error hists, and the
        (z|E) × mult total/MAE 2D maps (ref: ZEvaluator.py:232-415 dump)."""
        from waveformml_tpu_torch.utils.plot import (plot_hist1d, plot_hist2d,
                                               plot_segment_matrix)

        for m in range(dev.nmult):
            for j, (sx, sy) in enumerate(SAMPLE_SEGS):
                counts = dev.seg_sample_error[j, m, 1:dev.n_err_bins + 1]
                if counts.sum() == 0:
                    continue
                self.logger.log_figure(
                    self.namespace + f"{prefix}z_seg_{sx + 1}_{sy + 1}_mult_{m + 1}_error",
                    plot_hist1d(dev.z_err_edges, counts,
                                xlabel="z error [mm]", ylabel="total / bin",
                                title=f"segment {sx + 1},{sy + 1} mult {m + 1}"))
            if dev.seg_mult[1][:, :, m].sum() > 0:
                self.logger.log_figure(
                    self.namespace + f"{prefix}z_seg_mult_{m + 1}_mae",
                    plot_segment_matrix(
                        dev.z_scale * safe_divide(dev.seg_mult[0][:, :, m],
                                                  dev.seg_mult[1][:, :, m]),
                        title=f"mult = {m + 1}", label="z MAE [mm]"))
        for table, edges, xlab in ((dev.z_mult, dev.z_bin_edges, "Z [mm]"),
                                   (dev.E_mult, dev.E_bin_edges,
                                    "Visible Energy [MeV]")):
            kind = "z" if xlab.startswith("Z") else "E"
            for which in ("single", "dual"):
                devsum, cnt = table[which]
                if cnt.sum() == 0:
                    continue
                interior = (slice(1, dev.n_bins + 1), slice(0, dev.nmult))
                self.logger.log_figure(
                    self.namespace + f"{prefix}{kind}_mult_{which}",
                    plot_hist2d(edges, dev.mult_bin_edges, cnt[interior],
                                xlabel=xlab, ylabel="multiplicity",
                                title=f"Total - {which} ended"))
                self.logger.log_figure(
                    self.namespace + f"{prefix}{kind}_mult_mae_{which}",
                    plot_hist2d(edges, dev.mult_bin_edges,
                                safe_divide(devsum[interior],
                                            cnt[interior]) * dev.z_scale,
                                xlabel=xlab, ylabel="multiplicity",
                                title=f"MAE - {which} ended"))

    def metrics(self) -> Dict[str, float]:
        """Summary numbers (MAE in mm per SE/DE)."""
        out = {}
        for ci, cat in enumerate(self.z_mae.class_names):
            cnt = self.z_mae.count[ci].sum()
            if cnt > 0:
                out[f"z_mae_{cat.replace(' ', '_')}"] = float(
                    (self.z_mae.mean[ci] * self.z_mae.count[ci]).sum() / cnt
                    * self.z_scale)
        return out


class ZEvaluatorWF(ZEvaluatorBase):
    """Waveform-input variant: classical baseline runs the full peak chain
    (ref :486-563)."""

    def __init__(self, logger=None, calgroup=None, **kwargs):
        super().__init__(logger, calgroup=calgroup, **kwargs)
        self.n_samples: Optional[int] = None

    def z_from_cal(self, c, f, targ, E=None):
        if not self.hascal:
            return None
        n_samples = f.shape[1] // 2
        b = consecutive_event_index(c[:, 2])
        B = int(b[-1]) + 1 if len(b) else 0
        z_out = np.full((B, NX, NY), 0.0)
        E_out = np.zeros((B, NX, NY))
        # same fill as z_out (ref inits pred to zeros, ZEvaluator.py:503): a
        # both-PMTs-no-peak pulse must score identically under the combined
        # and the separated baselines
        z_dt = np.zeros((B, NX, NY))
        z_light = np.zeros((B, NX, NY))
        coords = np.stack([c[:, 0], c[:, 1], b], axis=1).astype(np.int64)
        calc_calib_z_E(coords, np.asarray(f, dtype=np.float64), z_out, E_out,
                       self.calibrator.tables(), self.z_scale, n_samples,
                       z_dt_out=z_dt, z_light_out=z_light)
        return {"z": z_out, "E": E_out, "z_dt": z_dt, "z_light": z_light}


class ZEvaluatorPhys(ZEvaluatorBase):
    """Phys-feature variant: baseline z is the calibration z feature itself
    (ref :426-484)."""

    def z_from_cal(self, c, f, targ, E=None):
        from waveformml_tpu_torch.ops.calibration import z_basic_prediction

        b = consecutive_event_index(c[:, 2])
        B = int(b[-1]) + 1 if len(b) else 0
        # the phys z feature carries 0.5 placeholders at single-ended
        # segments; the reference fills them from diagonal-neighbor rows
        # before using it as the baseline (ref :433-435)
        z = np.asarray(f)[:, self.z_index].astype(np.float64)
        pred = np.zeros_like(z)
        z_basic_prediction(c.astype(np.int64), z, pred)
        out = np.zeros((B, NX, NY))
        out[b, c[:, 0].astype(np.int64), c[:, 1].astype(np.int64)] = pred
        return out

    def add_batch(self, block, db, test_out) -> None:
        """As ``ZEvaluatorWF.add_batch``, with each row's energy from its
        phys features where they have the 7 columns."""
        mask = np.asarray(db["mask"], dtype=bool)
        if not mask.any():
            return
        feats = np.asarray(db["feats"])[mask]
        E = feats[:, self.E_index] * self.E_scale if feats.shape[1] >= 7 else None
        self.add(np.asarray(test_out["predictions"]), np.asarray(test_out["target"]),
                 np.asarray(db["coords"])[mask], feats, E=E)


class ZEvaluatorRealWFNorm(ZEvaluatorWF):
    """Real-data variant over WaveformNorm records (ref :565-754): targets are
    themselves calibration values; detector ids may replace pair coords."""

    def __init__(self, logger=None, calgroup=None, namespace=None, e_scale=None,
                 additional_field_names=None, **kwargs):
        super().__init__(logger, calgroup=calgroup, e_scale=e_scale, **kwargs)
        self.additional_field_names = additional_field_names or []

    def add(self, predictions, target, c, f=None, E=None, additional_fields=None,
            target_is_cal: bool = True) -> None:
        super().add(predictions, target, c, f, E=E,
                    additional_fields=additional_fields,
                    target_is_cal=target_is_cal)
