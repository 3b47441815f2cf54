"""The waveform-shape evaluator (counterpart of
waveformml_tpu/evaluation/waveform_eval.py): peak-aligned average
waveforms and the first samples' share binned by z, and, with
``wf_analysis``, |z − z_pred| against the first samples of both PMTs by z
bin; ``z_E_from_cal`` is the classical reconstruction. No task builds it;
it is exported for analyses that feed it themselves."""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.evaluation.ad1 import SingleEndedEvaluator
from waveformml_tpu_torch.ops.calibration import calc_calib_z_E
from waveformml_tpu_torch.ops.dsp import align_wfs, calc_arrival_batch
from waveformml_tpu_torch.ops.sparse import consecutive_event_index
from waveformml_tpu_torch.utils.plot import plot_waveforms
from waveformml_tpu_torch.utils.util import get_bins

N_Z_BINS = 10
N_FIRST = 5


class _NamespacedLogger:
    """A logger whose figure tags get ``prefix`` in front."""

    def __init__(self, logger, prefix: str):
        self._logger, self._prefix = logger, prefix

    def log_figure(self, tag, fig, *a, **k):
        self._logger.log_figure(self._prefix + tag, fig, *a, **k)

    def __getattr__(self, item):
        return getattr(self._logger, item)


class WaveformEvaluator(SingleEndedEvaluator):
    def __init__(self, logger=None, calgroup=None, align_target: int = 10, **kwargs):
        super().__init__(logger, calgroup=calgroup, **kwargs)
        self.align_target = align_target
        self.z_edges = get_bins(-self.z_scale / 2, self.z_scale / 2, N_Z_BINS)
        self._wf_sum: Optional[np.ndarray] = None
        self._wf_n = np.zeros(N_Z_BINS)
        self.first_sum = np.zeros((N_Z_BINS, N_FIRST))
        self.first_n = np.zeros(N_Z_BINS)
        # the JAX package tests the value (the reference tests the key's
        # presence, so wf_analysis=False would enable it there)
        self.analyze_waveforms = bool(kwargs.get("wf_analysis"))
        self.has_PID = False
        self.additional_field_names = list(kwargs.get("additional_field_names") or [])
        if "PID" in self.additional_field_names:
            self.PID_index = self.additional_field_names.index("PID")
            self.has_PID = True
        if self.analyze_waveforms:
            self._init_sample_metrics()

    def _init_sample_metrics(self) -> None:
        """A ``MetricPairAggregator`` of the first N_FIRST sample amplitudes
        per z bin (under, N_Z_BINS inside, over; by PID class where the
        rows carry one) and one over every z (category "any")."""
        from waveformml_tpu_torch.evaluation.metric_agg import (MetricAggregator,
                                                                MetricPairAggregator)

        if self.has_PID:
            from waveformml_tpu_torch.evaluation.pid_eval import PID_MAPPED_NAMES

            class_names = list(PID_MAPPED_NAMES.values())
        else:
            class_names = ["any"]
        self.z_binned_metric_pairs = []
        for zi in range(N_Z_BINS + 3):
            names = ["any"] if zi == N_Z_BINS + 2 else class_names
            metrics = [MetricAggregator(
                f"sample {i}", 1.0e-6, 0.01 * (i + 1), 100, names,
                metric_name="z", metric_unit="mae",
                parameter_unit="normalized ADC") for i in range(N_FIRST)]
            self.z_binned_metric_pairs.append(MetricPairAggregator(metrics))

    def add(self, wfs: np.ndarray, z_mm: np.ndarray) -> None:
        """``wfs`` normalised waveform pairs ``[N, 2S]``, ``z_mm`` each
        row's true z in mm: the first PMT's waveform aligned at its
        arrival, summed by z bin, and its first samples' share of its
        total."""
        n_samples = wfs.shape[1] // 2
        left = np.asarray(wfs[:, :n_samples], dtype=np.float64)
        arrivals = calc_arrival_batch(left)
        aligned = align_wfs(left, arrivals, self.align_target)
        if self._wf_sum is None:
            self._wf_sum = np.zeros((N_Z_BINS, n_samples))
        zi = np.clip(np.searchsorted(self.z_edges, z_mm) - 1, 0, N_Z_BINS - 1)
        np.add.at(self._wf_sum, zi, aligned)
        np.add.at(self._wf_n, zi, 1)
        first = aligned[:, self.align_target:self.align_target + N_FIRST]
        tot = aligned.sum(axis=1, keepdims=True)
        with np.errstate(invalid="ignore", divide="ignore"):
            frac = np.where(tot > 0, first / np.maximum(tot, 1e-12), 0.0)
        np.add.at(self.first_sum, zi, frac)
        np.add.at(self.first_n, zi, 1)

    def _align_first_samples(self, f: np.ndarray) -> np.ndarray:
        """Both PMTs' waveforms of each pair aligned at their arrival, the
        first N_FIRST samples: ``[N, 2, N_FIRST]``."""
        n_samples = f.shape[1] // 2
        pair = np.asarray(f, dtype=np.float64).reshape(f.shape[0], 2, n_samples)
        out = np.zeros((f.shape[0], 2, N_FIRST))
        for side in range(2):
            wf = pair[:, side]
            out[:, side] = align_wfs(wf, calc_arrival_batch(wf), 0)[:, :N_FIRST]
        return out

    def analyze_wf_z(self, wf: np.ndarray, c: np.ndarray, z: np.ndarray,
                     z_pred: np.ndarray, additional_fields=None) -> None:
        """With ``wf_analysis``: |z − z_pred| against the first-sample
        amplitudes of both PMTs' waveforms, per z bin and over every z, by
        PID class where the rows carry one (``additional_fields``)."""
        if not self.analyze_waveforms:
            return
        pid_split = self.has_PID
        if self.has_PID and additional_fields is not None:
            from waveformml_tpu_torch.evaluation.pid_eval import PID_MAPPED_NAMES, map_pid

            raw = np.asarray(additional_fields[self.PID_index])
            # as the reference: a batch holding class 3 (Ingress) counts as
            # mapped already
            class_indices = raw if 3 in raw else map_pid(raw)
            cat_of = dict(PID_MAPPED_NAMES)
        elif self.has_PID:
            # PID configured but the batch carries none: the per-z split is
            # undefined, so only the all-z aggregate takes the batch
            if not getattr(self, "_warned_missing_pid", False):
                self._warned_missing_pid = True
                logging.getLogger(__name__).warning(
                    "analyze_wf_z: PID configured but batch has no "
                    "additional_fields; skipping the per-z PID split")
            pid_split = False
            class_indices = np.zeros(c.shape[0], dtype=np.int64)
            cat_of = {}
        else:
            class_indices = np.zeros(c.shape[0], dtype=np.int64)
            cat_of = {0: "any"}
        wfs = np.transpose(self._align_first_samples(wf), (2, 1, 0))  # [S, 2, N]
        results = np.abs(np.asarray(z) - np.asarray(z_pred))
        inc = self.z_scale / N_Z_BINS
        lo = -self.z_scale / 2
        for side in range(2):
            self.z_binned_metric_pairs[-1].add(results, wfs[:, side], "any")
        for i in range(N_Z_BINS + 2):
            if i == 0:
                zsel = z <= lo
            elif i == N_Z_BINS + 1:
                zsel = z >= -lo
            elif i == N_Z_BINS:
                zsel = (z > lo + (i - 1) * inc) & (z < -lo)
            else:
                zsel = (z > lo + (i - 1) * inc) & (z <= lo + i * inc)
            for j, cat in cat_of.items():
                sel = zsel & (class_indices == j) if pid_split else zsel
                if not np.any(sel):
                    continue
                for side in range(2):
                    self.z_binned_metric_pairs[i].add(results[sel], wfs[:, side][:, sel], cat)

    def dump_wf_z(self) -> None:
        if not self.analyze_waveforms or self.logger is None:
            return
        for i in range(N_Z_BINS + 2):
            self.z_binned_metric_pairs[i].plot(_NamespacedLogger(self.logger, f"z{i}_"))
        self.z_binned_metric_pairs[-1].plot(_NamespacedLogger(self.logger, "allz_"))

    def fft_pulses(self, f: np.ndarray) -> np.ndarray:
        """The real spectrum of the aligned first samples."""
        return np.fft.rfft(self._align_first_samples(f))

    def z_E_from_cal(self, c: np.ndarray, f: np.ndarray):
        """The classical (z, E) maps ``[B, NX, NY]`` of a sparse batch
        (coords ``[N, 3]``, waveform pairs ``[N, 2S]``); (None, None)
        without a calibration."""
        if not self.hascal:
            return None, None
        n_samples = f.shape[1] // 2
        b = consecutive_event_index(c[:, 2])
        B = int(b[-1]) + 1 if len(b) else 0
        z_out = np.zeros((B, NX, NY))
        E_out = np.zeros((B, NX, NY))
        coords = np.stack([c[:, 0], c[:, 1], b], axis=1).astype(np.int64)
        calc_calib_z_E(coords, np.asarray(f, dtype=np.float64), z_out, E_out,
                       self.calibrator.tables(), self.z_scale, n_samples)
        return z_out, E_out

    def dump(self) -> None:
        if self.logger is None or self._wf_sum is None:
            return
        present = self._wf_n > 0
        if present.any():
            wfs = [self._wf_sum[i] / self._wf_n[i] for i in range(N_Z_BINS) if present[i]]
            labels = [f"z∈[{self.z_edges[i]:.0f},{self.z_edges[i + 1]:.0f})"
                      for i in range(N_Z_BINS) if present[i]]
            self.logger.log_figure(self.namespace + "aligned_waveforms_by_z",
                                   plot_waveforms(wfs, labels))
        self.dump_wf_z()
