"""Binned-statistics aggregation + TensorBoard rendering.

Equivalent of src/utils/StatsUtils.py: ``StatsAggregator`` keeps a registry of
N-dim binned (sum, count) accumulator pairs with under/overflow metadata
(register_aggregator :143-165, increment_metric :200-218) and renders
hist1d/hist2d/segment matrices into TB (log_total/log_metric/
log_segment_metric :220-333); ``ErrorAggregator`` keeps per-class error
histograms + prediction-vs-truth 2D maps (:34-96); photon/time moment helpers
(:12-32).
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
from scipy import stats as sstats

from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.ops.dsp import hist_add_1d, hist_add_2d, safe_divide
from waveformml_tpu_torch.utils.plot import (
    plot_hist1d, plot_hist2d, plot_segment_matrix)
from waveformml_tpu_torch.utils.util import get_bins

log = logging.getLogger(__name__)


def moment_prod(x: np.ndarray, counts: np.ndarray) -> np.ndarray:
    return np.sum(counts * x[None, :], axis=1) / np.sum(counts, axis=1)


def calc_photon_moments(dist_vec: np.ndarray, n: int) -> np.ndarray:
    """Central moments 2..n+1 of the summed pulse pair (ref :17-22)."""
    out = np.zeros((dist_vec.shape[0], n))
    ns = dist_vec.shape[1] // 2
    pulses = dist_vec[:, :ns] + dist_vec[:, ns:]
    for i in range(n):
        out[:, i] = sstats.moment(pulses, moment=i + 2, axis=1)
    return out


def calc_time_moments(dist_vec: np.ndarray, n: int) -> np.ndarray:
    """Time moments over the 4 ns sample grid (ref :25-31)."""
    out = np.zeros((dist_vec.shape[0], n))
    ns = dist_vec.shape[1] // 2
    pulses = dist_vec[:, :ns] + dist_vec[:, ns:]
    for i in range(n):
        out[:, i] = moment_prod(np.arange(2, ns * 4 + 2, 4, dtype=float) ** (i + 2),
                                pulses)
    return out


class StatsAggregator:
    """Registry of N-dim binned (sum, count) accumulators (ref :99-333)."""

    def __init__(self, logger=None):
        self.logger = logger
        self.metric_metadata: Dict[str, Dict[str, Dict]] = {}
        self.namespace = "evaluation/"

    # -- registration --------------------------------------------------------------
    def register_aggregator(self, name: str, n_bins, lower_bounds, upper_bounds,
                            dim: int, dim_names, dim_units, metric_name: str,
                            metric_units: str, base_name: str = "results",
                            underflow: Union[bool, Tuple] = True,
                            overflow: Union[bool, Tuple] = True,
                            scale: float = 1.0) -> None:
        if not hasattr(self, base_name):
            setattr(self, base_name, {})
        store = getattr(self, base_name)
        meta = self.metric_metadata.setdefault(base_name, {})
        if name in meta:
            raise ValueError(f"{name} already registered to {base_name}")
        uf = underflow if isinstance(underflow, tuple) else tuple(
            1 if underflow else 0 for _ in range(dim))
        of = overflow if isinstance(overflow, tuple) else tuple(
            1 if overflow else 0 for _ in range(dim))
        edges = tuple(get_bins(lower_bounds[i], upper_bounds[i], n_bins[i])
                      for i in range(dim))
        meta[name] = {"dim": dim, "n_bins": tuple(n_bins), "dim_names": dim_names,
                      "dim_units": dim_units, "metric_units": metric_units,
                      "metric_name": metric_name, "scale": scale,
                      "underflow": uf, "overflow": of, "bin_edges": edges}
        shape = tuple(n_bins[i] + uf[i] + of[i] for i in range(dim))
        store[name] = (np.zeros(shape, dtype=np.float64),
                       np.zeros(shape, dtype=np.int64))

    def register_duplicates(self, names: Sequence[str], *args, **kwargs) -> None:
        for name in names:
            self.register_aggregator(name, *args, **kwargs)

    # -- accumulation --------------------------------------------------------------
    def bin_indices(self, name: str, values: Sequence[np.ndarray],
                    base_name: str = "results") -> Tuple[np.ndarray, ...]:
        """Compute per-axis bin indices for a batch of parameter values."""
        md = self.metric_metadata[base_name][name]
        out = []
        for i in range(md["dim"]):
            edges = md["bin_edges"][i]
            nb = md["n_bins"][i]
            idx = np.clip(np.searchsorted(edges, values[i], side="right") - 1, 0, nb - 1)
            idx = idx + md["underflow"][i]
            if md["underflow"][i]:
                idx = np.where(np.asarray(values[i]) < edges[0], 0, idx)
            if md["overflow"][i]:
                idx = np.where(np.asarray(values[i]) >= edges[-1],
                               nb + md["underflow"][i], idx)
            out.append(idx.astype(np.int64))
        return tuple(out)

    def increment_metric(self, name: str, results: np.ndarray, bin_indices,
                         base_name: str = "results") -> None:
        """Accumulate result sums + counts at the given bin indices
        (ref :200-218); accepts vector indices (np.add.at)."""
        total, count = getattr(self, base_name)[name]
        results = np.asarray(results, dtype=np.float64)
        np.add.at(total, bin_indices, results)
        np.add.at(count, bin_indices, 1)

    def accumulate(self, name: str, results: np.ndarray,
                   params: Sequence[np.ndarray], base_name: str = "results") -> None:
        """Convenience: bin + increment in one call."""
        self.increment_metric(name, results, self.bin_indices(name, params, base_name),
                              base_name)

    def _data_slice(self, name: str, base_name: str = "results"):
        md = self.metric_metadata[base_name][name]
        sl = tuple(slice(md["underflow"][i],
                         md["underflow"][i] + md["n_bins"][i])
                   for i in range(md["dim"]))
        total, count = getattr(self, base_name)[name]
        return total[sl], count[sl], md

    # -- rendering -----------------------------------------------------------------
    def _add_figure(self, tag: str, fig) -> None:
        if self.logger is None:
            import matplotlib.pyplot as plt

            plt.close(fig)
            return
        self.logger.log_figure(self.namespace + tag, fig)

    def log_total(self, name: str, log_name: str, plot_title: str,
                  base_name: str = "results") -> None:
        """Histogram of counts (ref :220-260)."""
        total, count, md = self._data_slice(name, base_name)
        if count.max(initial=0) <= 0:
            return
        if md["dim"] == 1:
            fig = plot_hist1d(md["bin_edges"][0], count,
                              xlabel=md["dim_names"][0], ylabel="total",
                              title=plot_title)
        else:
            fig = plot_hist2d(md["bin_edges"][0], md["bin_edges"][1], count,
                              xlabel=md["dim_names"][0], ylabel=md["dim_names"][1],
                              title=plot_title)
        self._add_figure(log_name, fig)

    def log_metric(self, name: str, log_name: str, plot_title: str,
                   base_name: str = "results") -> None:
        """Mean metric per bin (ref :262-300)."""
        total, count, md = self._data_slice(name, base_name)
        if count.max(initial=0) <= 0:
            return
        mean = safe_divide(total, count) * md["scale"]
        label = md["metric_name"]
        if md["metric_units"]:
            label += f" [{md['metric_units']}]"
        if md["dim"] == 1:
            fig = plot_hist1d(md["bin_edges"][0], mean,
                              xlabel=md["dim_names"][0], ylabel=label,
                              title=plot_title)
        else:
            fig = plot_hist2d(md["bin_edges"][0], md["bin_edges"][1], mean,
                              xlabel=md["dim_names"][0], ylabel=md["dim_names"][1],
                              title=plot_title)
        self._add_figure(log_name, fig)

    def log_segment_metric(self, name: str, log_name: str, plot_title: str,
                           base_name: str = "results") -> None:
        """Per-detector-segment (NX×NY[, extra]) metric matrix (ref :302-333)."""
        total, count = getattr(self, base_name)[name]
        md = self.metric_metadata[base_name][name]
        if count.max(initial=0) <= 0:
            return
        mean = safe_divide(total, count) * md["scale"]
        if mean.ndim == 3:  # (x, y, extra) → mean over extra
            cnt = count.sum(axis=2)
            mean = safe_divide(total.sum(axis=2), cnt) * md["scale"]
        fig = plot_segment_matrix(mean, title=plot_title, label=md["metric_name"])
        self._add_figure(log_name, fig)

    def dump(self) -> None:  # overridden by concrete evaluators
        pass


class ErrorAggregator:
    """Per-class error histogram + prediction-vs-truth 2D (ref :34-96)."""

    def __init__(self, name: str, low: float, high: float, n_bins: int,
                 class_names: Sequence[str], metric_name: str = "precision",
                 metric_unit: str = "", scale_factor: float = 1.0,
                 truth_name: str = "truth", pred_name: str = "prediction"):
        self.name = name
        self.metric_name = metric_name
        self.metric_unit = metric_unit
        self.truth_name = truth_name
        self.pred_name = pred_name
        self.n_bins = n_bins
        self.low, self.high = float(low), float(high)
        self.bin_edges = get_bins(low, high, n_bins)
        self.class_names = list(class_names)
        self.scale_factor = scale_factor
        self.num_classes = len(self.class_names)
        self.error_edges: List[Optional[np.ndarray]] = [None] * self.num_classes
        self.error_hist = np.zeros((self.num_classes, n_bins + 2))
        self.error_2d = np.zeros((self.num_classes, n_bins + 2, n_bins + 2))

    def add_norm(self, pred: np.ndarray, actual: np.ndarray, category_name: str) -> None:
        ci = self.class_names.index(category_name)
        error = np.asarray(pred) - np.asarray(actual)
        if self.error_edges[ci] is None:
            max_error = float(np.max(np.abs(error))) or 1.0
            self.error_edges[ci] = get_bins(-1.1 * max_error, 1.1 * max_error,
                                            self.n_bins)
        e = self.error_edges[ci]
        hist_add_1d(error, self.error_hist[ci], (e[0], e[-1]), self.n_bins)
        hist_add_2d(actual, pred, self.error_2d[ci],
                    (self.low, self.high), (self.low, self.high),
                    self.n_bins, self.n_bins)

    def plot(self, logger) -> None:
        for ci, cname in enumerate(self.class_names):
            if self.error_hist[ci].sum() <= 20 or self.error_edges[ci] is None:
                continue
            fig = plot_hist1d(self.error_edges[ci] * self.scale_factor,
                              self.error_hist[ci][1:-1],
                              xlabel=f"error [{self.metric_unit}]",
                              title=f"{self.name} error, {cname}")
            logger.log_figure(f"evaluation/{self.name}_error_class_{cname}", fig)
            fig2 = plot_hist2d(self.bin_edges, self.bin_edges,
                               self.error_2d[ci][1:-1, 1:-1],
                               xlabel=f"{self.truth_name} [{self.metric_unit}]",
                               ylabel=f"{self.pred_name} [{self.metric_unit}]",
                               title=f"{self.name} prediction vs truth, {cname}",
                               log=True)
            logger.log_figure(
                f"evaluation/{self.name}_prediction_vs_truth_class_{cname}", fig2)
