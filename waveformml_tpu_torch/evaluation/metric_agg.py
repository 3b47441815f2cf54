"""Per-class binned metric aggregators with running mean/std.

Equivalent of src/evaluation/MetricAggregator.py: ``MetricAggregator``
(per-class 1D binned metric with Welford M2, :12-171), ``Metric2DAggregator``
(pairwise 2D, :174-336), ``MetricPairAggregator`` (all-pairs product of a
metric list incl. dense-with-categories paths, :339-403). Welford updates use
the vectorized batch-merge kernels in ops.dsp.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from waveformml_tpu_torch.ops.dsp import (
    finalize_welford, metric_accumulate_2d, welford_accumulate_1d)
from waveformml_tpu_torch.utils.plot import plot_hist2d, plot_n_hist1d
from waveformml_tpu_torch.utils.util import get_bins


class MetricAggregator:
    """Running mean/std of a metric binned over one parameter, per class."""

    def __init__(self, name: str, low: float, high: float, n_bins: int,
                 class_names: Sequence[str], metric_name: str = "precision",
                 metric_unit: str = "", parameter_unit: str = "",
                 scale_factor: float = 1.0, norm_factor: float = 1.0):
        self.name = name
        self.low, self.high, self.n_bins = low, high, n_bins
        self.class_names = list(class_names)
        self.metric_name = metric_name
        self.metric_unit = metric_unit
        self.parameter_unit = parameter_unit
        self.scale_factor = scale_factor
        self.norm_factor = norm_factor
        nc = len(self.class_names)
        self.mean = np.zeros((nc, n_bins + 2))
        self.count = np.zeros((nc, n_bins + 2))
        self.m2 = np.zeros((nc, n_bins + 2))
        self.bin_edges = get_bins(low, high, n_bins)

    def add(self, results: np.ndarray, parameter: np.ndarray,
            category_name: str) -> None:
        ci = self.class_names.index(category_name)
        welford_accumulate_1d(results, np.asarray(parameter) * self.norm_factor,
                              self.mean[ci], self.count[ci], self.m2[ci],
                              (self.low, self.high), self.n_bins)

    def mean_std(self, class_index: int):
        return (self.mean[class_index] * self.scale_factor,
                finalize_welford(self.count[class_index], self.m2[class_index])
                * self.scale_factor)

    def plot(self, logger, rebin: int = 1) -> None:
        present = [i for i in range(len(self.class_names))
                   if self.count[i].sum() > 0]
        if not present:
            return
        label = self.metric_name + (f" [{self.metric_unit}]" if self.metric_unit else "")
        xlab = self.name + (f" [{self.parameter_unit}]" if self.parameter_unit else "")
        means = [self.mean[i][1:-1] * self.scale_factor for i in present]
        fig = plot_n_hist1d(self.bin_edges, means,
                            [self.class_names[i] for i in present],
                            xlabel=xlab, ylabel=label,
                            title=f"{self.metric_name} vs {self.name}")
        logger.log_figure(f"evaluation/{self.metric_name}_vs_{self.name}", fig)


class Metric2DAggregator:
    """Metric sums binned over a parameter pair, per class (ref :174-336)."""

    def __init__(self, name_x: str, name_y: str, bins_x, bins_y,
                 class_names: Sequence[str], metric_name: str = "precision",
                 metric_unit: str = "", scale_factor: float = 1.0):
        self.name_x, self.name_y = name_x, name_y
        self.low_x, self.high_x, self.nbins_x = bins_x
        self.low_y, self.high_y, self.nbins_y = bins_y
        self.class_names = list(class_names)
        self.metric_name = metric_name
        self.metric_unit = metric_unit
        self.scale_factor = scale_factor
        nc = len(self.class_names)
        self.total = np.zeros((nc, self.nbins_x + 2, self.nbins_y + 2))
        self.count = np.zeros((nc, self.nbins_x + 2, self.nbins_y + 2))
        self.edges_x = get_bins(self.low_x, self.high_x, self.nbins_x)
        self.edges_y = get_bins(self.low_y, self.high_y, self.nbins_y)

    def add(self, results: np.ndarray, px: np.ndarray, py: np.ndarray,
            category_name: str) -> None:
        ci = self.class_names.index(category_name)
        metric_accumulate_2d(np.asarray(results),
                             np.stack([px, py], axis=1),
                             self.total[ci], self.count[ci],
                             (self.low_x, self.high_x), (self.low_y, self.high_y),
                             self.nbins_x, self.nbins_y)

    def plot(self, logger) -> None:
        from waveformml_tpu_torch.ops.dsp import safe_divide

        for ci, cname in enumerate(self.class_names):
            if self.count[ci].sum() <= 0:
                continue
            mean = safe_divide(self.total[ci], self.count[ci]) * self.scale_factor
            fig = plot_hist2d(self.edges_x, self.edges_y, mean[1:-1, 1:-1],
                              xlabel=self.name_x, ylabel=self.name_y,
                              title=f"{self.metric_name}, {cname}")
            logger.log_figure(
                f"evaluation/{self.metric_name}_vs_{self.name_x}_{self.name_y}_{cname}",
                fig)


class MetricPairAggregator:
    """All-pairs product of a list of MetricAggregators: keeps each 1D
    aggregator plus a Metric2DAggregator for every parameter pair (ref :339-403)."""

    def __init__(self, aggregators: Sequence[MetricAggregator],
                 metric_name: str = "precision", metric_unit: str = ""):
        self.aggregators = list(aggregators)
        self.pairs: Dict[str, Metric2DAggregator] = {}
        for i in range(len(self.aggregators)):
            for j in range(i + 1, len(self.aggregators)):
                a, b = self.aggregators[i], self.aggregators[j]
                key = f"{a.name}_{b.name}"
                self.pairs[key] = Metric2DAggregator(
                    a.name, b.name, (a.low, a.high, a.n_bins),
                    (b.low, b.high, b.n_bins), a.class_names,
                    metric_name=metric_name, metric_unit=metric_unit)

    def add(self, results: np.ndarray, parameters: np.ndarray,
            category_name: str) -> None:
        """parameters: [P, N] matrix aligned with the aggregator list."""
        for i, agg in enumerate(self.aggregators):
            agg.add(results, parameters[i], category_name)
        for i in range(len(self.aggregators)):
            for j in range(i + 1, len(self.aggregators)):
                key = f"{self.aggregators[i].name}_{self.aggregators[j].name}"
                self.pairs[key].add(results, parameters[i], parameters[j],
                                    category_name)

    def plot(self, logger) -> None:
        for agg in self.aggregators:
            agg.plot(logger)
        for pair in self.pairs.values():
            pair.plot(logger)
