"""Histogram accumulation utilities (the port's copy of
waveformml_tpu/utils/hist.py).

The reference's HistUtils.py HistCollator (ref: src/utils/HistUtils.py:5-29)
is vestigial and non-functional (subclasses numpy.histogram, indexes shapes);
this is the working equivalent: fixed-bin 1D/2D histogram accumulators that
collate partial histograms or raw samples across batches/files. Streaming
accumulation lives in ops.dsp (hist_add_1d / hist_add_2d); these are
the host-side collators used by analysis scripts.
"""
from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)


class _DropWarnMixin:
    """Auto-ranged collators freeze their edges on the first add(); later
    batches can fall outside and np.histogram silently excludes them — log
    the loss once so cross-file collation isn't silently undercounted."""

    _warned_drop = False

    def _warn_dropped(self, v: np.ndarray, edges: np.ndarray) -> None:
        if self._warned_drop or v.size == 0:
            return
        n_out = int((v < edges[0]).sum() + (v > edges[-1]).sum())
        if n_out:
            self._warned_drop = True
            log.warning(
                "%s: %d sample(s) outside the fixed range [%g, %g] were "
                "dropped (auto-range freezes on the first batch; pass an "
                "explicit range to cover all files)",
                type(self).__name__, n_out, edges[0], edges[-1])


class HistCollator(_DropWarnMixin):
    """Fixed-bin 1D histogram accumulator: add raw samples or pre-binned
    counts from any number of sources, read out (counts, edges)."""

    def __init__(self, bins: int = 100,
                 range: Optional[Tuple[float, float]] = None):
        self.bins = int(bins)
        self.range = range
        self.counts = np.zeros(self.bins, dtype=np.float64)
        self._edges: Optional[np.ndarray] = None
        if range is not None:
            self._edges = np.linspace(range[0], range[1], self.bins + 1)

    @property
    def edges(self) -> np.ndarray:
        if self._edges is None:
            raise ValueError("no samples added yet and no range specified")
        return self._edges

    def add(self, values: np.ndarray, weights: Optional[np.ndarray] = None) -> None:
        values = np.asarray(values).ravel()
        if values.size == 0:
            return  # nothing to bin; auto-range must wait for real samples
        if self._edges is None:
            lo, hi = float(values.min()), float(values.max())
            if lo == hi:
                hi = lo + 1.0
            self._edges = np.linspace(lo, hi, self.bins + 1)
        c, _ = np.histogram(values, bins=self._edges, weights=weights)
        # float accumulator: weighted histograms produce fractional bin sums
        # that an int64 astype would silently floor
        self.counts += c.astype(np.float64)
        self._warn_dropped(values, self._edges)

    def add_histogram(self, counts: np.ndarray) -> None:
        counts = np.asarray(counts)
        if counts.shape != self.counts.shape:
            raise ValueError(f"histogram shape {counts.shape} != {self.counts.shape}")
        self.counts += counts.astype(np.float64)

    def merge(self, other: "HistCollator") -> None:
        if other.bins != self.bins:
            raise ValueError("bin counts differ")
        self.add_histogram(other.counts)

    def normalized(self) -> np.ndarray:
        total = self.counts.sum()
        return self.counts / total if total else self.counts.astype(float)

    def clear(self) -> None:
        self.counts[:] = 0


class Hist2DCollator(_DropWarnMixin):
    """Fixed-bin 2D histogram accumulator."""

    def __init__(self, bins: Sequence[int] = (100, 100),
                 range: Optional[Sequence[Tuple[float, float]]] = None):
        self.bins = (int(bins[0]), int(bins[1]))
        self.counts = np.zeros(self.bins, dtype=np.float64)
        self._edges = None
        if range is not None:
            self._edges = (np.linspace(range[0][0], range[0][1], self.bins[0] + 1),
                           np.linspace(range[1][0], range[1][1], self.bins[1] + 1))

    def add(self, x: np.ndarray, y: np.ndarray,
            weights: Optional[np.ndarray] = None) -> None:
        x, y = np.asarray(x).ravel(), np.asarray(y).ravel()
        if x.size == 0:
            return  # nothing to bin; auto-range must wait for real samples
        if self._edges is None:
            self._edges = (self._auto_edges(x, self.bins[0]),
                           self._auto_edges(y, self.bins[1]))
        c, _, _ = np.histogram2d(x, y, bins=self._edges, weights=weights)
        self.counts += c.astype(np.float64)
        self._warn_dropped(x, self._edges[0])
        self._warn_dropped(y, self._edges[1])

    @staticmethod
    def _auto_edges(v: np.ndarray, bins: int) -> np.ndarray:
        lo, hi = float(v.min()), float(v.max())
        if lo == hi:
            hi = lo + 1.0
        return np.linspace(lo, hi, bins + 1)

    def add_histogram(self, counts: np.ndarray) -> None:
        counts = np.asarray(counts)
        if counts.shape != self.counts.shape:
            raise ValueError(f"histogram shape {counts.shape} != {self.counts.shape}")
        self.counts += counts.astype(np.float64)

    @property
    def edges(self):
        if self._edges is None:
            raise ValueError("no samples added yet and no range specified")
        return self._edges
