"""TensorBoard scalars, figures and histograms of a run (the port's
counterpart of ``TBLogger`` in waveformml_tpu/utils/tb.py). tensorboardX
is imported when a logger is constructed, so the package imports without
it; figures need matplotlib."""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np


class TBLogger:
    """A tensorboardX ``SummaryWriter`` over ``log_dir`` (created where
    missing); raises ``ImportError`` where tensorboardX is not installed."""

    def __init__(self, log_dir: str):
        from tensorboardX import SummaryWriter

        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.writer = SummaryWriter(log_dir)

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        self.writer.add_scalar(tag, float(value), step)

    def log_scalars(self, values: Dict[str, float], step: int) -> None:
        for k, v in values.items():
            self.log_scalar(k, v, step)

    def log_figure(self, tag: str, figure, step: int = 0, close: bool = True) -> None:
        self.writer.add_figure(tag, figure, step, close=close)

    def log_histogram(self, tag: str, values, step: int = 0) -> None:
        self.writer.add_histogram(tag, np.asarray(values), step)

    def log_hparams(self, hparams: Dict[str, Any], metrics: Dict[str, float]) -> None:
        """The run's scalar hyperparameters with ``metrics``; where the
        writer refuses them, the metrics as scalars at step 0."""
        flat = {k: v for k, v in hparams.items() if isinstance(v, (int, float, str, bool))}
        try:
            self.writer.add_hparams(flat, metrics)
        except Exception:
            for k, v in metrics.items():
                self.log_scalar(k, v, 0)

    def flush(self) -> None:
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()
