"""TensorBoard scalars of a run (the port's counterpart of ``TBLogger`` in
waveformml_tpu/utils/tb.py). tensorboardX is imported when a logger is
constructed, so the package imports without it."""
from __future__ import annotations

import os
from typing import Dict


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

    def flush(self) -> None:
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()
