"""TensorBoard logging helpers (counterpart of waveformml_tpu/utils/tb.py).

Writer side: ``TBLogger``, the scalars, figures and histograms of a run;
tensorboardX is imported when a logger is constructed, so the package
imports without it, and figures need matplotlib. Reader side: ``TBHelper``
reads scalars back from an event file (tensorboard's ``EventAccumulator``,
imported when a file is first read) and ``find_tfevents`` lists a
directory's event files, for the occlusion-study script. ``run_evaluation``
is the test pass of ``python -m waveformml_tpu_torch.evaluate`` as a
function.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

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


class TBHelper:
    """Scalars read back from one event file (``set_path`` moves to
    another)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._acc = None

    def set_path(self, path: str) -> None:
        self.path = path
        self._acc = None

    def _accumulator(self):
        if self._acc is None:
            from tensorboard.backend.event_processing.event_accumulator import (
                EventAccumulator)

            self._acc = EventAccumulator(self.path)
            self._acc.Reload()
        return self._acc

    def get_scalars(self, name: str) -> List[Any]:
        """The events of scalar ``name`` (``.step``, ``.value``), [] where
        the file has none."""
        acc = self._accumulator()
        if name not in acc.Tags().get("scalars", []):
            return []
        return list(acc.Scalars(name))

    def get_scalar_names(self) -> List[str]:
        return list(self._accumulator().Tags().get("scalars", []))

    def get_best_value(self, name: str, mode: str = "min") -> Optional[float]:
        """The smallest (``mode="min"``) or largest value of scalar
        ``name``, None where the file has none."""
        vals = [s.value for s in self.get_scalars(name)]
        if not vals:
            return None
        return min(vals) if mode == "min" else max(vals)


def find_tfevents(log_dir: str) -> List[str]:
    """Every TensorBoard event file under ``log_dir``, sorted."""
    out = []
    for root, _, files in os.walk(log_dir):
        out.extend(os.path.join(root, f) for f in files if "tfevents" in f)
    return sorted(out)


def run_evaluation(log_folder: str, config, ckpt: str, calgroup: Optional[str] = None,
                   device: str = "cuda") -> Dict[str, float]:
    """The test pass of checkpoint ``ckpt`` (``config`` a Config or a
    config file) over the config's test set (``main.choose_data_module``)
    through ``evaluate.run`` on ``device``, logged into ``log_folder``;
    ``calgroup`` overrides the config's (with a warning where it had one).
    Returns the test metrics."""
    import argparse
    import logging

    from waveformml_tpu_torch import evaluate
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.main import choose_data_module

    if isinstance(config, str):
        config = load_config(config)
    if calgroup:
        if hasattr(config.dataset_config, "calgroup"):
            logging.getLogger(__name__).warning(
                "overriding calgroup %s with user supplied calgroup %s",
                config.dataset_config.calgroup, calgroup)
        config.dataset_config["calgroup"] = calgroup
    args = argparse.Namespace(checkpoint=ckpt, occlude=None, limit_test_batches=None,
                              device=device, script=False)
    logger = TBLogger(log_folder)
    try:
        return evaluate.run(config, args, choose_data_module(config), logger=logger)["test"]
    finally:
        logger.close()
