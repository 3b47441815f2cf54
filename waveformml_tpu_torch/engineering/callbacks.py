"""Training callbacks (counterpart of waveformml_tpu/engineering/callbacks.py).

``EarlyStopping`` watches a validation metric with a patience. The
``Trainer`` also calls, on each object in its ``callbacks``, whichever of
``on_validation_end(trainer, metrics, epoch)``, ``on_train_end(trainer)``
and ``on_test_end(trainer, metrics)`` it has. ``LoggingCallback`` (the
``Trainer``'s default) logs the confusion figures and ``hp_metric`` and
renders the task's evaluator at the end of the test pass.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np

from waveformml_tpu_torch.utils import tracing


class EarlyStopping:
    """Stop once ``monitor`` has not improved (by more than ``min_delta``,
    in ``mode`` "min" or "max") for ``patience`` validations in a row."""

    def __init__(self, monitor: str = "val_loss", patience: int = 5,
                 mode: str = "min", min_delta: float = 0.0):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.stopped = False

    def update(self, metrics: Dict[str, float]) -> bool:
        """Take one validation's metrics; True once training should stop."""
        value = metrics.get(self.monitor)
        if value is None:
            return False
        improved = (self.best is None or
                    (self.mode == "min" and value < self.best - self.min_delta) or
                    (self.mode == "max" and value > self.best + self.min_delta))
        if improved:
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs >= self.patience:
                self.stopped = True
        return self.stopped

    def state_dict(self) -> Dict[str, Any]:
        return {"best": self.best, "bad_epochs": self.bad_epochs, "stopped": self.stopped}

    def load_state_dict(self, d: Dict[str, Any]) -> None:
        self.best, self.bad_epochs, self.stopped = d["best"], d["bad_epochs"], d["stopped"]


class LoggingCallback:
    """Figure and ``hp_metric`` logging (ref: LitCallbacks.py:37-73): each
    validation's confusion figure and the best ``val_loss``; at the end of
    training ``hp_metric``; at the end of the test pass the test confusion
    figure and the evaluator's ``dump()`` (given the trainer's logger where
    it has none). Nothing is logged without a logger; a failed confusion
    figure is a warning. ``dump_seconds`` is the wall of the last
    ``dump()`` (span ``callbacks.dump``)."""

    def __init__(self, class_names=None):
        self.log = logging.getLogger(__name__)
        self.class_names = class_names
        self.best_loss: Optional[float] = None
        self.dump_seconds: Optional[float] = None

    def on_validation_end(self, trainer, metrics: Dict[str, float], epoch: int) -> None:
        vl = metrics.get("val_loss")
        if vl is not None and (self.best_loss is None or vl < self.best_loss):
            self.best_loss = vl
        if "confusion" in trainer.last_val_arrays and trainer.logger:
            self._log_confusion(trainer.logger, trainer.last_val_arrays["confusion"],
                                "val_confusion_matrix", epoch)

    def on_train_end(self, trainer) -> None:
        if self.best_loss is not None and trainer.logger:
            trainer.logger.log_scalar("hp_metric", self.best_loss, 0)

    def on_test_end(self, trainer, metrics: Dict[str, float]) -> None:
        if "confusion" in trainer.last_test_arrays and trainer.logger:
            self._log_confusion(trainer.logger, trainer.last_test_arrays["confusion"],
                                "test_confusion_matrix", 0)
        evaluator = getattr(trainer.task, "evaluator", None)
        if evaluator is not None:
            if getattr(evaluator, "logger", None) is None and trainer.logger:
                evaluator.logger = trainer.logger
            with tracing.span("callbacks.dump") as dump:
                evaluator.dump()
            self.dump_seconds = dump.seconds

    def _log_confusion(self, logger, confusion: np.ndarray, tag: str, step: int) -> None:
        try:
            from waveformml_tpu_torch.utils.plot import plot_confusion_matrix

            fig = plot_confusion_matrix(np.asarray(confusion), self.class_names)
            logger.log_figure(tag, fig, step)
        except Exception as e:  # plotting must never end training
            self.log.warning("confusion figure logging failed: %s", e)
