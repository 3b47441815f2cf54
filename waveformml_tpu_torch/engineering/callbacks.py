"""Training callbacks (counterpart of waveformml_tpu/engineering/callbacks.py).

``EarlyStopping`` watches a validation metric with a patience. The
``Trainer`` also calls, on each object in its ``callbacks``, whichever of
``on_validation_end(trainer, metrics, epoch)``, ``on_train_end(trainer)``
and ``on_test_end(trainer, metrics)`` it has.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


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
