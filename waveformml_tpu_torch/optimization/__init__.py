"""Hyperparameter search over the port's ``Trainer`` (``hpo``)."""
from waveformml_tpu_torch.optimization.hpo import (
    MedianPruner, ModelOptimization, NopPruner, OptunaDB, RandomSampler, Study,
    TPESampler, Trial, TrialPruned, create_study,
)

__all__ = ["MedianPruner", "ModelOptimization", "NopPruner", "OptunaDB", "RandomSampler",
           "Study", "TPESampler", "Trial", "TrialPruned", "create_study"]
