"""Joint (E, Z) evaluator composing the Z and Energy evaluators
(ref: src/evaluation/EZEvaluator.py:10-73). The Phys variant cross-checks
calibrated E computed from the *predicted* z (ref :31-66)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from waveformml_tpu_torch.evaluation.energy_eval import (
    EnergyEvaluatorPhys, EnergyEvaluatorWF)
from waveformml_tpu_torch.evaluation.z_eval import ZEvaluatorPhys, ZEvaluatorWF


class EZEvaluatorBase:
    def __init__(self, logger=None, e_scale=None):
        self.logger = logger
        self.e_scale = e_scale
        self.z_eval = None
        self.e_eval = None

    def set_logger(self, logger) -> None:
        self.logger = logger
        self.z_eval.logger = logger
        self.e_eval.logger = logger

    def add(self, predictions: np.ndarray, target: np.ndarray, c: np.ndarray,
            f: Optional[np.ndarray] = None) -> None:
        """predictions/target dense [B, 2, NX, NY]: channel 0 = E, 1 = z
        (the on-disk EZ field layout — see LitEZ.loss_and_metrics)."""
        self.e_eval.add(predictions[:, 0:1], target[:, 0:1], c, f,
                        z_pred=predictions[:, 1])
        self.z_eval.add(predictions[:, 1:2], target[:, 1:2], c, f)

    def add_batch(self, block, db, test_out) -> None:
        """One test batch: ``db`` the host arrays ``prepare_block`` made,
        ``test_out`` the dense ``[B, C, NX, NY]`` predictions and targets
        over at least the batch's real events."""
        mask = np.asarray(db["mask"], dtype=bool)
        if not mask.any():
            return
        self.add(np.asarray(test_out["predictions"]), np.asarray(test_out["target"]),
                 np.asarray(db["coords"])[mask], np.asarray(db["feats"])[mask])

    def dump(self) -> None:
        if self.logger is not None:
            self.set_logger(self.logger)
        self.z_eval.dump()
        self.e_eval.dump()


class EZEvaluatorWF(EZEvaluatorBase):
    def __init__(self, logger=None, calgroup=None, e_scale=None, **kwargs):
        super().__init__(logger, e_scale)
        self.z_eval = ZEvaluatorWF(logger, calgroup=calgroup, **kwargs)
        self.e_eval = EnergyEvaluatorWF(logger, calgroup=calgroup,
                                        e_scale=e_scale,
                                        namespace="evaluation/energy_")


class EZEvaluatorPhys(EZEvaluatorBase):
    def __init__(self, logger=None, calgroup=None, e_scale=None, **kwargs):
        super().__init__(logger, e_scale)
        self.z_eval = ZEvaluatorPhys(logger, calgroup=calgroup, **kwargs)
        self.e_eval = EnergyEvaluatorPhys(logger, calgroup=calgroup,
                                          e_scale=e_scale,
                                          namespace="evaluation/energy_")
