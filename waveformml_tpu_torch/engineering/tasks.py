"""Tasks (counterpart of waveformml_tpu/engineering/tasks.py). ``LitPSD``
is ported: its masked loss and metric sums for training and validation,
and its test-time outputs."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from waveformml_tpu_torch.engineering.base import TaskBase
from waveformml_tpu_torch.registry import registry


@registry.register("LitPSD", aliases=("src.engineering.LitPSD", "LitPSD.LitPSD"))
class LitPSD(TaskBase):
    """Event classification (pulse-shape discrimination)."""

    def __init__(self, config, device=None):
        super().__init__(config, device)
        sc = config.system_config
        self.n_type = getattr(sc, "n_type", None) or len(sc.type_names)

    def loss_and_metrics(self, outputs: torch.Tensor, db: Dict[str, torch.Tensor]
                         ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        """Over the real events (``label_mask``): the criterion's sum, its
        'mean' denominator (the event count, or the sum of the events' class
        weights for a class-weighted criterion), and the sums of correct
        predictions, of events and the confusion matrix (rows target,
        columns prediction)."""
        labels = db["labels"].long()
        ymask = db["label_mask"]
        elem = self.criterion.elementwise(outputs, labels)
        loss_sum = elem.masked_fill(~ymask, 0).sum()
        den = self.criterion.mean_denominator(labels)
        count = ymask.sum().float()
        weight = count if den is None else den.masked_fill(~ymask, 0).sum()
        pred = torch.argmax(outputs, dim=-1)
        correct = ((pred == labels) & ymask).sum().float()
        onehot_t = F.one_hot(labels, self.n_type).float() * ymask[:, None]
        onehot_p = F.one_hot(pred, self.n_type).float()
        return loss_sum, weight, {"accuracy_sum": correct, "accuracy_count": count,
                                  "confusion": onehot_t.t() @ onehot_p}

    def test_outputs(self, outputs: torch.Tensor,
                     db: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"logits": outputs,
                "pred": torch.argmax(outputs, dim=-1),
                "logprob": torch.log_softmax(outputs, dim=-1)}
