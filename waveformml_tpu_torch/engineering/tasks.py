"""Tasks (counterpart of waveformml_tpu/engineering/tasks.py). Only the
serving side of ``LitPSD`` is ported: test-time outputs and the masked
accuracy sums; the loss and training come with the training port."""
from __future__ import annotations

from typing import Dict

import torch

from waveformml_tpu_torch.engineering.base import TaskBase
from waveformml_tpu_torch.registry import registry


@registry.register("LitPSD", aliases=("src.engineering.LitPSD", "LitPSD.LitPSD"))
class LitPSD(TaskBase):
    """Event classification (pulse-shape discrimination)."""

    def test_outputs(self, outputs: torch.Tensor,
                     db: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"logits": outputs,
                "pred": torch.argmax(outputs, dim=-1),
                "logprob": torch.log_softmax(outputs, dim=-1)}

    def accuracy_sums(self, outputs: torch.Tensor,
                      db: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Correct predictions and their count over the real events
        (``label_mask``), as the JAX task's metric sums."""
        ymask = db["label_mask"]
        pred = torch.argmax(outputs, dim=-1)
        correct = ((pred == db["labels"]) & ymask).sum().float()
        return {"accuracy_sum": correct, "accuracy_count": ymask.sum().float()}
