"""Single-device trainer (counterpart of the one-device path of
waveformml_tpu/engineering/trainer.py).

``Trainer(config, task, device=None).fit(data_module)`` trains the task's
model with the config's optimizer and epoch scheduler: per epoch, one step
per training block (host pad + plans, copy to the device, forward, masked
loss, backward, optimizer step), validation every ``validation_freq``
epochs, the best checkpoint by ``val_loss``, then one scheduler step. Blocks
go through the task's ``prepare_block`` and ``to_device`` in the order the
data module gives them. ``device=None`` means the card.

Each step's host-clock phases and, on the card, the device time of its
forward, backward and optimizer step (CUDA events, read once per epoch so
that no step waits for the device) are kept in ``step_phases``.
"""
from __future__ import annotations

import logging
import math
import os
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from waveformml_tpu_torch.config import to_dict
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.device import resolve_device
from waveformml_tpu_torch.optim import build_optimizer, build_scheduler

log = logging.getLogger(__name__)


class Trainer:
    """Fit, validate and test a task's model on one device.

    ``checkpoint_dir``: where the best checkpoint goes (none without it),
    one ``torch.save`` file ``epoch=E-val_loss=V.ckpt`` holding the model's
    ``state_dict``, the optimizer's and the scheduler's state and the epoch.
    ``max_epochs`` defaults to the config's ``total_epoch``. A non-finite
    epoch loss ends ``fit``.
    """

    def __init__(self, config, task, device: Optional[Union[str, torch.device]] = None,
                 checkpoint_dir: Optional[str] = None, max_epochs: Optional[int] = None):
        self.config = config
        self.task = task
        self.device = resolve_device(device)
        task.device = self.device
        task.model.to(self.device)
        oc = config.optimize_config
        self.max_epochs = max_epochs if max_epochs is not None else oc.total_epoch
        self.validation_freq = getattr(oc, "validation_freq", 1)
        self.checkpoint_dir = checkpoint_dir
        self.optimizer = build_optimizer(oc.optimizer_class, task.model.parameters(), oc.lr,
                                         to_dict(getattr(oc, "optimizer_params", None) or {}))
        self.scheduler = build_scheduler(getattr(oc, "scheduler_class", None), self.optimizer,
                                         to_dict(getattr(oc, "scheduler_params", None) or {}))
        self.current_epoch = 0
        self.best_val_loss = math.inf
        self.best_ckpt_path: Optional[str] = None
        #: every training step's loss, in order
        self.step_losses: List[float] = []
        #: every training step's phases: host_prep_s, h2d_s, device_ms (None
        #: off the card), wall_s (from its start to the next step's), events
        self.step_phases: List[Dict[str, Any]] = []
        self.test_metrics: Dict[str, float] = {}

    # -- batches ----------------------------------------------------------------------
    def device_batch(self, block: FileBlock) -> Tuple[Dict[str, torch.Tensor], float, float]:
        """Pad a block, build its plans on the host and copy it to the
        device; returns the device batch and the seconds of the two phases
        (host prep, copy in) on the host clock."""
        task = self.task
        t0 = time.perf_counter()
        db_host = task.prepare_block(block, task.row_bucket(block), task.event_bucket(block))
        t1 = time.perf_counter()
        db = task.to_device(db_host)
        return db, t1 - t0, time.perf_counter() - t1

    # -- steps ------------------------------------------------------------------------
    def training_step(self, db: Dict[str, torch.Tensor]):
        """One optimizer step on a device batch: ``loss = loss_sum /
        max(weight, 1e-12)``, backward, step. Returns the loss and the
        metric sums (device tensors, detached); the parameters' ``.grad``
        hold this step's gradients until the next step."""
        outputs = self.task.model_outputs(db, train=True)
        loss_sum, weight, metrics = self.task.loss_and_metrics(outputs, db)
        loss = loss_sum / weight.clamp(min=1e-12)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    # -- loops ------------------------------------------------------------------------
    def fit(self, data_module) -> Dict[str, float]:
        data_module.setup("fit")
        train_loader = data_module.train_dataloader()
        data_module.setup("test")
        val_loader = data_module.val_dataloader()
        metrics: Dict[str, float] = {}
        while self.current_epoch < self.max_epochs:
            t0 = time.perf_counter()
            metrics.update(self._train_epoch(train_loader))
            if (self.current_epoch + 1) % self.validation_freq == 0:
                val_metrics = self._eval_epoch(val_loader, "val")
                metrics.update(val_metrics)
                self._maybe_checkpoint(val_metrics)
            if self.scheduler is not None:
                self.scheduler.step()
            log.info("epoch %d done in %.1fs: %s", self.current_epoch,
                     time.perf_counter() - t0, metrics)
            self.current_epoch += 1
            if not math.isfinite(metrics.get("train_loss", 0.0)):
                log.error("non-finite loss: terminating")
                break
        return metrics

    def _train_epoch(self, loader) -> Dict[str, float]:
        cuda = self.device.type == "cuda"
        losses: List[torch.Tensor] = []
        agg: Dict[str, torch.Tensor] = {}
        phases: List[Dict[str, Any]] = []
        for block in loader:
            start = time.perf_counter()
            db, host_prep_s, h2d_s = self.device_batch(block)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)) if cuda else None
            if events:
                events[0].record()
            loss, metrics = self.training_step(db)
            if events:
                events[1].record()
            losses.append(loss)
            _accumulate(agg, metrics)
            phases.append({"start": start, "host_prep_s": host_prep_s, "h2d_s": h2d_s,
                           "events": int(block.labels.shape[0]), "cuda_events": events})
        # one wait per epoch: the losses and events are read after it
        step_losses = [float(x) for x in losses]
        end = time.perf_counter()
        for i, p in enumerate(phases):
            ev = p.pop("cuda_events")
            p["device_ms"] = ev[0].elapsed_time(ev[1]) if ev else None
            p["wall_s"] = (phases[i + 1]["start"] if i + 1 < len(phases) else end) - p.pop("start")
        self.step_losses += step_losses
        self.step_phases += phases
        out = {"train_loss": float(np.mean(step_losses)) if step_losses else 0.0}
        out.update(_finalize(agg, "train_"))
        return out

    @torch.no_grad()
    def _eval_epoch(self, loader, prefix: str, collect: Optional[List] = None
                    ) -> Dict[str, float]:
        loss_sum, weight = 0.0, 0.0
        agg: Dict[str, torch.Tensor] = {}
        for block in loader:
            db = self.device_batch(block)[0]
            outputs = self.task.model_outputs(db, train=False)
            ls, w, metrics = self.task.loss_and_metrics(outputs, db)
            loss_sum += float(ls)
            weight += float(w)
            _accumulate(agg, metrics)
            if collect is not None:
                n = block.labels.shape[0]
                collect.append({k: v[:n].cpu().numpy()
                                for k, v in self.task.test_outputs(outputs, db).items()})
        out = {f"{prefix}_loss": loss_sum / max(weight, 1e-12)}
        out.update(_finalize(agg, f"{prefix}_"))
        return out

    def validate(self, data_module) -> Dict[str, float]:
        data_module.setup("test")
        return self._eval_epoch(data_module.val_dataloader(), "val")

    def test(self, data_module) -> List[Dict[str, np.ndarray]]:
        """Test outputs of every test block (``logits``, ``pred``,
        ``logprob`` over its real events), in order; the test metrics go to
        ``test_metrics``."""
        data_module.setup("test")
        outputs: List[Dict[str, np.ndarray]] = []
        self.test_metrics = self._eval_epoch(data_module.test_dataloader(), "test", outputs)
        return outputs

    # -- checkpoints ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        torch.save({"state_dict": self.task.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "scheduler": (self.scheduler.state_dict()
                                  if self.scheduler is not None else None),
                    "epoch": self.current_epoch}, path)

    def _maybe_checkpoint(self, val_metrics: Dict[str, float]) -> None:
        vl = val_metrics.get("val_loss")
        if vl is None or not self.checkpoint_dir or not vl < self.best_val_loss:
            return
        self.best_val_loss = vl
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        path = os.path.join(self.checkpoint_dir,
                            f"epoch={self.current_epoch}-val_loss={vl:.2f}.ckpt")
        if self.best_ckpt_path and os.path.exists(self.best_ckpt_path):
            os.remove(self.best_ckpt_path)
        self.save_checkpoint(path)
        self.best_ckpt_path = path
        log.info("saved best checkpoint: %s", path)


def _accumulate(agg: Dict[str, torch.Tensor], metrics: Dict[str, torch.Tensor]) -> None:
    for k, v in metrics.items():
        agg[k] = agg[k] + v if k in agg else v


def _finalize(agg: Dict[str, torch.Tensor], prefix: str) -> Dict[str, float]:
    """``x_sum`` over ``x_count`` as ``prefix + x``; other scalars as they
    are; arrays (the confusion matrix) are left out."""
    out: Dict[str, float] = {}
    for k, v in agg.items():
        if k.endswith("_sum"):
            cnt = agg.get(k[:-4] + "_count")
            if cnt is not None and float(cnt) > 0:
                out[prefix + k[:-4]] = float(v) / float(cnt)
        elif not k.endswith("_count") and v.dim() == 0:
            out[prefix + k] = float(v)
    return out
