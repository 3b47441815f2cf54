"""Single-device trainer (counterpart of the one-device path of
waveformml_tpu/engineering/trainer.py).

``Trainer(config, task, device=None, ...).fit(data_module)`` trains the
task's model with the config's optimizer and epoch scheduler: per epoch,
one micro-step per training block (host pad + plans, copy to the device,
forward, masked loss, backward), the optimizer stepped on every
``accumulate_grad_batches``-th micro-step with the mean of their gradients,
clipped to ``gradient_clip_val`` by global norm; then validation every
``validation_freq`` epochs, the best checkpoint by ``val_loss``, the
callbacks, early stopping, and one scheduler step. Blocks go through the
task's ``prepare_block`` and ``to_device`` in the order the data module
gives them. ``device=None`` means the card.

Each step's host-clock phases and, on the card, the device time of its
forward, backward and optimizer step (CUDA events, read once per epoch so
that no step waits for the device) are kept in ``step_phases``, and each
test batch's in ``test_phases``. ``test`` builds the task's evaluator and
feeds it every test batch; the default callback (``LoggingCallback``)
renders it at the end of the pass. A
``logger`` (``utils.tb.TBLogger``) gets what the JAX ``Trainer`` logs:
each epoch's lr and its own metrics, and the test metrics at step 0.
``add_argparse_args`` and ``kwargs_from_args`` make the arguments CLI
flags, as the JAX ``Trainer``'s.
"""
from __future__ import annotations

import copy
import inspect
import logging
import math
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from waveformml_tpu_torch.config import to_dict
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.device import resolve_device
from waveformml_tpu_torch.engineering.callbacks import EarlyStopping, LoggingCallback
from waveformml_tpu_torch.optim import (MultiSteps, build_optimizer, build_scheduler,
                                        clip_by_global_norm_, set_learning_rate)

log = logging.getLogger(__name__)


def int_or_float(s: str) -> Union[int, float]:
    """A CLI batch limit: "3" a count of batches, "0.5" a fraction."""
    try:
        return int(s)
    except ValueError:
        return float(s)


def _parse_bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes", "on")


class Trainer:
    """Fit, validate and test a task's model on one device.

    The arguments are the JAX ``Trainer``'s that a single device uses:

    * ``callbacks``: objects whose ``on_validation_end(trainer, metrics,
      epoch)``, ``on_train_end(trainer)`` and ``on_test_end(trainer,
      metrics)`` are called where they exist (None: one
      ``LoggingCallback``);
    * ``checkpoint_dir``: where the best checkpoint goes (none without it),
      one ``torch.save`` file ``epoch=E-val_loss=V.ckpt`` (``save_checkpoint``);
    * ``max_epochs``: defaults to the config's ``total_epoch``;
    * ``limit_{train,val,test}_batches``: a float ≤ 1.0 is a fraction of
      the loader's batches (at least one), anything else a count;
      ``overfit_batches`` sets the training and validation limits;
    * ``terminate_on_nan``: a non-finite epoch loss ends ``fit``;
    * ``early_stopping_patience``: ``fit`` stops once ``val_loss`` has not
      improved for that many validations, before the epoch's scheduler step;
    * ``gradient_clip_val``: optax's ``clip_by_global_norm``;
    * ``accumulate_grad_batches``: optax's ``MultiSteps`` (the mean of k
      micro-steps' gradients, clipped as a whole; BatchNorm statistics move
      every micro-step; the count runs on across epochs);
    * ``seed``: seeds ``generator``, the training step's random stream,
      which the task hands to the model's dropout in train mode;
    * ``logger``: an object with ``log_scalar(tag, value, step)``,
      ``log_scalars(values, step)`` and ``flush()``, or None.
    """

    #: constructor arguments that a driver wires as objects, not CLI flags
    _NON_FLAG_PARAMS = ("self", "config", "task", "logger", "callbacks", "checkpoint_dir")

    def __init__(self, config, task, device: Optional[Union[str, torch.device]] = None,
                 callbacks: Optional[List] = None, checkpoint_dir: Optional[str] = None,
                 max_epochs: Optional[int] = None,
                 limit_train_batches: Optional[float] = None,
                 limit_val_batches: Optional[float] = None,
                 limit_test_batches: Optional[float] = None,
                 overfit_batches: Optional[float] = None,
                 terminate_on_nan: bool = True,
                 early_stopping_patience: int = 5,
                 gradient_clip_val: Optional[float] = None,
                 accumulate_grad_batches: int = 1,
                 seed: int = 0, logger=None):
        self.config = config
        self.task = task
        self.device = resolve_device(device)
        task.device = self.device
        task.model.to(self.device)
        oc = config.optimize_config
        self.callbacks = list(callbacks) if callbacks is not None else [LoggingCallback()]
        self.logger = logger
        self.checkpoint_dir = checkpoint_dir
        self.max_epochs = max_epochs if max_epochs is not None else oc.total_epoch
        self.validation_freq = getattr(oc, "validation_freq", 1)
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        self.overfit_batches = overfit_batches
        self.terminate_on_nan = terminate_on_nan
        self.gradient_clip_val = gradient_clip_val
        self.accumulate_grad_batches = max(1, int(accumulate_grad_batches))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        task.generator = self.generator
        self.lr = oc.lr
        self.params = list(task.model.parameters())
        self.optimizer = build_optimizer(oc.optimizer_class, self.params, oc.lr,
                                         to_dict(getattr(oc, "optimizer_params", None) or {}))
        self.scheduler = build_scheduler(getattr(oc, "scheduler_class", None), oc.lr,
                                         to_dict(getattr(oc, "scheduler_params", None) or {}))
        self.multi_steps = (MultiSteps(self.params, self.accumulate_grad_batches)
                            if self.accumulate_grad_batches > 1 else None)
        self.early_stopping = EarlyStopping(patience=early_stopping_patience)
        self.current_epoch = 0
        #: micro-steps taken, as the JAX TrainState's ``step``
        self.global_step = 0
        self.best_val_loss = math.inf
        self.best_ckpt_path: Optional[str] = None
        #: every training step's loss, in order
        self.step_losses: List[float] = []
        #: every training step's phases: host_prep_s, h2d_s, device_ms (None
        #: off the card), wall_s (from its start to the next step's), events
        self.step_phases: List[Dict[str, Any]] = []
        #: every test batch's phases: host_prep_s, h2d_s, device_ms (the
        #: forward's CUDA-event span; None off the card), copy_back_s (the
        #: test outputs to the host), collect_s (the evaluator's or the
        #: caller's ``collect``), wall_s (from its start to the next
        #: batch's, the last to the end of the pass), events
        self.test_phases: List[Dict[str, Any]] = []
        #: the last validation's and test pass's metric arrays (the
        #: confusion matrix), as numpy
        self.last_val_arrays: Dict[str, np.ndarray] = {}
        self.last_test_arrays: Dict[str, np.ndarray] = {}
        self._epoch_wall: List[float] = []
        self._epoch_rows: List[float] = []

    # -- argparse bridge --------------------------------------------------------------
    @classmethod
    def add_argparse_args(cls, parser) -> None:
        """Add a ``--<name>`` flag for each constructor argument that is not
        an object wired by the driver and not already a flag of ``parser``:
        an Optional float a batch limit (``int_or_float``: a count or a
        fraction), an Optional int an int, a bool "true"/"false"."""
        existing = {a.dest for a in parser._actions}
        for name, p in inspect.signature(cls.__init__).parameters.items():
            if name in cls._NON_FLAG_PARAMS or name in existing:
                continue
            ann = str(p.annotation)
            if p.default is None:
                ty = int_or_float if "float" in ann else int if "int" in ann else str
            elif isinstance(p.default, bool):
                ty = _parse_bool
            else:
                ty = type(p.default)
            parser.add_argument(f"--{name}", type=ty, default=p.default,
                                help=f"Trainer argument (default: {p.default})")

    @classmethod
    def kwargs_from_args(cls, args) -> Dict[str, Any]:
        """The constructor arguments found in a parsed argparse namespace."""
        return {name: getattr(args, name)
                for name in inspect.signature(cls.__init__).parameters
                if name not in cls._NON_FLAG_PARAMS and hasattr(args, name)}

    # -- batches ----------------------------------------------------------------------
    def device_batch(self, block: FileBlock
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, np.ndarray], float, float]:
        """Pad a block, build its plans on the host and copy it to the
        device; returns the device batch, the host batch it was copied
        from, and the seconds of the two phases (host prep, copy in) on the
        host clock."""
        task = self.task
        t0 = time.perf_counter()
        db_host = task.prepare_block(block, task.row_bucket(block), task.event_bucket(block))
        t1 = time.perf_counter()
        db = task.to_device(db_host)
        return db, db_host, t1 - t0, time.perf_counter() - t1

    # -- steps ------------------------------------------------------------------------
    def training_step(self, db: Dict[str, torch.Tensor]):
        """One micro-step on a device batch: ``loss = loss_sum / max(weight,
        1e-12)`` and its backward, then, on every ``accumulate_grad_batches``-th
        micro-step, the optimizer step with the micro-steps' mean gradient,
        clipped by ``gradient_clip_val``. Returns the loss and the metric
        sums (device tensors, detached). The parameters' ``.grad`` hold the
        gradients the optimizer stepped with, or this micro-step's own where
        it did not step, until the next micro-step."""
        outputs = self.task.model_outputs(db, train=True)
        loss_sum, weight, metrics = self.task.loss_and_metrics(outputs, db)
        loss = loss_sum / weight.clamp(min=1e-12)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.multi_steps is not None:
            grads = self.multi_steps.update(grads)
        if grads is not None:
            if self.gradient_clip_val:
                clip_by_global_norm_(grads, float(self.gradient_clip_val))
            for p, g in zip(self.params, grads):
                p.grad = g
            self.optimizer.step()
        self.global_step += 1
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    # -- loops ------------------------------------------------------------------------
    @staticmethod
    def _limit(loader, limit: Optional[float]) -> int:
        """The number of batches to take of ``loader``: all without a limit,
        a fraction for a float ≤ 1.0 (at least one), else a count."""
        if limit is None:
            return len(loader)
        if limit <= 1.0 and isinstance(limit, float):
            return max(1, int(len(loader) * limit))
        return min(len(loader), int(limit))

    def fit(self, data_module) -> Dict[str, float]:
        data_module.setup("fit")
        train_loader = data_module.train_dataloader()
        data_module.setup("test")
        val_loader = data_module.val_dataloader()
        if self.overfit_batches:
            self.limit_train_batches = self.overfit_batches
            self.limit_val_batches = self.overfit_batches
        # the JAX Trainer draws the training loader's first batch to build
        # its state: a shuffling loader's first order is drawn here too, so
        # that both train on the same batches in the same order
        for _ in _take(train_loader, 1):
            pass
        metrics: Dict[str, float] = {}
        while self.current_epoch < self.max_epochs:
            t0 = time.perf_counter()
            epoch_metrics = self._train_epoch(train_loader)
            metrics.update(epoch_metrics)
            val_ran = (self.current_epoch + 1) % self.validation_freq == 0
            if val_ran:
                val_metrics = self._eval_epoch(val_loader, "val", self.limit_val_batches)
                metrics.update(val_metrics)
                epoch_metrics.update(val_metrics)
                self._maybe_checkpoint(val_metrics)
                for cb in self.callbacks:
                    if hasattr(cb, "on_validation_end"):
                        cb.on_validation_end(self, val_metrics, self.current_epoch)
                if self.early_stopping.update(val_metrics):
                    log.info("early stopping at epoch %d", self.current_epoch)
                    break
            if self.scheduler is not None:
                # a plateau scheduler sees only a fresh validation loss
                new_lr = self.scheduler.step(metrics.get("val_loss") if val_ran else None)
                set_learning_rate(self.optimizer, new_lr)
                if self.logger:
                    self.logger.log_scalar("lr", new_lr, self.current_epoch)
            if self.logger:
                # this epoch's own measurements only
                self.logger.log_scalars(epoch_metrics, self.current_epoch)
            log.info("epoch %d done in %.1fs: %s", self.current_epoch,
                     time.perf_counter() - t0, metrics)
            self.current_epoch += 1
            if self.terminate_on_nan and not math.isfinite(metrics.get("train_loss", 0.0)):
                log.error("non-finite loss: terminating")
                break
        for cb in self.callbacks:
            if hasattr(cb, "on_train_end"):
                cb.on_train_end(self)
        if self.logger:
            self.logger.flush()
        return metrics

    def _train_epoch(self, loader) -> Dict[str, float]:
        cuda = self.device.type == "cuda"
        losses: List[torch.Tensor] = []
        agg: Dict[str, torch.Tensor] = {}
        phases: List[Dict[str, Any]] = []
        t_epoch = time.perf_counter()
        rows = 0
        for block in _take(loader, self._limit(loader, self.limit_train_batches)):
            start = time.perf_counter()
            db, _, host_prep_s, h2d_s = self.device_batch(block)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)) if cuda else None
            if events:
                events[0].record()
            loss, metrics = self.training_step(db)
            if events:
                events[1].record()
            losses.append(loss)
            _accumulate(agg, metrics)
            rows += int(block.coords.shape[0])
            phases.append({"start": start, "host_prep_s": host_prep_s, "h2d_s": h2d_s,
                           "events": self.task.n_events(block), "cuda_events": events})
        # one wait per epoch: the losses and events are read after it
        step_losses = [float(x) for x in losses]
        end = time.perf_counter()
        self._epoch_wall.append(end - t_epoch)
        self._epoch_rows.append(rows)
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
    def _eval_epoch(self, loader, prefix: str, limit: Optional[float] = None,
                    collect: Optional[Callable] = None) -> Dict[str, float]:
        """One pass over ``loader`` in eval mode: the loss and metrics under
        ``prefix``; the metric arrays kept as ``last_<prefix>_arrays``
        (copied off the device once, after the pass). ``collect(block,
        db_host, test_out)`` gets each batch's host arrays and its test
        outputs (numpy); a test pass records ``test_phases``."""
        cuda = self.device.type == "cuda"
        loss_sum, weight = 0.0, 0.0
        agg: Dict[str, torch.Tensor] = {}
        phases: List[Dict[str, Any]] = []
        for block in _take(loader, self._limit(loader, limit)):
            start = time.perf_counter()
            db, db_host, host_prep_s, h2d_s = self.device_batch(block)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)) if cuda else None
            if events:
                events[0].record()
            outputs = self.task.model_outputs(db, train=False)
            if events:
                events[1].record()
            ls, w, metrics = self.task.loss_and_metrics(outputs, db)
            loss_sum += float(ls)
            weight += float(w)
            _accumulate(agg, metrics)
            copy_back_s = collect_s = 0.0
            if collect is not None:
                n = (block.coords.shape[0] if self.task.output_unit == "row"
                     else self.task.n_events(block))
                t0 = time.perf_counter()
                test_out = {k: v[:n].cpu().numpy()
                            for k, v in self.task.test_outputs(outputs, db).items()}
                t1 = time.perf_counter()
                collect(block, db_host, test_out)
                copy_back_s, collect_s = t1 - t0, time.perf_counter() - t1
            phases.append({"start": start, "host_prep_s": host_prep_s, "h2d_s": h2d_s,
                           "cuda_events": events, "copy_back_s": copy_back_s,
                           "collect_s": collect_s, "events": self.task.n_events(block)})
        end = time.perf_counter()
        for i, p in enumerate(phases):
            ev = p.pop("cuda_events")
            p["device_ms"] = ev[0].elapsed_time(ev[1]) if ev else None
            p["wall_s"] = (phases[i + 1]["start"] if i + 1 < len(phases) else end) - p.pop("start")
        if prefix == "test":
            self.test_phases = phases
        arrays = {k: v.cpu().numpy() for k, v in agg.items() if v.dim() >= 2}
        if prefix == "val":
            self.last_val_arrays = arrays
        else:
            self.last_test_arrays = arrays
        out = {f"{prefix}_loss": loss_sum / max(weight, 1e-12)}
        out.update(_finalize(agg, f"{prefix}_"))
        return out

    def validate(self, data_module) -> Dict[str, float]:
        data_module.setup("test")
        return self._eval_epoch(data_module.val_dataloader(), "val", self.limit_val_batches)

    def test(self, data_module, collect: Optional[Callable] = None) -> Dict[str, float]:
        """The test metrics over the test loader (``test_loss`` and the
        task's metrics, the JAX ``Trainer``'s keys), also given to the
        callbacks' ``on_test_end`` and logged at step 0. ``collect(block,
        db, test_out)`` is called for each test block, in order, with its
        host batch (the padded numpy arrays of ``prepare_block``) and its
        test outputs (numpy, the task's ``test_outputs``, e.g. ``logits``,
        ``pred``, ``logprob``, over the block's real events, or its real
        rows for a per-row task). Without ``collect`` the task's evaluator
        (``task.evaluator``, else built by ``make_evaluator(logger)``; a
        failure to build it is a warning) gets each block through its
        ``add_batch``."""
        data_module.setup("test")
        evaluator = getattr(self.task, "evaluator", None)
        if evaluator is None:
            try:
                evaluator = self.task.make_evaluator(self.logger)
                self.task.evaluator = evaluator
            except Exception as e:
                log.warning("evaluator construction failed: %s", e)
        if collect is None and evaluator is not None:
            collect = evaluator.add_batch
        metrics = self._eval_epoch(data_module.test_dataloader(), "test",
                                   self.limit_test_batches, collect)
        for cb in self.callbacks:
            if hasattr(cb, "on_test_end"):
                cb.on_test_end(self, metrics)
        if self.logger:
            self.logger.log_scalars(metrics, 0)
            self.logger.flush()
        return metrics

    # -- export -----------------------------------------------------------------------
    def export_model(self, path: str, sample_block: FileBlock) -> str:
        """Write the eval forward as a ``torch.export`` program (weights
        included) to ``path``, the counterpart of the JAX ``Trainer``'s
        StableHLO export (ref: LitBase.py:103-109 writes TorchScript on the
        first test batch). It is traced on ``sample_block``'s device batch
        (``device_batch``: its row and event buckets, its site capacity), with
        static shapes as the JAX export has, and takes a device batch dict
        of those shapes; the kernels are the nodes of their custom ops.
        Reload it with ``load_exported``."""
        # the program keeps its example inputs: on the card each leaf is a
        # view of one packed buffer, which torch.export.save cannot store
        db = {k: v.clone() for k, v in self.device_batch(sample_block)[0].items()}
        model = self.task.model
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                program = torch.export.export(EvalForward(self.task), (db,), strict=False)
        finally:
            model.train(was_training)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.export.save(program, path)
        log.info("exported the model to %s", path)
        return path

    # -- checkpoints ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """One ``torch.save`` file: the model's ``state_dict``, the
        optimizer's, the scheduler's and the gradient accumulation's state,
        the epoch, the micro-step count and the best validation loss."""
        torch.save({"state_dict": self.task.model.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "scheduler": (self.scheduler.state_dict()
                                  if self.scheduler is not None else None),
                    "multi_steps": (self.multi_steps.state_dict()
                                    if self.multi_steps is not None else None),
                    "epoch": self.current_epoch, "step": self.global_step,
                    "best_val_loss": self.best_val_loss}, path)

    def load_checkpoint(self, path: str, restore_training: bool = False) -> None:
        """Load a checkpoint's weights; with ``restore_training`` also the
        optimizer, the scheduler, the gradient accumulation, the epoch, the
        micro-step count and the best validation loss, so that ``fit``
        resumes at the saved epoch."""
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.task.model.load_state_dict(ckpt["state_dict"])
        if not restore_training:
            return
        self.optimizer.load_state_dict(ckpt["optimizer"])
        if self.scheduler is not None and ckpt.get("scheduler") is not None:
            self.scheduler.load_state_dict(ckpt["scheduler"])
        if self.multi_steps is not None and ckpt.get("multi_steps") is not None:
            self.multi_steps.load_state_dict(ckpt["multi_steps"])
        self.current_epoch = ckpt["epoch"]
        self.global_step = ckpt.get("step", 0)
        self.best_val_loss = ckpt.get("best_val_loss", math.inf)

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

    # -- LR finder --------------------------------------------------------------------
    def lr_find(self, data_module, min_lr: float = 1e-6, max_lr: float = 1.0,
                num_steps: int = 60) -> float:
        """Train with the lr swept over ``num_steps`` log-spaced values from
        ``min_lr`` to ``max_lr`` (the training blocks cycled), stopping at a
        non-finite loss or, after 10 steps, at a loss above 4× the lowest;
        put the weights, BatchNorm statistics, optimizer and accumulation
        state back, and return the lr where the loss fell fastest
        (``np.gradient``), or the config's lr with fewer than 3 finite
        losses."""
        data_module.setup("fit")
        loader = data_module.train_dataloader()
        saved = (copy.deepcopy(self.task.model.state_dict()),
                 copy.deepcopy(self.optimizer.state_dict()),
                 self.multi_steps.state_dict() if self.multi_steps is not None else None,
                 self.global_step)
        lrs = np.logspace(math.log10(min_lr), math.log10(max_lr), num_steps)
        losses: List[float] = []
        it = iter(loader)
        for lr in lrs:
            try:
                block = next(it)
            except StopIteration:
                it = iter(loader)
                block = next(it)
            set_learning_rate(self.optimizer, float(lr))
            losses.append(float(self.training_step(self.device_batch(block)[0])[0]))
            if not math.isfinite(losses[-1]) or (len(losses) > 10 and
                                                 losses[-1] > 4 * min(losses)):
                lrs = lrs[:len(losses)]
                break
        self.task.model.load_state_dict(saved[0])
        self.optimizer.load_state_dict(saved[1])
        self.optimizer.zero_grad(set_to_none=True)
        if self.multi_steps is not None:
            self.multi_steps.load_state_dict(saved[2])
        self.global_step = saved[3]
        losses_arr = np.asarray(losses)
        valid = np.isfinite(losses_arr)
        if valid.sum() < 3:
            return self.lr
        best = float(np.asarray(lrs)[valid][int(np.argmin(np.gradient(losses_arr[valid])))])
        log.info("lr_find suggests lr=%.3g", best)
        return best

    @property
    def waveforms_per_second(self) -> Optional[float]:
        """Training throughput in real (unpadded) waveform rows per second
        of epoch wall time (which ends with the epoch's wait for its
        losses), or None before an epoch has run."""
        if not self._epoch_wall:
            return None
        return sum(self._epoch_rows) / max(sum(self._epoch_wall), 1e-12)


class EvalForward(torch.nn.Module):
    """A task's eval forward as a module over a device batch dict, what
    ``TaskBase.apply_model`` computes (the model in eval mode, float32
    outputs), for ``torch.export``."""

    def __init__(self, task):
        super().__init__()
        self.model = task.model
        self.task = task

    def forward(self, db: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.model(self.task.sparse_batch(db)).float()


def load_exported(path: str, device: Optional[Union[str, torch.device]] = None
                  ) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """The program that ``Trainer.export_model`` wrote, as a function of a
    device batch dict (``Trainer.device_batch``'s keys and shapes) that
    returns the model's outputs, without gradients. It runs on the device it
    was exported on, which must be ``device`` (None: the card); the custom
    ops of the kernels are registered first. A batch of other shapes (another
    row or event bucket) raises through the program's own shape guard. The
    program runs with cuDNN's float32 convolutions in full float32, as the
    eager forward runs them (``ops.sparse_conv.ieee_fp32_convs``): the flag
    that the eager convs set is the process's, not the graph's."""
    from waveformml_tpu_torch.ops import row_conv, site_head, waveform_features  # noqa: F401
    from waveformml_tpu_torch.ops.sparse_conv import ieee_fp32_convs

    dev = resolve_device(device)
    program = torch.export.load(path)
    on = {t.device.type for t in program.state_dict.values()}
    if on - {dev.type}:
        raise ValueError(f"{path} was exported on {sorted(on)}, not {dev.type}")
    module = program.module()

    def forward(db: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad(), ieee_fp32_convs():
            return module({k: v.to(dev) for k, v in db.items()})

    return forward


def _take(loader, n: int) -> Iterator:
    """The first ``n`` items of ``loader``; the loader's iterator is closed
    after them (which stops a prefetch thread)."""
    it = iter(loader)
    try:
        for _ in range(n):
            try:
                yield next(it)
            except StopIteration:
                return
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


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
