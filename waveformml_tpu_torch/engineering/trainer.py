"""The trainer (counterpart of waveformml_tpu/engineering/trainer.py's
shard_map engine: one device, or data-parallel ranks).

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
test batch's in ``test_phases``. Every phase is a ``utils.tracing`` span
(``trainer.fit_start``, ``trainer.epoch``, ``trainer.host_prep``,
``trainer.h2d``, ``trainer.step`` with ``trainer.forward``,
``trainer.backward`` and ``trainer.optimizer``, ``trainer.loss_read``,
``trainer.epoch_end``; in a validation or test pass ``trainer.val`` or
``trainer.test``, ``trainer.copy_back`` and ``trainer.collect``), whose
request id is the step's ``global_step``. While tracing is active (a
``torch.profiler`` session records) the spans sit in the profiler's trace
and the tracer's store, and on the card each training step adds the device
spans ``trainer.h2d``, ``trainer.forward``, ``trainer.backward`` and
``trainer.optimizer``, bounded by events before the copy in, around the
step and after its forward and its backward. ``test`` builds the task's evaluator and
feeds it every test batch; the default callback (``LoggingCallback``)
renders it at the end of the pass. ``profiler=True`` times the JAX
``Trainer``'s named sections (``utils.profiler.SimpleProfiler``, the
device synchronised after each step) and traces the whole fit with
``torch.profiler`` (CPU and, on the card, CUDA activities): the trace as
``<log_dir>/profile/<host>_<pid>.pt.trace.json`` and the table as
``<log_dir>/profile_results.txt``, ``log_dir`` being the logger's or,
without a logger, ``checkpoint_dir``. Where the task holds an HPO
``trial``, each validation reports ``val_loss`` to it and a pruned trial
ends ``fit`` with ``TrialPruned``. A
``logger`` (``utils.tb.TBLogger``) gets what the JAX ``Trainer`` logs:
each epoch's lr and its own metrics, and the test metrics at step 0.
``add_argparse_args`` and ``kwargs_from_args`` make the arguments CLI
flags, as the JAX ``Trainer``'s.

Where ``torch.distributed`` has a process group (``parallel.mesh
.initialize_distributed``), the Trainer is one rank of a data-parallel run,
as the JAX ``shard_map`` step is one device of its mesh: it starts from
rank 0's weights and statistics (a broadcast); each loader is read
round-robin (``shard_loader_round_robin``: at step t, batch t·W + r);
each step agrees the row and event buckets and the data-dependent dims
(graph edge caps, the site layout's width) with the group's largest, runs
its forward with the BatchNorm statistics summed over the ranks
(``nn.bn``), divides its loss sum by the ranks' summed weight, and sums
the gradients, the loss and the metric sums over the ranks before
accumulation, clipping and the optimizer; the BatchNorm running
statistics are averaged over the ranks after it. Validation and test
batches sum their loss, weight and metrics the same way; each rank hands
its own outputs to its evaluator. Rank 0 alone writes checkpoints (the
others wait for it) and logs; dropout draws from a stream seeded with the
seed and the rank.

With ``tp > 1`` (the JAX package's GSPMD engine, ``parallel="gspmd"``) the
ranks form a ``(dp, tp)`` grid (``parallel.gspmd.make_mesh_2d``): rank r
at ``(data, model) = (r // tp, r % tp)``. The model's wide parameters are
column-sharded over each model group (``parallel.gspmd.TensorParallel``),
so a rank holds, steps and keeps optimizer state for its blocks only. Then
the loaders go round-robin over the data index with ``dp``; the BatchNorm
statistics, the weight, the gradients, the loss and the metrics are summed
over the data group (the ranks of one model index), and the running
statistics averaged over it; the buckets and shapes are still agreed over
every rank; the global-norm clip counts each sharded gradient's blocks
once, summed over the model group; dropout is seeded with the data index,
so that a model group draws one mask; checkpoints hold the gathered
one-rank state, written by rank 0, and a loaded one is sharded again;
only model-index-0 ranks hand their outputs to the evaluator.
"""
from __future__ import annotations

import copy
import inspect
import logging
import math
import os
import socket
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from waveformml_tpu_torch.config import to_dict
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.device import resolve_device
from waveformml_tpu_torch.engineering.callbacks import EarlyStopping, LoggingCallback
from waveformml_tpu_torch.models.blocks import MaskedArrayBatchNorm
from waveformml_tpu_torch.nn.bn import synced_bn
from waveformml_tpu_torch.nn.layers import _FlaxBatchNorm
from waveformml_tpu_torch.optim import (MultiSteps, build_optimizer, build_scheduler,
                                        clip_by_global_norm_, set_learning_rate)
from waveformml_tpu_torch.parallel.gspmd import (TensorParallel, block_of, gather_blocks,
                                                 make_mesh_2d)
from waveformml_tpu_torch.parallel.mesh import pad_to, shard_loader_round_robin
from waveformml_tpu_torch.utils import tracing
from waveformml_tpu_torch.utils.profiler import SimpleProfiler

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
    """Fit, validate and test a task's model on one device, or as one rank
    of a data-parallel process group (see the module docstring).

    The arguments are the JAX ``Trainer``'s:

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
      ``log_scalars(values, step)`` and ``flush()``, or None;
    * ``profiler``: the section table and the ``torch.profiler`` trace of
      each ``fit``;
    * ``steps_per_dispatch``: accepted for the JAX CLI's sake; eager
      PyTorch has no dispatch to amortise, so every K steps one batch at a
      time, with the results of K = 1;
    * ``parallel``, ``tp``: ``"shard_map"`` or ``"gspmd"``; ``tp > 1``
      shards the model over a ``(dp, tp)`` grid of the ranks (the module
      docstring), which needs a process group whose size divides by
      ``tp``; ``tp = 1`` is data parallelism whatever ``parallel`` says.
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
                 seed: int = 0, logger=None, profiler: bool = False,
                 steps_per_dispatch: int = 1, parallel: str = "shard_map", tp: int = 1):
        #: the data-parallel process group (None: one device), this rank and
        #: the number of ranks
        self.group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
        self.rank = dist.get_rank() if self.group is not None else 0
        self.world_size = dist.get_world_size() if self.group is not None else 1
        self.check_engine(parallel, tp, self.world_size)
        self.parallel, self.tp = parallel, int(tp)
        self.config = config
        self.task = task
        self.device = resolve_device(device)
        if self.rank != 0:
            logger = None
        task.device = self.device
        task.model.to(self.device)
        if self.group is not None:
            # every rank starts from rank 0's weights and statistics, as every
            # JAX process initialises from one seed (a process's own draw
            # here comes from an unseeded generator)
            with torch.no_grad():
                for t in task.model.state_dict().values():
                    dist.broadcast(t, src=0, group=self.group)
        #: under tp > 1 the (data, model) grid and the model's shards on it
        self.mesh = make_mesh_2d(tp=self.tp) if self.tp > 1 else None
        self.tensor_parallel = (TensorParallel(task.model, self.mesh)
                                if self.mesh is not None else None)
        #: the group the gradients, loss, metrics and BatchNorm statistics are
        #: summed over, its size and this rank's index in it, and this rank's
        #: index in its model group
        self.data_group = self.mesh.data_group if self.mesh is not None else self.group
        self.dp = self.mesh.dp if self.mesh is not None else self.world_size
        self.data_index = self.mesh.data_index if self.mesh is not None else self.rank
        self.model_index = self.mesh.model_index if self.mesh is not None else 0
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
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self.generator = torch.Generator(device=self.device).manual_seed(
            _rank_seed(seed, self.data_index))
        task.generator = self.generator
        self.lr = oc.lr
        self.params = list(task.model.parameters())
        #: for each of ``params``, whether it is a block of a sharded parameter
        specs = self.tensor_parallel.specs if self.tensor_parallel is not None else {}
        self._sharded = [name in specs for name, _ in task.model.named_parameters()]
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
        self.simple_profiler = SimpleProfiler() if profiler else None
        #: the device marks after the last training step's forward and
        #: backward (``utils.tracing``: None unless tracing on the card)
        self._step_marks: Tuple = (None, None)

    @staticmethod
    def check_engine(parallel: str, tp: int, world: Optional[int] = None) -> None:
        """Raise ValueError for an engine the port does not run: a
        ``parallel`` other than ``"shard_map"`` and ``"gspmd"``, ``tp < 1``,
        or ``tp > 1`` over ``world`` ranks (1 without a process group; None:
        not known yet) that do not form a ``(world / tp, tp)`` grid."""
        if parallel not in ("shard_map", "gspmd"):
            raise ValueError(f"parallel must be 'shard_map' or 'gspmd', not {parallel!r}")
        tp = int(tp)
        if tp < 1:
            raise ValueError(f"tp must be 1 or more, not {tp}")
        if tp > 1 and world is not None and world % tp:
            raise ValueError(f"{world} devices cannot form a ({world // tp}, {tp}) mesh: "
                             f"tp={tp} needs a process group (--distributed) whose size "
                             f"divides by it")

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
        """Pad a block (``_loop_batch``: under a process group to the ranks'
        largest shapes, so every rank calls it), build its plans on the host
        and copy it to the device; returns the device batch, the host batch
        it was copied from, and the seconds of the two phases (host prep,
        copy in) on the host clock."""
        db, db_host, prep, h2d, _ = self._device_batch(block)
        return db, db_host, prep.seconds, h2d.seconds

    def _device_batch(self, block: FileBlock, id=None):
        """``device_batch``'s batches, its two spans (``trainer.host_prep``,
        ``trainer.h2d``, request id ``id``) and the device mark before the
        copy in (``tracing.device_event``)."""
        with tracing.span("trainer.host_prep", id=id) as prep:
            db_host = self._loop_batch(block)
        mark = tracing.device_event(self.device)
        with tracing.span("trainer.h2d", id=id) as h2d:
            db = self.task.to_device(db_host)
        return db, db_host, prep, h2d, mark

    def _loop_batch(self, block: FileBlock) -> Dict[str, np.ndarray]:
        """A loop's host batch: ``prepare_block`` at the block's buckets, or
        under a process group at the ranks' largest buckets, every array
        then padded to the ranks' largest shape (``pad_to``), so that every
        rank runs the same shapes."""
        task = self.task
        if self.group is None:
            return task.prepare_block(block, task.row_bucket(block), task.event_bucket(block))
        rb, eb = self._max_over_ranks([task.row_bucket(block), task.event_bucket(block)])
        db = task.prepare_block(block, rb, eb)
        keys = sorted(db)
        shapes = self._max_over_ranks([d for k in keys for d in db[k].shape])
        for k in keys:
            want, shapes = tuple(shapes[:db[k].ndim]), shapes[db[k].ndim:]
            db[k] = pad_to(db[k], want)
        return db

    # -- collectives over the ranks ---------------------------------------------------
    def _max_over_ranks(self, values: List[int]) -> List[int]:
        t = torch.tensor(values, dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t.tolist()

    def _sum_over_ranks(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each tensor summed over the data group, by one all-reduce of a
        float32 buffer that holds them all."""
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, group=self.data_group)
        out, pos = [], 0
        for t in tensors:
            out.append(flat[pos:pos + t.numel()].view(t.shape).to(t.dtype))
            pos += t.numel()
        return out

    def _shard(self, loader):
        """``loader``, or under a process group this data index's
        round-robin share of it."""
        if self.group is None:
            return loader
        sharded = shard_loader_round_robin(loader, self.dp, self.data_index)
        if len(sharded) == 0:
            raise RuntimeError(f"the loader has {len(loader)} batches for "
                               f"{self.dp} data ranks; each needs one at least")
        return sharded

    def _barrier(self) -> None:
        if self.group is None:
            return
        if dist.get_backend(self.group) == "nccl":
            dist.barrier(self.group, device_ids=[self.device.index])
        else:
            dist.barrier(self.group)

    # -- steps ------------------------------------------------------------------------
    def training_step(self, db: Dict[str, torch.Tensor]):
        """One micro-step on a device batch: ``loss = loss_sum / max(weight,
        1e-12)`` and its backward, then, on every ``accumulate_grad_batches``-th
        micro-step, the optimizer step with the micro-steps' mean gradient,
        clipped by ``gradient_clip_val``. Returns the loss and the metric
        sums (device tensors, detached). The parameters' ``.grad`` hold the
        gradients the optimizer stepped with, or this micro-step's own where
        it did not step, until the next micro-step.

        Under a process group the forward sums its BatchNorm statistics over
        the data group, ``weight`` is the group's sum (clamped after the sum,
        so an empty shard adds 0), and the gradients, the loss and the
        metrics are summed over the group, the BatchNorm running statistics
        averaged, before accumulation, clipping and the optimizer: every rank
        steps with the whole batch's gradient (of its blocks, under tp), as
        the JAX step's ``psum``.

        The step is span ``trainer.step`` (request id: ``global_step``)
        over ``trainer.forward``, ``trainer.backward`` and
        ``trainer.optimizer``; the device marks after the forward and the
        backward are kept in ``_step_marks``."""
        with tracing.span("trainer.step", id=self.global_step):
            with tracing.span("trainer.forward"):
                with synced_bn(self.data_group):
                    outputs = self.task.model_outputs(db, train=True)
                loss_sum, weight, metrics = self.task.loss_and_metrics(outputs, db)
                if self.group is not None:
                    weight = self._sum_over_ranks([weight])[0]
                loss = loss_sum / weight.clamp(min=1e-12)
            forward_done = tracing.device_event(self.device)
            with tracing.span("trainer.backward"):
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
            self._step_marks = (forward_done, tracing.device_event(self.device))
            with tracing.span("trainer.optimizer"):
                loss, metrics = self._optimizer_step(loss, metrics)
        self.global_step += 1
        return loss, metrics

    def _optimizer_step(self, loss: torch.Tensor, metrics: Dict[str, torch.Tensor]):
        """``training_step``'s part after the backward: the sums over the
        data group, accumulation, clipping and the optimizer's step."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        loss, metrics = loss.detach(), {k: v.detach() for k, v in metrics.items()}
        if self.group is not None:
            stats = _bn_running_stats(self.task.model)
            keys = list(metrics)
            summed = self._sum_over_ranks(grads + [loss] + [metrics[k] for k in keys] + stats)
            grads, loss = summed[:len(grads)], summed[len(grads)]
            metrics = dict(zip(keys, summed[len(grads) + 1:len(grads) + 1 + len(keys)]))
            with torch.no_grad():
                for b, total in zip(stats, summed[len(grads) + 1 + len(keys):]):
                    b.copy_(total / self.dp)
        if self.multi_steps is not None:
            grads = self.multi_steps.update(grads)
        if grads is not None:
            if self.gradient_clip_val:
                clip_by_global_norm_(grads, float(self.gradient_clip_val), self._sharded,
                                     self.mesh.model_group if self.mesh is not None else None)
            for p, g in zip(self.params, grads):
                p.grad = g
            self.optimizer.step()
        return loss, metrics

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
        with tracing.span("trainer.fit_start"):
            data_module.setup("fit")
            train_loader = self._shard(data_module.train_dataloader())
            data_module.setup("test")
            val_loader = self._shard(data_module.val_dataloader())
            if self.overfit_batches:
                self.limit_train_batches = self.overfit_batches
                self.limit_val_batches = self.overfit_batches
            # the JAX Trainer draws the training loader's first batch to build
            # its state: a shuffling loader's first order is drawn here too, so
            # that both train on the same batches in the same order
            for _ in _take(train_loader, 1):
                pass
            # the profile goes where the run logs, with or without a
            # TensorBoard logger (tensorboardX may not be installed)
            log_dir = getattr(self.logger, "log_dir", None) or self.checkpoint_dir
            trace = None
            if self.simple_profiler and log_dir:
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    activities.append(ProfilerActivity.CUDA)
                trace = profile(activities=activities)
                trace.start()
        try:
            metrics = self._fit_epochs(train_loader, val_loader)
        finally:
            if trace is not None:
                trace.stop()
                trace_dir = os.path.join(log_dir, "profile")
                os.makedirs(trace_dir, exist_ok=True)
                path = os.path.join(trace_dir,
                                    f"{socket.gethostname()}_{os.getpid()}.pt.trace.json")
                trace.export_chrome_trace(path)
                log.info("wrote the profiler trace to %s", path)
            if self.simple_profiler and log_dir:
                os.makedirs(log_dir, exist_ok=True)
                path = os.path.join(log_dir, "profile_results.txt")
                self.simple_profiler.describe(path)
                log.info("wrote profiler summary to %s", path)
        for cb in self.callbacks:
            if hasattr(cb, "on_train_end"):
                cb.on_train_end(self)
        if self.logger:
            self.logger.flush()
        return metrics

    def _fit_epochs(self, train_loader, val_loader) -> Dict[str, float]:
        """``fit``'s epochs: train, validate, checkpoint, the callbacks, the
        pruning hook, early stopping and the scheduler's step."""
        metrics: Dict[str, float] = {}
        while self.current_epoch < self.max_epochs:
            epoch_metrics = self._train_epoch(train_loader)
            metrics.update(epoch_metrics)
            with tracing.span("trainer.epoch_end") as end:
                stop = self._end_epoch(val_loader, epoch_metrics, metrics)
            if stop:
                break
            log.info("epoch %d done in %.1fs: %s", self.current_epoch,
                     self._epoch_wall[-1] + end.seconds, metrics)
            self.current_epoch += 1
            if self.terminate_on_nan and not math.isfinite(metrics.get("train_loss", 0.0)):
                log.error("non-finite loss: terminating")
                break
        return metrics

    def _end_epoch(self, val_loader, epoch_metrics: Dict[str, float],
                   metrics: Dict[str, float]) -> bool:
        """An epoch's end: validation, the checkpoint, the callbacks, the
        pruning hook and early stopping (True: ``fit`` stops here), the
        scheduler's step and the logger."""
        val_ran = (self.current_epoch + 1) % self.validation_freq == 0
        if val_ran:
            val_metrics = self._eval_epoch(val_loader, "val", self.limit_val_batches)
            metrics.update(val_metrics)
            epoch_metrics.update(val_metrics)
            self._maybe_checkpoint(val_metrics)
            for cb in self.callbacks:
                if hasattr(cb, "on_validation_end"):
                    cb.on_validation_end(self, val_metrics, self.current_epoch)
            if self.trial_prune_check(val_metrics):
                return True
            if self.early_stopping.update(val_metrics):
                log.info("early stopping at epoch %d", self.current_epoch)
                return True
        if self.scheduler is not None:
            # a plateau scheduler sees only a fresh validation loss
            new_lr = self.scheduler.step(metrics.get("val_loss") if val_ran else None)
            set_learning_rate(self.optimizer, new_lr)
            if self.logger:
                self.logger.log_scalar("lr", new_lr, self.current_epoch)
        if self.logger:
            # this epoch's own measurements only
            self.logger.log_scalars(epoch_metrics, self.current_epoch)
        return False

    def trial_prune_check(self, val_metrics: Dict[str, float]) -> bool:
        """The HPO pruning hook: report this epoch's ``val_loss`` to the
        task's trial and raise ``TrialPruned`` where its pruner says so."""
        trial = getattr(self.task, "trial", None)
        if trial is None:
            return False
        trial.report(val_metrics.get("val_loss", math.inf), self.current_epoch)
        if trial.should_prune():
            from waveformml_tpu_torch.optimization.hpo import TrialPruned

            raise TrialPruned()
        return False

    def _train_epoch(self, loader) -> Dict[str, float]:
        cuda = self.device.type == "cuda"
        losses: List[torch.Tensor] = []
        agg: Dict[str, torch.Tensor] = {}
        phases: List[Dict[str, Any]] = []
        rows = 0
        prof = self.simple_profiler
        with tracing.span("trainer.epoch") as epoch:
            for block in _take(loader, self._limit(loader, self.limit_train_batches), prof):
                step = self.global_step
                db, _, prep, h2d, before_h2d = self._device_batch(block, step)
                if prof:
                    prof.start("run_training_step")
                start = tracing.timing_event(self.device)
                loss, metrics = self.training_step(db)
                end = tracing.timing_event(self.device)
                forward_done, backward_done = self._step_marks
                tracing.device_span("trainer.h2d", before_h2d, start, step)
                tracing.device_span("trainer.forward", start, forward_done, step)
                tracing.device_span("trainer.backward", forward_done, backward_done, step)
                tracing.device_span("trainer.optimizer", backward_done, end, step)
                if prof:
                    # the section times the step's device work
                    if cuda:
                        torch.cuda.synchronize(self.device)
                    prof.stop("run_training_step")
                losses.append(loss)
                _accumulate(agg, metrics)
                rows += int(block.coords.shape[0])
                phases.append({"start": prep.start, "host_prep_s": prep.seconds,
                               "h2d_s": h2d.seconds, "events": self.task.n_events(block),
                               "cuda_events": (start, end) if cuda else None})
                if len(phases) == 1:
                    # the device spans up to the last epoch's wait, read while
                    # this first step runs and not while the card idles
                    tracing.resolve()
            # one wait per epoch: the losses and events are read after it
            with tracing.span("trainer.loss_read"):
                step_losses = [float(x) for x in losses]
        self._epoch_wall.append(epoch.seconds)
        self._epoch_rows.append(rows)
        for i, p in enumerate(phases):
            ev = p.pop("cuda_events")
            p["device_ms"] = ev[0].event.elapsed_time(ev[1].event) if ev else None
            p["wall_s"] = (phases[i + 1]["start"] if i + 1 < len(phases)
                           else epoch.end) - p.pop("start")
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
        outputs (numpy); a test pass records ``test_phases``. Under a
        process group each batch's loss sum, weight and metrics are summed
        over the data group; ``collect`` gets this rank's own batch and
        outputs, on model-index-0 ranks only (a model group computes one
        batch)."""
        cuda = self.device.type == "cuda"
        loss_sum, weight = 0.0, 0.0
        agg: Dict[str, torch.Tensor] = {}
        phases: List[Dict[str, Any]] = []
        with tracing.span(f"trainer.{prefix}") as pass_:
            for block in _take(loader, self._limit(loader, limit)):
                db, db_host, prep, h2d, _ = self._device_batch(block)
                if self.simple_profiler:
                    self.simple_profiler.start("evaluation_step")
                start = tracing.timing_event(self.device)
                outputs = self.task.model_outputs(db, train=False)
                end = tracing.timing_event(self.device)
                ls, w, metrics = self.task.loss_and_metrics(outputs, db)
                if self.group is not None:
                    keys = list(metrics)
                    ls, w, *values = self._sum_over_ranks([ls, w] + [metrics[k] for k in keys])
                    metrics = dict(zip(keys, values))
                loss_sum += float(ls)
                weight += float(w)
                if self.simple_profiler:
                    self.simple_profiler.stop("evaluation_step")
                _accumulate(agg, metrics)
                copy_back_s = collect_s = 0.0
                if collect is not None and self.model_index == 0:
                    n = (block.coords.shape[0] if self.task.output_unit == "row"
                         else self.task.n_events(block))
                    with tracing.span("trainer.copy_back") as copy_back:
                        test_out = {k: v[:n].cpu().numpy()
                                    for k, v in self.task.test_outputs(outputs, db).items()}
                    with tracing.span("trainer.collect") as collected:
                        collect(block, db_host, test_out)
                    copy_back_s, collect_s = copy_back.seconds, collected.seconds
                phases.append({"start": prep.start, "host_prep_s": prep.seconds,
                               "h2d_s": h2d.seconds, "cuda_events": (start, end) if cuda else None,
                               "copy_back_s": copy_back_s, "collect_s": collect_s,
                               "events": self.task.n_events(block)})
        for i, p in enumerate(phases):
            ev = p.pop("cuda_events")
            p["device_ms"] = ev[0].event.elapsed_time(ev[1].event) if ev else None
            p["wall_s"] = (phases[i + 1]["start"] if i + 1 < len(phases)
                           else pass_.end) - p.pop("start")
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
        return self._eval_epoch(self._shard(data_module.val_dataloader()), "val",
                                self.limit_val_batches)

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
        ``add_batch``. Under a process group the test loader is read
        round-robin, as ``fit`` reads its loaders, and each rank collects
        its own blocks (under tp, each model-index-0 rank)."""
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
        metrics = self._eval_epoch(self._shard(data_module.test_dataloader()), "test",
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
        Reload it with ``load_exported``. Under tp it raises: export from a
        one-rank Trainer that loads the run's checkpoint (the one-rank file)."""
        if self.tensor_parallel is not None:
            raise ValueError("a tensor-parallel model holds column blocks: export from a "
                             "one-rank Trainer that loads this run's checkpoint")
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
    def model_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's one-rank ``state_dict``: under tp its blocks gathered
        (a collective of every rank)."""
        state = self.task.model.state_dict()
        if self.tensor_parallel is not None:
            state = self.tensor_parallel.gather_params(state)
        return state

    def _per_param(self, tensors: List, whole: bool) -> List:
        """``tensors``, one a parameter (the optimizer's state or the
        accumulation's, in ``params`` order), with each block of a sharded
        parameter gathered whole (``whole``) or each whole one cut to this
        rank's block."""
        if self.tensor_parallel is None:
            return tensors
        tp = self.tensor_parallel
        out = []
        for t, (name, p) in zip(tensors, self.task.model.named_parameters()):
            spec = tp.specs.get(name)
            if spec is not None and torch.is_tensor(t) and t.dim() > 0:
                t = (gather_blocks(t, spec, tp.mesh) if whole
                     else block_of(t, spec, tp.mesh.tp, tp.mesh.model_index))
            out.append(t)
        return out

    def _optimizer_state(self, state: Dict[str, Any], whole: bool) -> Dict[str, Any]:
        """An optimizer ``state_dict`` with each sharded parameter's tensors
        gathered whole or cut to this rank's block (``_per_param``)."""
        if self.tensor_parallel is None:
            return state
        n = len(self.params)
        per = [state["state"].get(i, {}) for i in range(n)]
        keys = sorted({k for d in per for k in d})
        by_key = {k: self._per_param([d.get(k) for d in per], whole) for k in keys}
        new = {i: {k: by_key[k][i] for k in per[i]} for i in range(n) if per[i]}
        return {**state, "state": new}

    def save_checkpoint(self, path: str) -> None:
        """One ``torch.save`` file: the model's ``state_dict``, the
        optimizer's, the scheduler's and the gradient accumulation's state,
        the epoch, the micro-step count and the best validation loss. Under
        a process group every rank calls it, rank 0 writes the file and the
        others wait for it. Under tp the file holds the one-rank state
        (every parameter, its optimizer state and accumulation gathered
        whole): the file a one-rank run writes."""
        state = self.model_state_dict()
        optimizer = self._optimizer_state(self.optimizer.state_dict(), whole=True)
        multi_steps = None
        if self.multi_steps is not None:
            multi_steps = self.multi_steps.state_dict()
            multi_steps["acc"] = self._per_param(multi_steps["acc"], whole=True)
        if self.rank == 0:
            torch.save({"state_dict": state, "optimizer": optimizer,
                        "scheduler": (self.scheduler.state_dict()
                                      if self.scheduler is not None else None),
                        "multi_steps": multi_steps,
                        "epoch": self.current_epoch, "step": self.global_step,
                        "best_val_loss": self.best_val_loss}, path)
        self._barrier()

    def load_checkpoint(self, path: str, restore_training: bool = False) -> None:
        """Load a checkpoint's weights; with ``restore_training`` also the
        optimizer, the scheduler, the gradient accumulation, the epoch, the
        micro-step count and the best validation loss, so that ``fit``
        resumes at the saved epoch. Under tp the checkpoint (a one-rank
        file) is cut to this rank's blocks."""
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        state = ckpt["state_dict"]
        if self.tensor_parallel is not None:
            state = self.tensor_parallel.shard_params(state)
        self.task.model.load_state_dict(state)
        if not restore_training:
            return
        self.optimizer.load_state_dict(self._optimizer_state(ckpt["optimizer"], whole=False))
        if self.scheduler is not None and ckpt.get("scheduler") is not None:
            self.scheduler.load_state_dict(ckpt["scheduler"])
        if self.multi_steps is not None and ckpt.get("multi_steps") is not None:
            multi_steps = dict(ckpt["multi_steps"])
            multi_steps["acc"] = self._per_param(multi_steps["acc"], whole=False)
            self.multi_steps.load_state_dict(multi_steps)
        self.current_epoch = ckpt["epoch"]
        self.global_step = ckpt.get("step", 0)
        self.best_val_loss = ckpt.get("best_val_loss", math.inf)

    def _maybe_checkpoint(self, val_metrics: Dict[str, float]) -> None:
        vl = val_metrics.get("val_loss")
        if vl is None or not self.checkpoint_dir or not vl < self.best_val_loss:
            return
        self.best_val_loss = vl
        path = os.path.join(self.checkpoint_dir,
                            f"epoch={self.current_epoch}-val_loss={vl:.2f}.ckpt")
        if self.rank == 0:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
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
        loader = self._shard(data_module.train_dataloader())
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
        return self.task.forward_model(db).float()


def load_exported(path: str, device: Optional[Union[str, torch.device]] = None
                  ) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """The program that ``Trainer.export_model`` wrote, as a function of a
    device batch dict (``Trainer.device_batch``'s keys and shapes) that
    returns the model's outputs, without gradients. It runs on the device it
    was exported on, which must be ``device`` (None: the card); the custom
    ops of the kernels are registered first. A batch of other shapes (another
    row or event bucket) raises through the program's own shape guard. The
    program runs with cuDNN's float32 convolutions and recurrences in full
    float32, as the eager forward runs them
    (``ops.sparse_conv.ieee_fp32``): the flag that the eager layers
    set is the process's, not the graph's."""
    from waveformml_tpu_torch.ops import row_conv, site_head, waveform_features  # noqa: F401
    from waveformml_tpu_torch.ops.sparse_conv import ieee_fp32

    dev = resolve_device(device)
    program = torch.export.load(path)
    on = {t.device.type for t in program.state_dict.values()}
    if on - {dev.type}:
        raise ValueError(f"{path} was exported on {sorted(on)}, not {dev.type}")
    module = program.module()

    def forward(db: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad(), ieee_fp32():
            return module({k: v.to(dev) for k, v in db.items()})

    return forward


def _bn_running_stats(model: torch.nn.Module) -> List[torch.Tensor]:
    """The running means and variances of ``model``'s BatchNorms, the
    buffers the JAX step averages over its devices (``pmean`` of
    ``batch_stats``)."""
    return [t for m in model.modules() if isinstance(m, (MaskedArrayBatchNorm, _FlaxBatchNorm))
            for t in (m.running_mean, m.running_var)]


def _rank_seed(seed: int, rank: int) -> int:
    """The dropout stream's seed of a data rank (under tp, of every rank of
    its model group): ``seed`` on rank 0 (so that a group of one draws what
    one device draws), else one drawn from ``(seed, rank)``, as the JAX
    step folds the device index into its key."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1, np.uint64)[0] >> 1)


def _take(loader, n: int, profiler: Optional[SimpleProfiler] = None) -> Iterator:
    """The first ``n`` items of ``loader``; the loader's iterator is closed
    after them (which stops a prefetch thread). Each draw from the loader
    is timed as ``get_train_batch`` in ``profiler``, where given."""
    it = iter(loader)
    try:
        for _ in range(n):
            if profiler:
                profiler.start("get_train_batch")
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                if profiler:
                    profiler.stop("get_train_batch")
            yield item
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
