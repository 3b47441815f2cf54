"""Training through ``Trainer.fit``: the cell's pool of step blocks, one
epoch of the pool a ``fit`` call, no validation.

Set-up builds the task and the ``Trainer`` once, loads the seeded weights
and drives the same trainer through its first three steps, as the window
drives it: an epoch of one block (the optimizer's state then gives the first
gradient), an epoch of two more (the parameters then give the change after
three steps), then an epoch over the whole pool, which warms up every shape
the window uses. A forward hook on the model keeps the first step's output (its logits or
map over the step's events) for the check. The window runs whole epochs of
the pool until
``--seconds`` have passed; each ends with the wait for its losses, so the
window's wall covers all its steps' device work. ``train_events_per_s`` is
the events of the window's steps over that wall.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from portbench import compare, trace
from portbench.harness import Run, load_module
from portbench.timing import layer_timer


class Blocks:
    """In-memory training blocks behind the data-module interface
    ``Trainer.fit`` reads (no validation blocks)."""

    def __init__(self, blocks):
        self.blocks = list(blocks)

    def setup(self, stage=None) -> None:
        """Nothing to load."""

    def train_dataloader(self):
        return list(self.blocks)

    def val_dataloader(self):
        return []

    def test_dataloader(self):
        return []


@dataclass
class State:
    trainer: object
    data: Blocks
    program: Dict
    work: List[Dict]


def fit_epoch(trainer, data: Blocks) -> None:
    """One more epoch of ``trainer`` over ``data`` through ``fit``."""
    trainer.max_epochs = trainer.current_epoch + 1
    trainer.fit(data)


def first_gradient(trainer) -> Optional[Dict[str, torch.Tensor]]:
    """Each parameter's first gradient, worked out from the optimizer's
    state after one step: SGD's momentum buffer, the gradient itself on the
    first step without weight decay; None for another optimizer (the check
    then fails)."""
    out = {}
    names = dict((id(p), n) for n, p in trainer.task.model.named_parameters())
    for group in trainer.optimizer.param_groups:
        for p in group["params"]:
            st = trainer.optimizer.state.get(p, {})
            if st.get("momentum_buffer") is None or group.get("weight_decay"):
                return None
            out[names[id(p)]] = st["momentum_buffer"].detach().cpu().clone()
    return out


def setup(run: Run) -> State:
    from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
    from waveformml_tpu_torch.engineering.trainer import Trainer
    from waveformml_tpu_torch.registry import retrieve_class

    cfg = run.program_config
    task = retrieve_class(cfg.run_config.run_class)(cfg, run.device)
    run.mark("model")
    task.model.load_state_dict(run.weights())
    run.mark("weights")
    start = {n: p.detach().cpu().clone() for n, p in task.model.named_parameters()}
    trainer = Trainer(cfg, task, run.device, callbacks=[], max_epochs=0,
                      seed=run.seed % 2 ** 63, terminate_on_nan=False)
    run.mark("trainer")
    # no validation: the cell's traffic is the training steps alone
    trainer.validation_freq = 1 << 30
    blocks = [FileBlock(coords=c.coords, feats=c.feats, labels=c.labels) for c in run.pool]
    if len(blocks) < 3:
        raise ValueError("a training pool needs 3 blocks at least (the checked steps)")
    outs: List[torch.Tensor] = []

    def keep_first(module, args, out):
        if not outs and isinstance(out, torch.Tensor):
            outs.append(out.detach().float().cpu())

    hook = task.model.register_forward_hook(keep_first)
    fit_epoch(trainer, Blocks(blocks[:1]))
    hook.remove()
    run.mark("step 1")
    grad1 = first_gradient(trainer)
    fit_epoch(trainer, Blocks(blocks[1:3]))
    run.mark("steps 2-3")
    delta = {n: p.detach().cpu() - start[n] for n, p in task.model.named_parameters()}
    out1 = outs[0][:run.pool[0].n_events] if outs else None
    program = {"losses": list(trainer.step_losses[:3]), "grad1": grad1, "delta": delta,
               "out1": out1}
    data = Blocks(blocks)
    fit_epoch(trainer, data)
    run.mark("warm-up epoch")
    # the per-layer readers' operations and bytes: a traced run's alone
    work = run.work("train") if run.trace else []
    run.mark("work")
    return State(trainer, data, program, work)


def window(run: Run, st: State) -> Dict:
    trainer = st.trainer
    timer = None
    if run.trace:
        timer = layer_timer(trainer.task.model, run.config["grid_modules"], run.device)
        trace.wrap(trainer.task, "prepare_block", "portbench.prepare_block")
        trace.wrap(trainer.task, "to_device", "portbench.to_device")
        trace.wrap(trainer, "training_step", "portbench.training_step")
    n0 = len(trainer.step_phases)
    t = time.perf_counter()
    while True:
        fit_epoch(trainer, st.data)
        if time.perf_counter() - t >= run.seconds:
            break
    window_s = time.perf_counter() - t
    steps = trainer.step_phases[n0:]
    grid_ms = None
    if timer is not None:
        timer.remove()
        grid_ms = timer.total_ms()
    work = [st.work[i % len(st.work)] for i in range(len(steps))] if st.work else []
    events = sum(s["events"] for s in steps)
    return {"mode": "train", "window_s": window_s, "steps": steps, "work": work,
            "grid_ms": grid_ms, "attempted": len(steps), "failed": 0,
            "e2e": {"train_events_per_s": events / window_s}}


def after_window(run: Run, st: State, records: Dict) -> None:
    """Nothing: the window's own steps were timed."""


def release(st: State) -> None:
    st.trainer = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(run: Run, st: State, records: Dict) -> Dict:
    ref = load_module("reference", run.cell["config"])
    out = ref.train_steps(run.config["config"], run.weights(), run.pool[:3], [0, 1, 1])
    return compare.train_numbers(st.program, out)
