"""Serving through ``InferenceModel.dispatch`` and ``fetch``: a closed loop
over the cell's pool of chunks with up to ``depth`` chunks in flight, the
oldest fetched when the FIFO is full, as the prediction writers drive the
model.

Set-up loads the seeded weights into an ``InferenceModel`` and passes every
chunk of the pool through it once (each layout is captured as a CUDA graph
there), then runs the loop for two FIFOs' worth of chunks. The window
dispatches until ``--seconds`` have passed and then fetches what is in
flight. ``serve_events_per_s`` is the events of every chunk fetched over the
window's wall; ``serve_chunk_ms_p95`` the 95th percentile of the time from a
chunk's ``dispatch`` call to the return of its ``fetch``. A sample of the
fetched chunks, drawn from the seed (reservoir sampling), is kept for the
check.

After the window of a traced run the benchmark passes the pool eagerly
through the same model in evaluation mode, twice, timing the grid ops'
modules in the second pass: a graph replay runs no Python, so no hook sees
its layers.
"""
from __future__ import annotations

import gc
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from portbench import compare, trace
from portbench.harness import Run, load_module
from portbench.timing import layer_timer


@dataclass
class State:
    model: object
    work: List[Dict]
    kept: List = field(default_factory=list)


class Loop:
    """The closed loop's FIFO and what it records of each fetched chunk."""

    def __init__(self, model, pool, depth: int, keep: int = 0, rng=None):
        self.model, self.pool, self.depth = model, pool, depth
        self.fifo = deque()
        self.latency: List[float] = []
        self.events = 0
        self.fetched = 0
        self.dispatched = 0
        self.keep, self.rng = keep, rng
        self.kept: List = []

    def dispatch(self) -> None:
        if len(self.fifo) == self.depth:
            self.fetch()
        idx = self.dispatched % len(self.pool)
        c = self.pool[idx]
        t = time.perf_counter()
        h = self.model.dispatch(c.coords, c.feats)
        self.fifo.append((t, h, idx))
        self.dispatched += 1

    def fetch(self) -> None:
        t, h, idx = self.fifo.popleft()
        out = self.model.fetch(h)
        self.latency.append(time.perf_counter() - t)
        self.events += h.n_events
        self.fetched += 1
        if self.keep:
            if len(self.kept) < self.keep:
                self.kept.append((idx, np.array(out)))
            else:
                j = int(self.rng.integers(0, self.fetched))
                if j < self.keep:
                    self.kept[j] = (idx, np.array(out))

    def drain(self) -> None:
        while self.fifo:
            self.fetch()


def setup(run: Run) -> State:
    from waveformml_tpu_torch.inference.model import InferenceModel

    weights = run.weights()
    run.mark("weights")
    model = InferenceModel(run.program_config, weights, device=run.device)
    run.mark("model")
    for c in run.pool:
        model.fetch(model.dispatch(c.coords, c.feats))
    run.mark("capture")
    depth = int(run.traffic["depth"])
    warm = Loop(model, run.pool, depth)
    for _ in range(2 * depth):
        warm.dispatch()
    warm.drain()
    run.mark("warm-up loop")
    # the per-layer readers' operations and bytes: a traced run's alone
    work = run.work("serve") if run.trace else []
    run.mark("work")
    return State(model, work)


def window(run: Run, st: State) -> Dict:
    model = st.model
    if run.trace:
        trace.wrap(model, "dispatch", "portbench.dispatch")
        trace.wrap(model, "fetch", "portbench.fetch")
    rng = np.random.default_rng([run.seed % 2 ** 63, 1])
    loop = Loop(model, run.pool, int(run.traffic["depth"]), int(run.traffic["check_sample"]),
                rng)
    prep0 = model.dispatch_phases["host_prep_s"]
    t = time.perf_counter()
    while time.perf_counter() - t < run.seconds:
        loop.dispatch()
    loop.drain()
    window_s = time.perf_counter() - t
    st.kept = loop.kept
    lat_ms = np.asarray(loop.latency) * 1e3
    return {"mode": "serve", "window_s": window_s, "chunks": loop.fetched,
            "work": [st.work[i % len(st.work)] for i in range(loop.fetched)] if st.work else [],
            "host_prep_s": model.dispatch_phases["host_prep_s"] - prep0,
            "grid_ms": None, "grid_work": None,
            "attempted": loop.dispatched, "failed": loop.dispatched - loop.fetched,
            "e2e": {"serve_events_per_s": loop.events / window_s,
                    "serve_chunk_ms_p95": float(np.percentile(lat_ms, 95))}}


def after_window(run: Run, st: State, records: Dict) -> None:
    """Time the grid ops' modules over the pool in an eager evaluation pass
    (the second of two)."""
    from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock

    task = st.model.task
    dbs = []
    for c in run.pool:
        block = FileBlock(coords=c.coords, feats=c.feats, labels=c.labels)
        dbs.append(task.to_device(task.prepare_block(block, task.row_bucket(block),
                                                     task.event_bucket(block))))
    for db in dbs:
        task.apply_model(db)
    timer = layer_timer(task.model, run.config["grid_modules"], run.device)
    if timer is None:
        return
    for db in dbs:
        task.apply_model(db)
    timer.remove()
    records["grid_ms"] = timer.total_ms()
    records["grid_work"] = st.work


def release(st: State) -> None:
    st.model = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def check(run: Run, st: State, records: Dict) -> Dict:
    ref = load_module("reference", run.cell["config"])
    weights = run.weights()
    refs = {}
    for idx, _ in st.kept:
        if idx not in refs:
            refs[idx] = ref.serve(run.config["config"], weights, run.pool[idx])
    err = compare.serve_error([o for _, o in st.kept], [refs[i] for i, _ in st.kept])
    return {"serve_error": err if st.kept else None}
