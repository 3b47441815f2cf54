"""Frozen-model batched inference (counterpart of
waveformml_tpu/inference/model.py).

``InferenceModel`` pads each ragged chunk of events to a row bucket and an
event bucket, builds the model's plans on the host and packs the whole
prepared batch into one pinned host buffer (``engineering.base.pack_db``).
On the card, each layout of that buffer (the row bucket, the event bucket,
the site capacity, a graph model's edge caps, the dtypes) is captured
once as a CUDA graph, the JAX
package's compiled program per layout; every chunk then costs one copy in
to that graph's static buffer, one replay and an asynchronous copy of the
outputs into pinned host memory, with nothing waiting for the card until
``fetch``. On the CPU the forward runs eagerly. ``dispatch_phases`` sums
the host-clock seconds of each phase over calls.

Each phase is a ``utils.tracing`` span whose request id is the chunk's
number (``Handle.chunk``): ``serve.dispatch`` over ``serve.host_prep``,
``serve.capture`` (a new layout), ``serve.h2d`` and ``serve.launch``, then
``serve.fetch`` over ``serve.fetch_wait``. While tracing is active on the
card, a chunk adds the device spans ``serve.h2d`` (its copy in) and
``serve.device`` (from before its copy in to its outputs' arrival in
pinned memory; its begin event's enqueue time gives the wait on the
stream), and each capture adds 1 to the counter ``serve.captures``.

``dispatch`` belongs to one thread; ``fetch`` may run on several at once
(the prediction writers' fetch workers). A new layout is captured while
those threads wait on earlier chunks' events, so the capture is
thread-local: CUDA calls of other threads neither invalidate it nor are
refused during it, and it still raises on any unsafe call of its own
thread.
"""
from __future__ import annotations

import itertools
import logging
import os
import threading
from typing import Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.device import resolve_device
from waveformml_tpu_torch.engineering.base import PackSpec, pack_db, unpack_db
from waveformml_tpu_torch.ops.row_conv import (subm_conv_rows, subm_conv_rows_plan,
                                               subm_conv_rows_wgrad)
from waveformml_tpu_torch.ops.site_head import site_grouped_matmul, site_grouped_matmul_bwd
from waveformml_tpu_torch.ops.waveform_features import waveform_features
from waveformml_tpu_torch.registry import retrieve_class
from waveformml_tpu_torch.utils import tracing

log = logging.getLogger(__name__)

#: the kernel wrappers whose launches a captured graph counts
KERNELS = (subm_conv_rows, site_grouped_matmul, waveform_features, subm_conv_rows_wgrad,
           site_grouped_matmul_bwd, subm_conv_rows_plan)


class Handle(NamedTuple):
    """A dispatched chunk: its outputs (on the host, or being copied there
    until ``ready`` has passed), its real rows and events, its buckets and
    its number among the model's dispatches."""

    out: torch.Tensor
    ready: Optional[torch.cuda.Event]
    n_rows: int
    n_events: int
    row_bucket: int
    event_bucket: int
    chunk: int = -1


class _Graph:
    """One layout's captured forward: its static input buffer and output,
    the kernel launches one replay makes, and its replays so far."""

    def __init__(self, graph: torch.cuda.CUDAGraph, static_in: torch.Tensor,
                 static_out: torch.Tensor, launches: Dict[str, int]):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.launches = launches
        self.replays = 0


class InferenceModel:
    """A task's model with frozen weights, serving chunks of events.

    ``state_dict_or_path`` is a ``state_dict`` (e.g. from
    ``convert.flax_to_state_dict``), the path of one saved with
    ``torch.save``, or the path of a ``Trainer`` checkpoint. ``device=None``
    means the card; pass ``device="cpu"`` to run the plain PyTorch versions
    of the kernels on the CPU.

    ``preprocess(coords, feats, mask) -> feats`` and ``postprocess(outputs,
    coords, mask) -> outputs`` run on the device, inside the captured
    forward: with a ``preprocess`` the raw ``vals`` dtype ships as it is
    (e.g. int16 ADC counts, half the bytes of float32), without one ``vals``
    are cast to float32 on the host, except float16 ``vals`` under the
    config's ``half_precision``, which ship as they are (the forward casts
    the features to bf16 on the device, inside the captured graph).
    ``output_unit`` ("row", "event" or
    "auto") says whether the outputs' leading axis is the padded rows or
    the padded events, for ``fetch`` to cut; "auto" infers it from the
    shape; where both buckets are equal it takes rows for a per-row task
    (its ``output_unit``) without a ``postprocess``, which may change the
    unit, and otherwise events, with a warning.
    A graph capture that fails raises.
    """

    def __init__(self, config, state_dict_or_path: Union[str, os.PathLike,
                                                         Dict[str, torch.Tensor]],
                 device: Optional[Union[str, torch.device]] = None,
                 preprocess: Optional[Callable] = None,
                 postprocess: Optional[Callable] = None, output_unit: str = "auto"):
        if output_unit not in ("auto", "row", "event"):
            raise ValueError(f"output_unit must be auto/row/event, got {output_unit!r}")
        self.config = config
        self.device = resolve_device(device)
        self.task = retrieve_class(config.run_config.run_class)(config, self.device)
        state = state_dict_or_path
        if isinstance(state, (str, os.PathLike)):
            state = torch.load(state, map_location=self.device, weights_only=True)
            # a Trainer checkpoint holds the model's state_dict beside the
            # optimizer's and the scheduler's
            state = state.get("state_dict", state)
        self.task.model.load_state_dict(state)
        self.task.model.eval()
        self.preprocess = preprocess
        self.postprocess = postprocess
        self.output_unit = output_unit
        self._warned_ambiguous = False
        #: captured forward per packed-batch layout (on the card)
        self.graphs: Dict[PackSpec, _Graph] = {}
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        #: host-clock seconds summed over calls: host prep (pad, plans,
        #: a graph model's edges, pack), the copy in, the launch (a graph
        #: replay and the enqueue of the copy out on the card; the eager
        #: forward on the CPU) and the fetch (wait for the outputs, un-pad);
        #: for a graph model also ``edge_build_s``, the part of host prep
        #: that built its edges
        self.dispatch_phases = {"host_prep_s": 0.0, "h2d_s": 0.0,
                                "launch_s": 0.0, "fetch_s": 0.0}
        if self.task.is_graph:
            self.dispatch_phases["edge_build_s"] = 0.0
        #: host-clock seconds of warming up and capturing new layouts
        self.capture_s = 0.0
        # guards the counters that concurrent fetches update
        self._fetch_lock = threading.Lock()
        self._chunks = itertools.count()

    # -- the forward --------------------------------------------------------------------
    def _forward(self, db: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.preprocess is not None:
            db = dict(db)
            db["feats"] = self.preprocess(db["coords"], db["feats"], db["mask"])
        out = self.task.apply_model(db)
        if self.postprocess is not None:
            out = self.postprocess(out, db["coords"], db["mask"])
        return out

    def _capture(self, packed: torch.Tensor, spec: PackSpec) -> _Graph:
        """Warm a new layout up eagerly on a side stream (loads the kernels'
        libraries and sets their one-time attributes), then capture its
        forward over a static input buffer into the shared memory pool. The
        capture is thread-local: other threads may wait on events or free
        pinned buffers meanwhile (see the module's docstring)."""
        static_in = torch.empty(packed.shape, dtype=torch.uint8, device=self.device)
        static_in.copy_(packed, non_blocking=True)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._forward(unpack_db(static_in, spec))
        torch.cuda.current_stream(self.device).wait_stream(side)
        before = {fn.__name__: fn.captured for fn in KERNELS}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
            static_out = self._forward(unpack_db(static_in, spec))
        launches = {fn.__name__: fn.captured - before[fn.__name__] for fn in KERNELS}
        return _Graph(graph, static_in, static_out, launches)

    def replay_launches(self) -> Dict[str, int]:
        """Kernel launches made by graph replays so far, by wrapper name:
        each graph's launches per replay (counted at its capture) times its
        replays."""
        out = {fn.__name__: 0 for fn in KERNELS}
        for g in self.graphs.values():
            for name, n in g.launches.items():
                out[name] += n * g.replays
        return out

    # -- serving ------------------------------------------------------------------------
    def dispatch(self, coords: np.ndarray, vals: np.ndarray) -> Handle:
        """Pad, build plans, copy and launch the forward of one chunk
        (coords [N, 3] with event ids 0..B-1, or [N] per-waveform detector
        ids, each row its own event; vals [N, F]) without waiting for the
        device; returns a handle for ``fetch``. Its outputs are its own:
        later dispatches do not overwrite them."""
        chunk = next(self._chunks)
        with tracing.span("serve.dispatch", id=chunk):
            n = coords.shape[0]
            if coords.ndim == 1:
                n_events = n
            else:
                n_events = int(coords[:, -1].max()) + 1 if n else 0
            vals = np.asarray(vals)
            keep = (np.float32, np.float16) if self.task.half_precision else (np.float32,)
            if self.preprocess is None and vals.dtype not in keep:
                vals = vals.astype(np.float32)
            with tracing.span("serve.host_prep") as prep:
                # tasks that pad labels alongside the rows take a dummy label a row
                labels = (np.zeros((max(1, n),), np.float32) if self.task.labels_per_row
                          else np.zeros((max(1, n_events),), np.int64))
                block = FileBlock(coords=np.asarray(coords, dtype=np.int32), feats=vals,
                                  labels=labels)
                rb, eb = self.task.row_bucket(block), self.task.event_bucket(block)
                edge_s = self.task.edge_build_s
                db = self.task.prepare_block(block, rb, eb)
                if self.device.type != "cpu":
                    packed, spec = pack_db(db, pin_memory=True)
            if self.task.is_graph:
                self.dispatch_phases["edge_build_s"] += self.task.edge_build_s - edge_s
            if self.device.type == "cpu":
                with tracing.span("serve.h2d") as h2d:
                    dev = self.task.to_device(db)
                with tracing.span("serve.launch") as launch:
                    out, ready = self._forward(dev), None
            else:
                g = self.graphs.get(spec)
                if g is None:
                    with tracing.span("serve.capture") as capture:
                        g = self.graphs[spec] = self._capture(packed, spec)
                    self.capture_s += capture.seconds
                    tracing.count("serve.captures")
                before = tracing.device_event(self.device)
                with tracing.span("serve.h2d") as h2d:
                    g.static_in.copy_(packed, non_blocking=True)
                copied = tracing.device_event(self.device)
                with tracing.span("serve.launch") as launch:
                    g.graph.replay()
                    g.replays += 1
                    out = torch.empty(g.static_out.shape, dtype=g.static_out.dtype,
                                      pin_memory=True)
                    out.copy_(g.static_out, non_blocking=True)
                    done = tracing.device_event(self.device)
                    if done is not None:
                        ready = done.event
                    else:
                        ready = torch.cuda.Event()
                        ready.record()
                tracing.device_span("serve.h2d", before, copied)
                tracing.device_span("serve.device", before, done)
        self.dispatch_phases["host_prep_s"] += prep.seconds
        self.dispatch_phases["h2d_s"] += h2d.seconds
        self.dispatch_phases["launch_s"] += launch.seconds
        return Handle(out, ready, n, n_events, rb, eb, chunk)

    def fetch(self, handle: Handle) -> np.ndarray:
        """Wait for a dispatched chunk and return its outputs without the
        padding: the real events of per-event outputs, the real rows of
        per-row ones (``output_unit``)."""
        with tracing.span("serve.fetch", id=handle.chunk) as fetch:
            if handle.ready is not None:
                with tracing.span("serve.fetch_wait"):
                    handle.ready.synchronize()
            out = handle.out.numpy()
            result = self._unpad(out, handle)
        with self._fetch_lock:
            self.dispatch_phases["fetch_s"] += fetch.seconds
        return result

    def _unpad(self, out: np.ndarray, h: Handle) -> np.ndarray:
        if self.output_unit == "row" and out.shape[0] == h.row_bucket:
            return out[:h.n_rows]
        if self.output_unit == "event" and out.shape[0] == h.event_bucket:
            return out[:h.n_events]
        if (out.shape[0] == h.event_bucket == h.row_bucket and self.postprocess is None
                and self.task.output_unit == "row"):
            # a per-row task's own outputs
            return out[:h.n_rows]
        if out.shape[0] == h.event_bucket:
            if (self.output_unit == "auto" and h.event_bucket == h.row_bucket
                    and not self._warned_ambiguous):
                self._warned_ambiguous = True
                log.warning("row bucket == event bucket (%d): cannot tell per-row "
                            "from per-event outputs; assuming per-event. Construct "
                            "InferenceModel with output_unit='row'/'event' to "
                            "disambiguate.", h.row_bucket)
            return out[:h.n_events]
        if out.shape[0] == h.row_bucket:
            return out[:h.n_rows]
        return out

    def __call__(self, coords: np.ndarray, vals: np.ndarray) -> np.ndarray:
        """Ragged chunk → model outputs without the padding (synchronous)."""
        return self.fetch(self.dispatch(coords, vals))
