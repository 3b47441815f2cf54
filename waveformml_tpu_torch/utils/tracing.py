"""The port's one tracer: named host spans, device spans and counters.

Every section the port times goes through ``span``::

    with tracing.span("trainer.step", id=step) as s:
        ...
    s.seconds        # its host-clock seconds (time.perf_counter), always

Tracing is active exactly while a ``torch.profiler`` session records in the
process (``torch.autograd.profiler._is_profiler_enabled``): a traced
benchmark window, ``main --profiler``. There is no flag of its own.
Inactive, a span costs one boolean check beside its ``perf_counter`` pair,
and nothing else here records anything. While tracing is active:

* a span also enters a profiler range of its name (``record_function``, in
  its C++ form ``_RecordFunctionFast``), so it sits in the profiler's
  trace on the same clock as the device's activity, and
  appends a record to the store: its name, start and end
  (``perf_counter_ns``), its parent span, its thread and its request id
  (``id``: a training step's ``global_step``, a served chunk's number;
  a span without one takes its parent's);
* ``device_event(device)`` records a timing CUDA event on the current
  stream (on the card, and never while that stream captures a graph) and
  returns it as a ``Mark``, with the host time it was enqueued;
  ``device_span(name, begin, end)`` stores the device time between two
  marks, and ``backward_span`` that of a module's backward;
* ``count(name, n)`` adds to a counter.

Device times are put on the host spans' clock through an anchor: a timing
event recorded on a side stream that nothing else uses, so that it passes
at once, and waited for there (never on the stream of the work measured).
A mark's time is its anchor's host time plus the events' elapsed time.
Device spans are resolved lazily, when ``resolve()`` is called (the
Trainer calls it once an epoch, after its first step is launched, which
reads what its last epoch's wait for the losses let pass) or when the
store is read; each resolve that finds work lays a new anchor and records
how far the device clock drifted from the host's since the last one.

``records()`` returns what was recorded since the process started or since
``clear()``: ``spans``, ``device_spans``, ``counters``, ``anchors`` and
``dropped``, the records refused beyond ``CAP``. The store is shared by
every thread (fetch workers, autograd's device threads) under one lock.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

#: records kept at most, host and device spans together; more are dropped
#: and counted
CAP = 200_000

#: the profiler's range a span enters: ``record_function``'s C++ form,
#: which costs ~1 µs where the Python ``record_function`` costs 10-80 µs,
#: its own clock reads falling anywhere inside that
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)

_SEQ = itertools.count()
_LOCAL = threading.local()


def active() -> bool:
    """Whether a ``torch.profiler`` session records in this process."""
    return _profiler._is_profiler_enabled


def _stack() -> List["span"]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def current_id():
    """The request id of this thread's innermost open span (None where
    there is none, or tracing is not active)."""
    stack = _stack()
    return stack[-1].id if stack else None


class span:
    """A named host section (see the module docstring): ``seconds``,
    ``start`` and ``end`` on ``time.perf_counter``'s clock. Usable as a
    context manager, or opened and closed by ``open()`` and ``close()``
    (``utils.profiler.SimpleProfiler``'s start and stop)."""

    __slots__ = ("name", "id", "start", "end", "seconds", "_rf", "_seq", "_parent", "_ns")

    def __init__(self, name: str, id=None):
        self.name, self.id = name, id
        self.start = self.end = None
        self.seconds = 0.0
        self._rf = None

    def open(self) -> "span":
        if _profiler._is_profiler_enabled:
            stack = _stack()
            parent = stack[-1] if stack else None
            if self.id is None and parent is not None:
                self.id = parent.id
            self._parent = parent._seq if parent is not None else None
            self._seq = next(_SEQ)
            stack.append(self)
            self._rf = _RANGE(self.name)
            self._rf.__enter__()
            self._ns = time.perf_counter_ns()
        self.start = time.perf_counter()
        return self

    def close(self, *exc) -> None:
        self.end = time.perf_counter()
        self.seconds = self.end - self.start
        if self._rf is not None:
            end_ns = time.perf_counter_ns()
            self._rf.__exit__(*(exc or (None, None, None)))
            self._rf = None
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:
                stack.remove(self)
            _STORE.add("spans", {"name": self.name, "id": self.id, "start_ns": self._ns,
                                 "end_ns": end_ns, "seq": self._seq, "parent": self._parent,
                                 "thread": threading.get_native_id()})

    __enter__ = open

    def __exit__(self, *exc) -> bool:
        self.close(*exc)
        return False


class Mark:
    """A timing CUDA event recorded on a stream: ``host_ns`` is the host
    time just before its record was enqueued and ``anchor`` the anchor it
    is read against (both None for a plain event no span reads)."""

    __slots__ = ("event", "host_ns", "anchor")

    def __init__(self, event, host_ns: Optional[int], anchor: Optional["_Anchor"]):
        self.event, self.host_ns, self.anchor = event, host_ns, anchor


class _Anchor:
    """A timing event on an idle side stream, waited for at once: ``host_ns``
    is the middle of its record and its wait, ``half_ns`` half their span."""

    __slots__ = ("event", "host_ns", "half_ns")

    def __init__(self, device: torch.device):
        stream = _cuda.side_stream(device)
        event = _cuda.event()
        t0 = time.perf_counter_ns()
        event.record(stream)
        event.synchronize()
        t1 = time.perf_counter_ns()
        self.event, self.host_ns, self.half_ns = event, (t0 + t1) // 2, (t1 - t0) // 2

    def at(self, mark: Mark) -> float:
        """A mark's device time on the host clock, in ns."""
        return self.host_ns + 1e6 * self.event.elapsed_time(mark.event)


class _Cuda:
    """The CUDA calls the tracer makes (the tests put a host-clock stand-in
    in their place on the CPU)."""

    def __init__(self):
        self.side: Dict[int, "torch.cuda.Stream"] = {}

    @staticmethod
    def index(device: torch.device) -> int:
        return device.index if device.index is not None else torch.cuda.current_device()

    @staticmethod
    def recordable(device: torch.device) -> bool:
        """On the card and not capturing a graph on the current stream."""
        return device.type == "cuda" and not torch.cuda.is_current_stream_capturing()

    @staticmethod
    def event():
        return torch.cuda.Event(enable_timing=True)

    @staticmethod
    def stream(device: torch.device):
        return torch.cuda.current_stream(device)

    def side_stream(self, device: torch.device):
        key = self.index(device)
        if key not in self.side:
            self.side[key] = torch.cuda.Stream(device)
        return self.side[key]


_cuda = _Cuda()


def _dev(device) -> torch.device:
    return device if isinstance(device, torch.device) else torch.device(device)


def _record(device: torch.device):
    event = _cuda.event()
    event.record(_cuda.stream(device))
    return event


def device_event(device) -> Optional[Mark]:
    """While tracing is active, on the card and outside a graph capture: a
    timing event recorded now on ``device``'s current stream, anchored to
    the host clock. Otherwise None."""
    if not _profiler._is_profiler_enabled or device is None:
        return None
    dev = _dev(device)
    if not _cuda.recordable(dev):
        return None
    anchor = _STORE.anchor(dev)
    host_ns = time.perf_counter_ns()
    return Mark(_record(dev), host_ns, anchor)


def timing_event(device) -> Optional[Mark]:
    """A timing event recorded now on the card (None elsewhere and inside
    a graph capture): ``device_event``'s while tracing is active, else a
    plain one."""
    mark = device_event(device)
    if mark is None and device is not None and _cuda.recordable(_dev(device)):
        mark = Mark(_record(_dev(device)), None, None)
    return mark


def device_span(name: str, begin: Optional[Mark], end: Optional[Mark], id=None) -> None:
    """Store the device time from mark ``begin`` to mark ``end`` as span
    ``name`` (request id: ``id``, else this thread's innermost span's).
    Nothing where either is missing or not anchored."""
    if begin is None or end is None or begin.anchor is None or end.anchor is None:
        return
    _STORE.add("pending", (name, current_id() if id is None else id,
                           threading.get_native_id(), begin, end))


def backward_span(name: str, output: torch.Tensor, last: torch.Tensor, device, id=None) -> None:
    """While tracing is active: a device span ``name`` of a module's
    backward, from the gradient reaching ``output`` (a hook on it) to the
    end of the backward of the operation that made ``last`` (a hook on its
    node). The hooks return nothing, so no gradient changes."""
    if (not _profiler._is_profiler_enabled or not output.requires_grad
            or last.grad_fn is None):
        return
    rid = current_id() if id is None else id
    opened: List[Mark] = []

    def begin(grad):
        mark = device_event(device)
        if mark is not None:
            opened.append(mark)

    def end(grad_inputs, grad_outputs):
        if opened:
            device_span(name, opened.pop(), device_event(device), rid)

    output.register_hook(begin)
    last.grad_fn.register_hook(end)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is active."""
    if _profiler._is_profiler_enabled:
        _STORE.count(name, n)


class _Store:
    def __init__(self):
        self.lock = threading.Lock()
        self.clear()

    def clear(self) -> None:
        self.spans: List[Dict] = []
        self.pending: List[tuple] = []
        self.device_spans: List[Dict] = []
        self.counters: Dict[str, int] = {}
        self.anchors: Dict[int, _Anchor] = {}
        self.anchor_log: List[Dict] = []
        self.dropped = 0

    def add(self, kind: str, record) -> None:
        with self.lock:
            if len(self.spans) + len(self.pending) + len(self.device_spans) >= CAP:
                self.dropped += 1
            else:
                getattr(self, kind).append(record)

    def count(self, name: str, n: int) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def anchor(self, device: torch.device) -> _Anchor:
        """The current anchor of ``device``, laid at its first use."""
        key = _cuda.index(device)
        a = self.anchors.get(key)
        if a is None:
            a = _Anchor(device)
            with self.lock:
                if key in self.anchors:
                    return self.anchors[key]
                self.anchors[key] = a
                self.anchor_log.append({"device": key, "host_ns": a.host_ns,
                                        "half_ns": a.half_ns, "drift_ns": 0.0})
        return a

    def resolve(self, wait: bool) -> None:
        with self.lock:
            todo, self.pending = self.pending, []
        done, left = [], []
        for rec in todo:
            name, rid, thread, b, e = rec
            if wait:
                b.event.synchronize()
                e.event.synchronize()
            elif not (b.event.query() and e.event.query()):
                left.append(rec)
                continue
            begin_ns, end_ns = b.anchor.at(b), e.anchor.at(e)
            done.append({"name": name, "id": rid, "thread": thread, "enqueue_ns": b.host_ns,
                         "begin_ns": begin_ns, "end_ns": end_ns})
        with self.lock:
            self.pending = left + self.pending
            self.device_spans += done
        if done:
            self._reanchor()

    def _reanchor(self) -> None:
        """A new anchor on each device, and the drift of the device clock
        from the host's since the last one: the new anchor's time through
        the old one, less its own host time."""
        for key, old in list(self.anchors.items()):
            new = _Anchor(torch.device("cuda", key))
            drift = old.host_ns + 1e6 * old.event.elapsed_time(new.event) - new.host_ns
            with self.lock:
                self.anchors[key] = new
                self.anchor_log.append({"device": key, "host_ns": new.host_ns,
                                        "half_ns": new.half_ns, "drift_ns": drift})


_STORE = _Store()


def resolve() -> None:
    """Resolve the device spans whose events have passed, without waiting."""
    if _STORE.pending:
        _STORE.resolve(wait=False)


def records() -> Dict:
    """What was recorded since the process started or since ``clear()``,
    every device span resolved (this waits for their events): ``spans``,
    ``device_spans`` (``begin_ns``, ``end_ns`` on the host clock,
    ``enqueue_ns`` the host time the begin event was enqueued),
    ``counters``, ``anchors`` (each with the drift since the one before)
    and ``dropped``."""
    _STORE.resolve(wait=True)
    s = _STORE
    with s.lock:
        return {"spans": list(s.spans), "device_spans": list(s.device_spans),
                "counters": dict(s.counters), "anchors": list(s.anchor_log),
                "dropped": s.dropped}


def clear() -> None:
    """Forget every record, counter and anchor."""
    with _STORE.lock:
        _STORE.clear()
