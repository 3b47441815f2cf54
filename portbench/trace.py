"""The device trace of a traced run, reduced to numbers: ``torch.profiler``
(CPU and CUDA activities) over the measured window, marked by a
``portbench.window`` range, and read back from its Chrome trace.

* busy: the union of kernel, memcpy and memset intervals inside the
  window, in seconds; the window's length from the same clock;
* device ops: device seconds by name, the 10 largest;
* idle gaps: the 10 longest stretches of the window with nothing on the
  device, each named by the innermost host range or operation of the
  window's thread that was open when it began.

Spans the benchmark records around its calls into the program
(``span(name)``) name those gaps.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Dict, List, Optional

import torch

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime")
TOP = 10


def start(device) -> torch.profiler.profile:
    """A running profiler of the host and, on the card, of the device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def span(name: str):
    """A named host range in the trace (``record_function``)."""
    return torch.profiler.record_function(name)


def wrap(obj, attr: str, name: str) -> None:
    """Replace the bound method ``obj.attr`` by one that runs inside
    ``span(name)``, for the traced run's idle-gap names."""
    fn = getattr(obj, attr)

    def wrapped(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    setattr(obj, attr, wrapped)


def _merge(intervals: List[tuple]) -> List[list]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: List[Dict]) -> Optional[Dict]:
    """Busy and window seconds, the top device ops and the longest idle
    gaps from Chrome trace events (``ts``, ``dur`` in µs); None without a
    window range."""
    win = [e for e in events if e.get("name") == WINDOW and e.get("ph") == "X"]
    if not win:
        return None
    w = max(win, key=lambda e: e["dur"])
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    dev, by_name = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e.get("dur", 0)), w1)
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
    busy = _merge(dev)
    busy_us = sum(b - a for a, b in busy)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                  for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                  and e.get("tid") == w.get("tid") and e.get("pid") == w.get("pid"))

    def what(at: float) -> str:
        inner = WINDOW
        for a, b, name in host:
            if a > at:
                break
            if b > at:
                inner = name
        return inner

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "device_ops": [[name[:160], s * 1e-6] for name, s in ops],
            "idle_gaps": [[what(a)[:160], (b - a) * 1e-6] for a, b in longest],
            "device_events": len(dev)}


def stop(prof: torch.profiler.profile) -> Optional[Dict]:
    """Stop ``prof`` and reduce its trace (written to a temporary file in
    ``TMPDIR`` and removed)."""
    prof.stop()
    fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        with contextlib.suppress(OSError):
            os.remove(path)
    return reduce(events)
