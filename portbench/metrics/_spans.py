"""What the per-layer readers of the program's own spans share: the
tracer's store (``waveformml_tpu_torch.utils.tracing.records()``), which in
a traced run holds exactly the window, since the program records only
while a profiler session runs. Where the program has no tracer, or recorded
nothing of the kind, a reader gets None and the harness leaves the metric
out."""
from __future__ import annotations

from typing import Dict, List, Optional


def store(r: Dict, mode: str) -> Optional[Dict]:
    """The tracer's records in a run of ``mode``; None in another mode or
    where the program has no tracer."""
    if r.get("mode") != mode:
        return None
    try:
        from waveformml_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.records()


def device_spans(rec: Optional[Dict], name: str) -> List[Dict]:
    """The device spans called ``name``, or those whose name starts with it
    where it ends with a dot."""
    if rec is None:
        return []
    if name.endswith("."):
        return [d for d in rec["device_spans"] if d["name"].startswith(name)]
    return [d for d in rec["device_spans"] if d["name"] == name]


def ms(d: Dict) -> float:
    return (d["end_ns"] - d["begin_ns"]) * 1e-6


def mean_ms(r: Dict, mode: str, name: str) -> Optional[float]:
    """The mean device time of span ``name`` over the window, in ms."""
    spans = device_spans(store(r, mode), name)
    if not spans:
        return None
    return sum(ms(d) for d in spans) / len(spans)
