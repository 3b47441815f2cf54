"""Arithmetic the per-layer readers share. A reader returns None where its
run has nothing to read (another mode, no card, no trace), and the harness
leaves the metric out; a share of a peak is never reported as 0 for want of
a reading."""
from __future__ import annotations

from typing import Dict, Optional


def least_seconds(work, peaks: Dict) -> float:
    """The least time the card could take over ``work`` (each chunk's grid
    operations and bytes): per chunk the larger of operations over the peak
    rate and bytes over the memory bandwidth, summed."""
    return sum(max(w["grid_flops"] / peaks["flops"], w["grid_bytes"] / peaks["bytes"])
               for w in work)


def roofline_pct(r: Dict, mode: str) -> Optional[float]:
    """The grid ops' least time over their measured device time, in %."""
    work = r.get("work") if mode == "train" else r.get("grid_work")
    if r.get("mode") != mode or not work or not r.get("grid_ms") or not r.get("peaks"):
        return None
    return 100.0 * least_seconds(work, r["peaks"]) / (r["grid_ms"] * 1e-3)


def mfu_pct(r: Dict, mode: str) -> Optional[float]:
    """The window's model operations over the window at the peak rate, in %."""
    if r.get("mode") != mode or not r.get("work") or not r.get("peaks"):
        return None
    ops = sum(w["model_flops"] for w in r["work"])
    return 100.0 * ops / (r["window_s"] * r["peaks"]["flops"])


def idle_pct(r: Dict, mode: str) -> Optional[float]:
    """The share of the traced window with nothing on the device, in %."""
    t = r.get("trace")
    if r.get("mode") != mode or not t or not t.get("device_events"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
