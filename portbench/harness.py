"""One run of one cell: the inputs and weights from the seed, the program's
set-up and warm-up, the measured window, the per-layer readings of a traced
run, the check against the plain reference and the result line.

Everything a cell is made of is found by name under ``portbench/``:
``configs/<config>.json`` (the configuration as run, its input form, the
modules of its grid ops and its weights' leaves), ``traffic/<mix>.json``
(the load: ``mode``, events a chunk, multiplicities, the pool, the depth in
flight), ``forms/<form>.py`` (how events become a chunk as the
configuration's dataset gives it), ``modes/<mode>.py`` (the loop that
drives the program's entry point for that mode), ``work/<config>.py``
(operations and bytes a chunk needs),
``reference/<config>.py`` (the plain reference), ``limits/<cell>.json``
(each compared number's limit) and ``metrics/<metric>.py`` (one reader a
per-layer metric). ``peaks.json`` holds the cards' peak rates.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from portbench import gen, guard, trace
from portbench.weights import make_weights

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class CellError(RuntimeError):
    """A cell that ``BENCHMARK.json`` and the files by its names do not define."""


def read_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise CellError(f"no {kind} file for {name!r}: {os.path.relpath(path, ROOT)}")
    mod_name = f"portbench.{kind}.{name.replace('.', '__')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def find_cell(spec: Dict, name: str) -> Dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise CellError(f"no workload {name!r} in BENCHMARK.json; have "
                    f"{[c['name'] for c in spec['workloads']]}")


def metrics_of(spec: Dict, cell: str):
    """The end-to-end and the per-layer metrics a cell reports."""
    def listed(m):
        return "workloads" not in m or cell in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if listed(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


@dataclass
class Run:
    """What a run knows of its cell: the files by name, the seed, the
    window, the device, and the pool of chunks drawn from the seed."""

    spec: Dict
    cell: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    pool: List[gen.Chunk] = field(default_factory=list)
    #: (phase, host-clock time at its end) of the set-up, for its breakdown
    marks: List = field(default_factory=list)

    def mark(self, phase: str) -> None:
        self.marks.append((phase, time.perf_counter()))

    def setup_phases(self) -> str:
        """The set-up's phases and their seconds, as one line."""
        out, last = [], self.t0
        for phase, t in self.marks:
            out.append(f"{phase} {t - last:.3f}")
            last = t
        return ", ".join(out)

    @property
    def program_config(self):
        """The shipped configuration as the port's ``Config``, validated."""
        from waveformml_tpu_torch.config import Config, validate_config

        return validate_config(Config(json.loads(json.dumps(self.config["config"]))))

    def weights(self) -> Dict[str, torch.Tensor]:
        """The seeded weights of ``weights.py``, calibrated on the pool's
        first chunk where the configuration's reference offers it
        (``calibrate``: statistics and scales that training would give a
        model of data like it, so that outputs depend on the data)."""
        leaves = [(n, tuple(s), getattr(torch, d)) for n, s, d in self.config["weights"]]
        weights = make_weights(leaves, self.seed, self.device)
        ref = load_module("reference", self.cell["config"])
        if hasattr(ref, "calibrate"):
            weights = ref.calibrate(self.config["config"], weights, self.pool[0])
        return weights

    def work(self, mode: str) -> List[Dict]:
        """Operations and bytes of each chunk of the pool."""
        counter = load_module("work", self.cell["config"])
        return [counter.count(c, self.config["config"], mode) for c in self.pool]

    def peaks(self) -> Optional[Dict]:
        """The card's peak operations a second at the configuration's
        precision and its memory bandwidth, or None off a card the table
        holds."""
        if self.device.type != "cuda":
            return None
        row = read_json(os.path.join(HERE, "peaks.json")).get(
            torch.cuda.get_device_name(self.device))
        if row is None:
            return None
        return {"flops": float(row["flops"][self.config["peak_flops"]]),
                "bytes": float(row["bytes_per_s"])}


def make_run(cell_name: str, seed: int, seconds: float, trace_on: bool, device,
             t0: float, overrides: Optional[Dict] = None) -> Run:
    """The run of ``cell_name``; ``overrides`` replace traffic parameters
    (the tests' small sizes)."""
    spec = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = find_cell(spec, cell_name)
    config = read_json(os.path.join(HERE, "configs", f"{cell['config']}.json"))
    traffic = dict(read_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json")))
    traffic.update(overrides or {})
    limits = read_json(os.path.join(HERE, "limits", f"{cell_name}.json"))
    run = Run(spec, cell, config, traffic, limits, int(seed), float(seconds), bool(trace_on),
              torch.device(device), t0)
    run.mark("start")
    run.pool = gen.make_pool(run.seed, config["input"]["form"], config["input"]["n_samples"],
                             traffic)
    run.mark("inputs")
    return run


def checks_of(run: Run, numbers: Dict[str, Optional[float]]) -> Dict[str, Dict]:
    """Each number that the cell's limits name beside its limit (a missing
    or non-finite number fails)."""
    out = {}
    for name, limit in run.limits.items():
        value = numbers.get(name)
        ok = value is not None and math.isfinite(value) and value <= float(limit)
        out[name] = {"value": value, "limit": float(limit), "ok": ok}
    return out


def device_info(run: Run, peak_bytes: int, busy: Optional[Dict]) -> Dict:
    if run.device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
                "count": 1, "memory_peak_bytes": int(peak_bytes)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if busy is not None:
        info["busy_s"] = busy["busy_s"]
        info["window_s"] = busy["window_s"]
    return info


def run_cell(run: Run) -> Dict:
    """One run of the cell: set-up, window, readings, check. Returns the
    result line's object (``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, in a traced run ``breakdown``, and ``checks``
    last)."""
    guard.check_modules("before the window")
    bad = guard.reference_imports(os.path.join(HERE, "reference"))
    if bad:
        raise guard.GuardError(f"a reference imports the program or JAX: {bad}")
    mode = load_module("modes", run.traffic["mode"])
    e2e, per_layer = metrics_of(run.spec, run.cell["name"])
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    state = mode.setup(run)
    prof = trace.start(run.device) if run.trace else None
    run.mark("profiler" if run.trace else "ready")
    setup_s = time.perf_counter() - run.t0
    with trace.span(trace.WINDOW):
        records = mode.window(run, state)
    summary = trace.stop(prof) if prof is not None else None
    guard.check_modules("after the window")
    peak_bytes = (torch.cuda.max_memory_allocated(run.device)
                  if run.device.type == "cuda" else 0)
    if run.trace:
        mode.after_window(run, state, records)
    records["setup_s"] = setup_s
    records["trace"] = summary
    records["peaks"] = run.peaks()
    metrics = {}
    if run.trace:
        for m in per_layer:
            value = load_module("metrics", m["name"]).read(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            value = records["setup_s"] if m["name"] == "setup_s" else records["e2e"].get(
                m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    mode.release(state)
    numbers = mode.check(run, state, records)
    checks = checks_of(run, numbers)
    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": records["attempted"], "failed": records["failed"],
              "metrics": metrics, "device": device_info(run, peak_bytes, summary)}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["uncompared"] = {k: v for k, v in numbers.items() if k not in run.limits}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    # the readers, the eager pass and the reference ran after the window
    guard.check_modules("before the result")
    return result
