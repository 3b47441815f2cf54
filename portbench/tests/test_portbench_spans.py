"""The readers of the program's own spans and counters
(``metrics/<name>.py`` over ``waveformml_tpu_torch.utils.tracing``), on
synthetic stores: each reads its spans by name, returns None in another
mode, where the store holds nothing of its kind, or where the program has
no tracer (a parent commit without one). On the card, a traced window of
each cell yields every metric the cell lists."""
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

MS = 1_000_000
TRAIN = {"mode": "train", "trace": {"busy_s": 1.0}}
SERVE = {"mode": "serve", "trace": {"busy_s": 1.0}}


def _read(name, r):
    from portbench.harness import load_module

    return load_module("metrics", name).read(r)


def _dev(name, id, begin_ms, end_ms, enqueue_ms=None):
    return {"name": name, "id": id, "thread": 1, "begin_ns": int(begin_ms * MS),
            "end_ns": int(end_ms * MS),
            "enqueue_ns": int((begin_ms if enqueue_ms is None else enqueue_ms) * MS)}


def _store(device_spans=(), spans=(), counters=None):
    return {"spans": list(spans), "device_spans": list(device_spans),
            "counters": dict(counters or {}), "anchors": [], "dropped": 0}


def _train_store():
    """Three steps 10 ms apart on the device, the third after a 5 ms gap:
    copy in 1 ms, forward 2, backward 4 (a grid conv 0.5 forward and 1.5
    backward inside), optimizer 1."""
    out, t = [], 0.0
    for step in range(3):
        t += 5.0 if step == 2 else 0.0
        out += [_dev("trainer.h2d", step, t, t + 1), _dev("trainer.forward", step, t + 1, t + 3),
                _dev("grid.SparseConv2d.forward", step, t + 1.5, t + 2),
                _dev("trainer.backward", step, t + 3, t + 7),
                _dev("grid.SparseConv2d.backward", None, t + 3.5, t + 5),
                _dev("trainer.optimizer", step, t + 7, t + 8)]
        t += 8.0
    return _store(out)


@pytest.fixture
def store(monkeypatch):
    from waveformml_tpu_torch.utils import tracing

    holder = {}
    monkeypatch.setattr(tracing, "records", lambda: holder["store"])
    return holder


@pytest.mark.parametrize("name,want", [("forward_ms.train", 2.0), ("backward_ms.train", 4.0),
                                       ("optimizer_ms.train", 1.0), ("h2d_ms.train", 1.0),
                                       ("grid_ms.train", 2.0), ("step_gap_ms.train", 2.5)])
def test_train_readers(store, name, want):
    store["store"] = _train_store()
    assert _read(name, TRAIN) == pytest.approx(want)
    assert _read(name, SERVE) is None
    store["store"] = _store()
    assert _read(name, TRAIN) is None


def test_step_gap_pairs_only_consecutive_steps(store):
    """A step whose step before it is not in the window has no gap."""
    store["store"] = _store([_dev("trainer.optimizer", 4, 0, 1), _dev("trainer.h2d", 7, 3, 4)])
    assert _read("step_gap_ms.train", TRAIN) is None


def _serve_store():
    out = []
    for chunk in range(20):
        begin = 10.0 * chunk
        out += [_dev("serve.h2d", chunk, begin, begin + 0.5),
                _dev("serve.device", chunk, begin, begin + 10.0, enqueue_ms=begin - chunk)]
    spans = [{"name": "serve.dispatch", "id": c, "start_ns": 0, "end_ns": 1, "seq": c,
              "parent": None, "thread": 1} for c in range(20)]
    return _store(out, spans)


def test_serve_readers(store):
    import numpy as np

    store["store"] = _serve_store()
    assert _read("replay_ms.serve", SERVE) == pytest.approx(10.0)
    assert _read("h2d_ms.serve", SERVE) == pytest.approx(0.5)
    assert _read("queue_ms.serve", SERVE) == pytest.approx(np.percentile(np.arange(20.0), 95))
    assert _read("captures.serve", SERVE) == 0
    store["store"]["counters"]["serve.captures"] = 2
    assert _read("captures.serve", SERVE) == 2
    for name in ("replay_ms.serve", "h2d_ms.serve", "queue_ms.serve", "captures.serve"):
        assert _read(name, TRAIN) is None
    store["store"] = _store()
    for name in ("replay_ms.serve", "h2d_ms.serve", "queue_ms.serve", "captures.serve"):
        assert _read(name, SERVE) is None


NEW = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train", "h2d_ms.train",
       "grid_ms.train", "step_gap_ms.train", "replay_ms.serve", "h2d_ms.serve",
       "queue_ms.serve", "captures.serve")


def test_no_tracer_no_reading(monkeypatch):
    """A program without the tracer (the import fails): every reader
    returns None and raises nothing."""
    import waveformml_tpu_torch.utils as utils

    monkeypatch.setitem(sys.modules, "waveformml_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(utils, "tracing", raising=False)
    for name in NEW:
        assert _read(name, TRAIN if name.endswith(".train") else SERVE) is None


def test_every_new_metric_is_listed_with_its_reader():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    listed = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        m = listed[name]
        assert m["source"] == ("program_counter" if name == "captures.serve" else "program_span")
        assert m["workloads"] == (["zcnn.serve"] if name.endswith(".serve")
                                  else ["scnet3d.train", "zcnn.train"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in json.load(
    open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]])
def test_a_traced_window_yields_every_metric_of_its_cell(cell, cuda_device):
    from portbench import harness

    spec = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    _, per_layer = harness.metrics_of(spec, cell)
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", str(2 ** 31 + 207), "--seconds", "2", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert {m["name"] for m in per_layer} <= set(result["metrics"]), result["metrics"]
