"""The port's tracer (waveformml_tpu_torch/utils/tracing.py) on the CPU.

Without a profiler nothing is recorded and no ``record_function`` is
entered, while the phase records keep their keys. Inside a CPU
``torch.profiler`` session a tiny ``Trainer.fit`` and ``InferenceModel``
record their named spans with step and chunk ids and parents, each span
sits in the exported Chrome trace with its stored duration, and losses,
gradients and served outputs stay bit-identical. A host-clock stand-in for
CUDA's events drives the device spans (the Trainer's, the grid convs'
forward and backward, the served chunk's) and the anchor through the same
code as on the card. The graph capture's case is a card test."""
import copy
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from waveformml_tpu_torch.config import Config, load_config, to_dict
from waveformml_tpu_torch.datasets.synthetic import BlockDataModule, segment_block
from waveformml_tpu_torch.engineering.tasks import LitPSD, LitZ
from waveformml_tpu_torch.engineering.trainer import Trainer
from waveformml_tpu_torch.inference.model import InferenceModel
from waveformml_tpu_torch.utils import tracing
from waveformml_tpu_torch.utils.profiler import SimpleProfiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS, STEPS = 2, 3
TRAIN_SPANS = ("trainer.fit_start", "trainer.epoch", "trainer.host_prep", "trainer.h2d",
               "trainer.step", "trainer.forward", "trainer.backward", "trainer.optimizer",
               "trainer.loss_read", "trainer.epoch_end", "trainer.val")


@pytest.fixture(autouse=True)
def _empty_store():
    tracing.clear()
    yield
    tracing.clear()


class _Profiling:
    """A CPU ``torch.profiler`` session as a context manager."""

    def __enter__(self):
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        self.prof.start()
        return self.prof

    def __exit__(self, *exc):
        self.prof.stop()
        return False


class _FakeEvent:
    """A CUDA event on the host clock: recorded when asked, always passed."""

    def record(self, stream=None):
        self.t = time.perf_counter_ns()

    def synchronize(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6


class _FakeCuda(tracing._Cuda):
    """Every device recordable, events on the host clock, no streams."""

    @staticmethod
    def index(device):
        return 0

    @staticmethod
    def recordable(device):
        return True

    event = staticmethod(_FakeEvent)

    @staticmethod
    def stream(device):
        return None

    def side_stream(self, device):
        return None


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(tracing, "_cuda", _FakeCuda())


def _psd_cfg():
    from test_torch_trainer import CFG

    cfg = copy.deepcopy(CFG)
    cfg["optimize_config"]["total_epoch"] = EPOCHS
    return cfg


def _psd_data(seed=5):
    from test_torch_trainer import _blocks

    rng = np.random.default_rng(seed)
    return _blocks(rng, STEPS), _blocks(rng, 1)


def _z_cfg():
    d = to_dict(load_config(os.path.join(ROOT, "config", "examples", "SingleEndedZCNN.json")))
    d["system_config"]["n_samples"] = 8
    return d


def _z_data(seed=7):
    rng = np.random.default_rng(seed)
    return ([segment_block(rng, 12, 8, label="z") for _ in range(STEPS)],
            [segment_block(rng, 12, 8, label="z")])


def _fit(kind="psd", seed=0):
    cfg_d, (train, val), cls = ((_psd_cfg(), _psd_data(), LitPSD) if kind == "psd"
                                else (_z_cfg(), _z_data(), LitZ))
    cfg = Config(cfg_d)
    torch.manual_seed(seed)
    task = cls(cfg, "cpu")
    trainer = Trainer(cfg, task, "cpu", max_epochs=EPOCHS, callbacks=[])
    trainer.fit(BlockDataModule(train, val, val))
    return trainer


def _served(kind="psd"):
    cfg_d, (train, _), cls = ((_psd_cfg(), _psd_data(), LitPSD) if kind == "psd"
                              else (_z_cfg(), _z_data(), LitZ))
    torch.manual_seed(3)
    state = cls(Config(copy.deepcopy(cfg_d)), "cpu").model.state_dict()
    return InferenceModel(Config(cfg_d), state, device="cpu"), train


def test_active_exactly_while_a_profiler_records():
    """The tracer's switch is the profiler's own flag, which
    ``torch.profiler.profile().start()`` sets and ``stop()`` clears; the
    C++ side agrees."""
    assert not tracing.active() and not torch.autograd._profiler_enabled()
    with _Profiling():
        assert tracing.active() and torch.autograd._profiler_enabled()
    assert not tracing.active() and not torch.autograd._profiler_enabled()


def test_without_a_profiler_nothing_is_recorded(monkeypatch):
    """No profiler: the store stays empty, no profiler range is entered,
    and the phase records keep their keys with non-negative seconds."""
    entered = []
    real = tracing._RANGE

    def spy(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(tracing, "_RANGE", spy)
    trainer = _fit()
    test = trainer.test(BlockDataModule(*_psd_data(), _psd_data()[1]),
                        collect=lambda *a: None)
    model, chunks = _served()
    for b in chunks:
        model.fetch(model.dispatch(b.coords, b.feats))
    assert entered == [] and test
    rec = tracing.records()
    assert rec["spans"] == [] and rec["device_spans"] == [] and rec["counters"] == {}
    assert len(trainer.step_phases) == EPOCHS * STEPS
    for p in trainer.step_phases:
        assert set(p) == {"host_prep_s", "h2d_s", "events", "device_ms", "wall_s"}
        assert p["host_prep_s"] >= 0 and p["h2d_s"] >= 0 and p["wall_s"] >= 0
        assert p["device_ms"] is None
    for p in trainer.test_phases:
        assert set(p) == {"host_prep_s", "h2d_s", "device_ms", "copy_back_s", "collect_s",
                          "wall_s", "events"}
        assert min(v for k, v in p.items() if k.endswith("_s")) >= 0
    assert sorted(model.dispatch_phases) == ["fetch_s", "h2d_s", "host_prep_s", "launch_s"]
    assert all(v >= 0 for v in model.dispatch_phases.values())


def test_fit_records_its_spans_with_step_ids_and_parents():
    with _Profiling():
        trainer = _fit()
    spans = tracing.records()["spans"]
    names = {s["name"] for s in spans}
    assert set(TRAIN_SPANS) <= names, set(TRAIN_SPANS) - names
    by_seq = {s["seq"]: s for s in spans}
    steps = [s for s in spans if s["name"] == "trainer.step"]
    assert [s["id"] for s in steps] == list(range(EPOCHS * STEPS)) == list(
        range(trainer.global_step))
    for s in spans:
        if s["name"] in ("trainer.forward", "trainer.backward", "trainer.optimizer"):
            parent = by_seq[s["parent"]]
            assert parent["name"] == "trainer.step" and parent["id"] == s["id"]
            assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
        if s["name"] in ("trainer.host_prep", "trainer.h2d", "trainer.loss_read"):
            assert by_seq[s["parent"]]["name"] in ("trainer.epoch", "trainer.val")
    preps = [s for s in spans if s["name"] == "trainer.host_prep"
             and by_seq[s["parent"]]["name"] == "trainer.epoch"]
    assert [s["id"] for s in preps] == [s["id"] for s in steps]
    assert sum(1 for s in spans if s["name"] == "trainer.epoch_end") == EPOCHS


def test_serving_records_its_spans_with_chunk_ids():
    model, chunks = _served()
    with _Profiling():
        handles = [model.dispatch(b.coords, b.feats) for b in chunks]
        for h in handles:
            model.fetch(h)
    spans = tracing.records()["spans"]
    by_seq = {s["seq"]: s for s in spans}
    dispatches = [s for s in spans if s["name"] == "serve.dispatch"]
    assert [s["id"] for s in dispatches] == [h.chunk for h in handles] == [0, 1, 2]
    for name in ("serve.host_prep", "serve.h2d", "serve.launch"):
        kids = [s for s in spans if s["name"] == name]
        assert [s["id"] for s in kids] == [0, 1, 2]
        assert all(by_seq[s["parent"]]["name"] == "serve.dispatch" for s in kids)
    assert [s["id"] for s in spans if s["name"] == "serve.fetch"] == [0, 1, 2]


def test_spans_sit_in_the_chrome_trace_with_their_durations(tmp_path):
    """Each stored span is a range of its name in the exported trace, its
    duration within 10% or 50 µs of the stored one."""
    with _Profiling() as prof:
        _fit()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = tracing.records()["spans"]
    for name in TRAIN_SPANS:
        stored = sorted((s for s in spans if s["name"] == name), key=lambda s: s["start_ns"])
        traced = sorted((e for e in events if e["name"] == name), key=lambda e: e["ts"])
        assert len(stored) == len(traced) > 0, name
        for s, e in zip(stored, traced):
            want = (s["end_ns"] - s["start_ns"]) / 1e3
            assert abs(e["dur"] - want) <= max(0.1 * want, 50.0), (name, e["dur"], want)


@pytest.mark.parametrize("kind", ["psd", "z"])
def test_losses_and_gradients_are_bit_identical_traced(kind, fake_cuda):
    """The same fit with tracing off and on (device spans and the grid
    convs' backward hooks driven by the stand-in): the same losses,
    gradients and weights, bit for bit."""
    plain = _fit(kind)
    with _Profiling():
        traced = _fit(kind)
    assert traced.step_losses == plain.step_losses
    for (n, a), b in zip(plain.task.model.named_parameters(), traced.task.model.parameters()):
        assert torch.equal(a, b), n
        assert (a.grad is None) == (b.grad is None) and (a.grad is None or torch.equal(
            a.grad, b.grad)), n
    names = {d["name"] for d in tracing.records()["device_spans"]}
    if kind == "z":
        assert {"grid.SparseConv2d.forward", "grid.SparseConv2d.backward"} <= names


@pytest.mark.parametrize("kind", ["psd", "z"])
def test_served_outputs_are_bit_identical_traced(kind):
    model, chunks = _served(kind)
    plain = [model.fetch(model.dispatch(b.coords, b.feats)) for b in chunks]
    with _Profiling():
        traced = [model.fetch(model.dispatch(b.coords, b.feats)) for b in chunks]
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)


def test_device_spans_of_a_training_step(fake_cuda):
    """With the stand-in: each step's copy in, forward, backward and
    optimizer follow each other on the device clock under the step's id;
    each grid conv's forward lies inside its step's forward; the anchors'
    drift is logged."""
    with _Profiling():
        trainer = _fit("z")
    rec = tracing.records()
    dev = rec["device_spans"]
    order = ("trainer.h2d", "trainer.forward", "trainer.backward", "trainer.optimizer")
    for step in range(trainer.global_step):
        mine = {d["name"]: d for d in dev if d["id"] == step and d["name"] in order}
        assert set(mine) == set(order), step
        for a, b in zip(order, order[1:]):
            assert mine[a]["end_ns"] == mine[b]["begin_ns"]
        assert all(mine[n]["begin_ns"] <= mine[n]["end_ns"] for n in order)
        fwd = [d for d in dev if d["id"] == step and d["name"] == "grid.SparseConv2d.forward"]
        assert len(fwd) == 2
        for d in fwd:
            assert mine["trainer.forward"]["begin_ns"] <= d["begin_ns"] <= d["end_ns"] <= \
                mine["trainer.forward"]["end_ns"]
        bwd = [d for d in dev if d["id"] == step and d["name"] == "grid.SparseConv2d.backward"]
        assert len(bwd) == 2
        for d in bwd:
            assert mine["trainer.backward"]["begin_ns"] <= d["begin_ns"] <= d["end_ns"] <= \
                mine["trainer.backward"]["end_ns"]
    # one anchor laid at the first event, a new one at each epoch's wait
    assert len(rec["anchors"]) >= 1 + EPOCHS
    assert all(abs(a["drift_ns"]) < 5e6 for a in rec["anchors"])


def test_device_spans_of_a_served_chunk(fake_cuda, monkeypatch):
    """With the stand-in on the card's path: the chunk's copy in and its
    device span begin at one mark; the begin's enqueue time precedes it;
    a capture is counted once."""
    from waveformml_tpu_torch.inference import model as model_module

    model, chunks = _served("z")

    class _Graph:
        def __init__(self, model, packed, spec):
            self.static_in = torch.empty(packed.shape, dtype=torch.uint8)
            self.static_out = model._forward(model_module.unpack_db(self.static_in, spec))
            self.replays = 0
            self.graph = self

        def replay(self):
            pass

    model.device = torch.device("cuda")
    monkeypatch.setattr(model, "_capture", lambda packed, spec: _Graph(model, packed, spec))
    pack = model_module.pack_db
    monkeypatch.setattr(model_module, "pack_db", lambda db, pin_memory: pack(db, False))
    monkeypatch.setattr(torch, "empty", _drop_pin(torch.empty))
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    with _Profiling():
        handles = [model.dispatch(chunks[0].coords, chunks[0].feats) for _ in range(3)]
        for h in handles:
            model.fetch(h)
    rec = tracing.records()
    assert rec["counters"] == {"serve.captures": 1}
    by = {}
    for d in rec["device_spans"]:
        by.setdefault(d["name"], []).append(d)
    assert [d["id"] for d in by["serve.device"]] == [0, 1, 2]
    for h2d, whole in zip(by["serve.h2d"], by["serve.device"]):
        assert h2d["begin_ns"] == whole["begin_ns"] and h2d["end_ns"] <= whole["end_ns"]
        assert whole["enqueue_ns"] <= whole["begin_ns"]
    waits = [s for s in rec["spans"] if s["name"] == "serve.fetch_wait"]
    assert [s["id"] for s in waits] == [0, 1, 2]


def _drop_pin(empty):
    def wrapped(*args, pin_memory=False, **kwargs):
        return empty(*args, **kwargs)
    return wrapped


def test_simple_profiler_sections_are_spans():
    profiler = SimpleProfiler()
    with _Profiling():
        profiler.start("run_training_step")
        profiler.start("inner")
        profiler.stop("inner")
        profiler.stop("run_training_step")
        profiler.stop("never_started")
    spans = {s["name"]: s for s in tracing.records()["spans"]}
    assert spans["inner"]["parent"] == spans["run_training_step"]["seq"]
    rows = {name: count for name, count, _, _ in profiler.rows()}
    assert rows == {"run_training_step": 1, "inner": 1}


def test_counters_count_only_while_tracing():
    tracing.count("c", 2)
    with _Profiling():
        tracing.count("c", 3)
        tracing.count("c")
    assert tracing.records()["counters"] == {"c": 4}


def test_the_store_is_capped_and_thread_safe(monkeypatch):
    """Spans from more threads than cores at once, with a short switch
    interval, all arrive up to the cap and the rest are counted as
    dropped; ``clear`` empties the store."""
    import sys

    n_threads, each = min(32, 2 * (os.cpu_count() or 1) + 1), 100
    monkeypatch.setattr(tracing, "CAP", n_threads * each // 2)

    def work(i):
        for _ in range(each):
            with tracing.span(f"t{i}"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _Profiling():
            threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    rec = tracing.records()
    assert len(rec["spans"]) == tracing.CAP and rec["dropped"] == n_threads * each - tracing.CAP
    assert len({s["thread"] for s in rec["spans"]}) >= 2
    tracing.clear()
    assert tracing.records() == {"spans": [], "device_spans": [], "counters": {},
                                 "anchors": [], "dropped": 0}


def test_resolve_waits_for_no_event(fake_cuda, monkeypatch):
    """``resolve`` keeps the device spans whose events have not passed; the
    store's read waits for them."""
    with _Profiling():
        a, b = tracing.device_event("cuda"), tracing.device_event("cuda")
    monkeypatch.setattr(_FakeEvent, "query", lambda self: False)
    tracing.device_span("x", a, b, id=7)
    tracing.resolve()
    assert tracing._STORE.pending and not tracing._STORE.device_spans
    rec = tracing.records()
    assert [(d["name"], d["id"]) for d in rec["device_spans"]] == [("x", 7)]
    assert rec["device_spans"][0]["enqueue_ns"] == a.host_ns


def test_a_span_measures_its_seconds_inactive():
    with tracing.span("s") as s:
        time.sleep(0.002)
    assert s.seconds >= 0.002 and s.end - s.start == s.seconds
    assert tracing.records()["spans"] == []


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_a_capture_while_tracing_replays_and_records_no_span_inside(cuda):
    """A layout captured while tracing is active: the capture records no
    device event (the grid convs' spans come from the eager warm-up before
    it, one per conv), it is counted, and its replays give what the same
    graph gives untraced and the eager forward."""
    cfg_d, (train, _) = _z_cfg(), _z_data()
    torch.manual_seed(3)
    state = LitZ(Config(copy.deepcopy(cfg_d)), "cpu").model.state_dict()
    model = InferenceModel(Config(cfg_d), state)
    block = train[0]
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    traced = [model.fetch(model.dispatch(block.coords, block.feats)) for _ in range(3)]
    prof.stop()
    rec = tracing.records()
    assert rec["counters"] == {"serve.captures": 1} and len(model.graphs) == 1
    names = [d["name"] for d in rec["device_spans"]]
    assert names.count("serve.device") == names.count("serve.h2d") == 3
    assert names.count("grid.SparseConv2d.forward") == 2
    for d in rec["device_spans"]:
        assert d["begin_ns"] <= d["end_ns"]
    plain = model.fetch(model.dispatch(block.coords, block.feats))
    for out in traced:
        np.testing.assert_array_equal(out, plain)
    db = model.task.prepare_block(block, model.task.row_bucket(block),
                                  model.task.event_bucket(block))
    eager = model._forward(model.task.to_device(db))[:plain.shape[0]].cpu().numpy()
    np.testing.assert_allclose(plain, eager, rtol=1e-4, atol=1e-5)
