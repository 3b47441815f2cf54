"""The trace's reduction: busy time as the union of device intervals inside
the window, the idle gaps named by the innermost host range open when they
began."""
from portbench import trace


def test_busy_union_top_ops_and_named_gaps():
    host = {"pid": 1, "tid": 7, "ph": "X"}
    events = [
        dict(host, name=trace.WINDOW, cat="user_annotation", ts=0.0, dur=100.0),
        dict(host, name="portbench.dispatch", cat="user_annotation", ts=30.0, dur=20.0),
        dict(host, name="aten::copy_", cat="cpu_op", ts=31.0, dur=2.0),
        {"ph": "X", "cat": "kernel", "name": "conv", "pid": 0, "tid": 3, "ts": 10.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "conv", "pid": 0, "tid": 4, "ts": 20.0, "dur": 15.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "pid": 0, "tid": 3, "ts": 60.0,
         "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "tail", "pid": 0, "tid": 3, "ts": 95.0, "dur": 20.0},
    ]
    out = trace.reduce(events)
    # device busy: [10, 35] ∪ [60, 70] ∪ [95, 100] inside the window
    assert out["busy_s"] == (25 + 10 + 5) * 1e-6
    assert out["window_s"] == 100 * 1e-6
    assert out["device_ops"][0] == ["conv", 35 * 1e-6]
    assert out["idle_gaps"][0] == ["portbench.dispatch", 25 * 1e-6]      # [35, 60]
    assert ["portbench.window", 25 * 1e-6] in out["idle_gaps"]           # [70, 95]
    assert ["portbench.window", 10 * 1e-6] in out["idle_gaps"]           # [0, 10]


def test_no_window_no_reading():
    assert trace.reduce([{"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 1}]) is None


def test_device_ms_serve_reads_the_traces_busy_time_over_the_chunks():
    from portbench.harness import load_module

    read = load_module("metrics", "device_ms.serve").read
    r = {"mode": "serve", "chunks": 4, "trace": {"busy_s": 0.05, "window_s": 0.06,
                                                 "device_events": 9}}
    assert read(r) == 0.05 * 1e3 / 4
    assert read(dict(r, trace=None)) is None
    assert read(dict(r, mode="train")) is None
