"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import json
import os
import re

import pytest

from conftest import ROOT

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
HERE = os.path.join(ROOT, "portbench")


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(SPEC["command"]) <= 32
    assert len(json.dumps(SPEC)) < 64 * 1024
    # a full check of 24 cells fits into 43200 s
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_text():
    entries = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[kind]]
        assert len(names) == len(set(names)), kind


def test_end_to_end_metrics():
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics_move_a_metric_of_their_cells():
    from portbench import harness

    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:
            e2e, _ = harness.metrics_of(SPEC, cell)
            assert m["moves"] in {e["name"] for e in e2e}, (m["name"], cell)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_file_of_a_cell_resolves_by_name(cell):
    from portbench import harness

    w = harness.find_cell(SPEC, cell)
    assert w["chips"] in (1, 4)
    cfg = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert cfg["file"] == f"portbench/configs/{w['config']}.json"
    config = json.load(open(os.path.join(ROOT, cfg["file"])))
    assert config["reduced"] == cfg["reduced"] and config["source"] == cfg["source"]
    traffic = json.load(open(os.path.join(HERE, "traffic", f"{w['traffic']}.json")))
    harness.load_module("modes", traffic["mode"])
    harness.load_module("work", w["config"])
    harness.load_module("reference", w["config"])
    limits = json.load(open(os.path.join(HERE, "limits", f"{cell}.json")))
    assert limits and all(v > 0 for v in limits.values())
    _, per_layer = harness.metrics_of(SPEC, cell)
    for m in per_layer:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_configs_hold_the_shipped_config_whole():
    for c in SPEC["configs"]:
        config = json.load(open(os.path.join(ROOT, c["file"])))
        shipped = json.load(open(os.path.join(ROOT, config["shipped"])))
        assert config["config"] == shipped
        assert config["reduced"] == []


def test_a_cell_in_four_chips_is_at_most_a_quarter():
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)
