"""The benchmark's command on the card: one short run of each cell prints a
correct result line naming the card. Run on a machine with one:

    python -m pytest -q -m cuda portbench/tests
"""
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(cell, trace, cuda_device):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell,
                          "--seed", str(2 ** 31 + 101), "--seconds", "2", "--trace",
                          str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert list(result)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert "breakdown" in result


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(cell, cuda_device):
    from portbench import control

    from portbench import harness

    limits = harness.read_json(os.path.join(ROOT, "portbench", "limits", f"{cell}.json"))
    for seed, kind, numbers in control.readings(cell, [2 ** 31 + 3], ["control"], cuda_device):
        assert any(numbers[k] > v for k, v in limits.items()), numbers
