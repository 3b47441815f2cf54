"""A configuration with its own input form, a cell, a traffic mix and a
per-layer metric added as new files run without an edit to any file the
benchmark has."""
import hashlib
import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

SCRIPT = """
import json, sys, time, torch
torch.set_num_threads(2)
from portbench import harness
run = harness.make_run("zcnn4.serve_burst", 7, 0.2, True, "cpu", time.perf_counter(),
                       {"events": 64, "pool": 2})
print(json.dumps(harness.run_cell(run)))
"""

#: a new input form: every event lights as many segments as the mix allows
FORM = """
import numpy as np
from portbench import gen


def make_chunk(rng, n_events, n_samples, traffic):
    mult = np.full(n_events, int(traffic["multiplicity"][1]))
    ev = gen.make_events(rng, mult, n_samples, np.zeros(n_events, np.int64))
    z = (ev["z"] / gen.Z_SCALE + 0.5).astype(np.float32)
    return gen.Chunk(ev["coords"], (ev["waveforms"] / gen.MAX_RANGE).astype(np.float32), z,
                     n_events)
"""


def digest(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_a_cell_added_as_new_files_runs(tmp_path):
    pb = tmp_path / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench"), pb,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: digest(os.path.join(root, p))
              for root in [str(pb)]
              for p in sorted(os.path.relpath(os.path.join(d, f), root)
                              for d, _, fs in os.walk(root) for f in fs)}
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    zcnn = next(c for c in spec["configs"] if c["name"] == "SingleEndedZCNN")
    spec["configs"].append(dict(zcnn, name="SingleEndedZCNN4",
                                file="portbench/configs/SingleEndedZCNN4.json"))
    spec["workloads"].append({"name": "zcnn4.serve_burst", "config": "SingleEndedZCNN4",
                              "traffic": "serve_burst", "chips": 1, "why": "a test cell"})
    spec["end_to_end"][[m["name"] for m in spec["end_to_end"]].index("serve_events_per_s")][
        "workloads"].append("zcnn4.serve_burst")
    for name in ("chunks.serve", "sites.serve"):
        spec["per_layer"].append({"name": name, "unit": "1", "better": "higher",
                                  "source": "host_clock", "layer": "Model forward",
                                  "moves": "serve_events_per_s",
                                  "workloads": ["zcnn4.serve_burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    config = json.load(open(pb / "configs" / "SingleEndedZCNN.json"))
    config["input"]["form"] = "segment_z_full"
    (pb / "configs" / "SingleEndedZCNN4.json").write_text(json.dumps(config))
    (pb / "forms" / "segment_z_full.py").write_text(FORM)
    for kind in ("reference", "work"):
        (pb / kind / "SingleEndedZCNN4.py").write_text(
            f"from portbench.{kind}.SingleEndedZCNN import *  # noqa: F401,F403\n")
    traffic = json.load(open(pb / "traffic" / "serve.json"))
    traffic.update(depth=2, multiplicity=[2, 4])
    (pb / "traffic" / "serve_burst.json").write_text(json.dumps(traffic))
    (pb / "limits" / "zcnn4.serve_burst.json").write_text(
        (pb / "limits" / "zcnn.serve.json").read_text())
    (pb / "metrics" / "chunks.serve.py").write_text(
        "def read(r):\n    return r.get('chunks')\n")
    (pb / "metrics" / "sites.serve.py").write_text(
        "def read(r):\n    return r['work'][0]['in_sites'] if r.get('work') else None\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]))
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    assert result["metrics"]["chunks.serve"]["value"] > 0
    # the new form's chunks: every event at 4 distinct sites
    assert result["metrics"]["sites.serve"]["value"] == 4 * 64
    for rel, d in before.items():
        assert digest(str(pb / rel)) == d, rel
