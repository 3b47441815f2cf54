"""The readings that a cell's limits are set from, at the cell's own size:

* ``program``: the program's compared numbers, through the harness's own
  set-up, a short window and check, one seed after another in one process;
* ``control``: the plain reference computed in TF32 (its products' operands
  rounded to TF32's 10-bit mantissa, summed in float32: the step below the
  configurations' float32 that would tempt a later change) put in the
  program's place and compared as the program is;
* ``half_batch`` (training): the reference with the second half of each
  step's events left out of the loss, put in the program's place.

A state left unchanged reads 1 in ``change3_median_gap`` by definition and needs
no run. Each reading prints as one JSON line:

    python3 -m portbench.control --workload zcnn.serve --seeds 11 12 13 --kinds program control
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

from portbench import compare, harness
from portbench.harness import load_module


def reference_numbers(run: harness.Run, kind: str) -> Dict[str, Optional[float]]:
    """The compared numbers of the reference put in the program's place:
    ``control`` (TF32) or ``half_batch``."""
    ref = load_module("reference", run.cell["config"])
    cfg = run.config["config"]
    if run.traffic["mode"] == "train":
        exact = ref.train_steps(cfg, run.weights(), run.pool[:3], [0, 1, 1])
        other = ref.train_steps(cfg, run.weights(), run.pool[:3], [0, 1, 1],
                                tf32=kind == "control", half_batch=kind == "half_batch")
        return compare.train_numbers(other, exact)
    if kind != "control":
        raise ValueError(f"{kind} is a training fault")
    weights = run.weights()
    outs = [ref.serve(cfg, weights, c, tf32=True) for c in run.pool]
    refs = [ref.serve(cfg, weights, c) for c in run.pool]
    return {"serve_error": compare.serve_error(outs, refs)}


def readings(cell: str, seeds: List[int], kinds: List[str], device: str,
             seconds: float = 1.0, overrides: Optional[Dict] = None):
    """Yield ``(seed, kind, numbers)`` for each seed and kind."""
    for seed in seeds:
        for kind in kinds:
            run = harness.make_run(cell, seed, seconds, False, device, time.perf_counter(),
                                   overrides)
            if kind == "program":
                result = harness.run_cell(run)
                numbers = {k: c["value"] for k, c in result["checks"].items()}
                numbers.update(result["uncompared"])
            else:
                numbers = reference_numbers(run, kind)
            yield seed, kind, numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kinds", nargs="+", default=["program", "control"],
                   choices=["program", "control", "half_batch"])
    p.add_argument("--seconds", type=float, default=1.0, help="the program's short window")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for seed, kind, numbers in readings(args.workload, args.seeds, args.kinds, args.device,
                                        args.seconds):
        print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                          "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
