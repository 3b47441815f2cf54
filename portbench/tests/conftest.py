"""Shared helpers of the benchmark's tests: small runs of a cell on the CPU
(the harness's look for a card is skipped; every other step runs)."""
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: a cell at a size the CPU runs in seconds
SMALL = {"events": 64, "pool": 3}


def small_run(cell: str, seed: int = 2 ** 31 + 11, seconds: float = 0.2, trace: bool = False):
    from portbench import harness

    torch.set_num_threads(min(4, torch.get_num_threads()))
    return harness.make_run(cell, seed, seconds, trace, "cpu", time.perf_counter(), SMALL)


def adhoc_run(config: str, traffic: str, limits: dict, seed: int = 2 ** 31 + 11,
              seconds: float = 0.2):
    """A small run of a configuration under a traffic mix that no cell of
    BENCHMARK.json pairs (the reference's other paths)."""
    from portbench import gen, harness

    torch.set_num_threads(min(4, torch.get_num_threads()))
    spec = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cfg = harness.read_json(os.path.join(ROOT, "portbench", "configs", f"{config}.json"))
    mix = dict(harness.read_json(os.path.join(ROOT, "portbench", "traffic", f"{traffic}.json")))
    mix.update(SMALL)
    cell = {"name": f"{config}.{traffic}", "config": config, "traffic": traffic, "chips": 1}
    run = harness.Run(spec, cell, cfg, mix, limits, seed, seconds, False, torch.device("cpu"),
                      time.perf_counter())
    run.pool = gen.make_pool(seed, cfg["input"]["form"], cfg["input"]["n_samples"], mix)
    return run


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; this machine has none")
    return "cuda"
