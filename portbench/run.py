"""Run one cell of the port's benchmark once and print its result line:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's inputs and weights come from the
seed; set-up warms up the cell's shapes; the window lasts ``--seconds``;
then the program's outputs are checked against the plain reference. The
last lines on standard error give each compared number beside its limit;
the last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and ``checks``). Without a CUDA device, or with fewer than
the cell asks for, it prints no result and exits 2; where the process has
loaded JAX or the JAX package, 3.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
    """Kernel and build caches at fixed paths inside the checkout, so that
    only a cell's first run there builds; nothing that would load JAX."""
    cache = os.path.join(ROOT, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: the per-layer metrics, from a traced run")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from portbench import guard, harness

    cell = harness.find_cell(harness.read_json(os.path.join(ROOT, "BENCHMARK.json")),
                             args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {found}", file=sys.stderr)
        return 2
    run = harness.make_run(args.workload, args.seed, args.seconds, bool(args.trace),
                           "cuda", T0)
    try:
        result = harness.run_cell(run)
    except guard.GuardError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    print(f"portbench: set-up (s): {run.setup_phases()}", file=sys.stderr)
    print(f"portbench: not compared: {result['uncompared']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
