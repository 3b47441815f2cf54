"""Collect an occlusion study (the port's counterpart of
scripts/EvalOcclusionStudy.py):

    python -m waveformml_tpu_torch.scripts.eval_occlusion_study DIR N [--metric test_loss] [-s]

reads the best (smallest) value of the metric from the event files of each
``DIR/occlude_<n>`` (n < N; needs tensorboard), prints it, and plots it
against n into ``DIR/occlude_results_<metric>.png`` (needs matplotlib);
``-s`` plots the two halves of the features (the two PMTs) apart.
"""
from __future__ import annotations

import argparse
import sys
from os.path import join
from pathlib import Path

import numpy as np


def best_values(directory: str, n: int, metric: str = "test_loss") -> np.ndarray:
    """``[n]``: the smallest value of ``metric`` over the event files of
    each ``occlude_<i>`` under ``directory`` (inf where a directory has
    none, nan where there is no directory), printing each."""
    from waveformml_tpu_torch.utils.tb import TBHelper, find_tfevents

    results = np.full(n, np.nan)
    tbh = TBHelper()
    for d in Path(directory).glob("occlude_*"):
        if not d.is_dir():
            continue
        try:
            idx = int(d.name.split("_")[-1])
        except ValueError:
            continue
        if idx >= n:
            continue
        best = np.inf
        for f in find_tfevents(str(d)):
            tbh.set_path(f)
            v = tbh.get_best_value(metric)
            if v is not None and v < best:
                best = v
        results[idx] = best
        print(f"{metric} for ind {idx} is {best}")
    return results


def main(argv=None) -> int:
    from waveformml_tpu_torch.utils.plot import plot_scatter

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("dir", help="directory of occlude_<n> folders")
    parser.add_argument("n", type=int, help="number of features occluded")
    parser.add_argument("--metric", default="test_loss")
    parser.add_argument("--split", "-s", action="store_true",
                        help="split the features in half and plot both halves")
    args = parser.parse_args(argv)
    results = best_values(args.dir, args.n, args.metric)
    valid = np.isfinite(results)
    if not valid.any():
        print(f"error: no occlude_<n> results with metric '{args.metric}' "
              f"found under {args.dir}", file=sys.stderr)
        return 1
    xs = np.arange(args.n)

    def save(sel, suffix):
        fig = plot_scatter(xs[sel], results[sel], xlabel="occluded index",
                           ylabel=args.metric, title="occlusion study")
        out = join(args.dir, f"occlude_results_{args.metric}{suffix}.png")
        fig.savefig(out)
        print("wrote", out)

    if args.split:
        half = args.n // 2
        save(valid & (xs < half), "_det0")
        save(valid & (xs >= half), "_det1")
    else:
        save(valid, "")
    return 0


if __name__ == "__main__":
    sys.exit(main())
