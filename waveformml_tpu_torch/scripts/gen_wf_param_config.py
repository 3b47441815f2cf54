"""Generate a waveform-simulation parameter sweep (the port's counterpart of
scripts/GenWFParamConfig.py):

    python -m waveformml_tpu_torch.scripts.gen_wf_param_config ranges.json wf.db [-n N] [-o DIR]

``ranges.json`` is ``{param: [low, high], ...}`` or ``{"param_ranges": {...},
"num_points": n}``. Every point of the grid of N linearly spaced values per
parameter is registered as a parameter set in the WFParams database (created
from ``templates/WFParams.sql`` where missing), under a unique name
``WaveCal<k>``, and rendered into ``DIR/<name>.cfg`` from
``templates/WFParams.cfg``; the other parameters keep ``DEFAULTS``.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sqlite3
import sys
from os.path import dirname, join, realpath

TEMPLATES = join(dirname(realpath(__file__)), "templates")
TEMPLATE = join(TEMPLATES, "WFParams.cfg")
SCHEMA = join(TEMPLATES, "WFParams.sql")

DEFAULTS = {
    "PE_per_MeV": 1200, "gain": -5000, "PMT_sigma_t": 3, "lambda": 1775,
    "n": 1.6, "zoff": 0.0, "x_crit": 0, "lambda_s": 0, "eta_bar": 1,
    "PMT_decay_proportion_1": 0.6, "PMT_decay_proportion_2": 0.4,
    "PMT_decay_tau_1": 0.5, "PMT_decay_tau_2": 16,
    "PSD_response_1_p1": 0.7, "PSD_response_1_p2": 0.28,
    "PSD_response_1_p3": 0.02, "PSD_response_1_tau1": 3.16,
    "PSD_response_1_tau2": 32.3, "PSD_response_1_tau3": 270,
    "PSD_response_2_p1": 0.3, "PSD_response_2_p2": 0.65,
    "PSD_response_2_p3": 0.05, "PSD_response_2_tau1": 3.16,
    "PSD_response_2_tau2": 32.3, "PSD_response_2_tau3": 270,
}


def grid_points(ranges: dict, num_points: int):
    """All combinations of ``num_points`` linearly spaced values per
    parameter (the midpoint for one point), parameters in sorted order."""
    names = sorted(ranges)
    axes = []
    for name in names:
        lo, hi = float(ranges[name][0]), float(ranges[name][1])
        if num_points == 1:
            axes.append([0.5 * (lo + hi)])
        else:
            step = (hi - lo) / (num_points - 1)
            axes.append([lo + i * step for i in range(num_points)])
    for combo in itertools.product(*axes):
        yield dict(zip(names, combo))


def main(argv=None) -> int:
    from waveformml_tpu_torch.io.sql import WFParamsDB

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("ranges", help="JSON file: {param: [low, high], ...}")
    parser.add_argument("db", help="WFParams sqlite database path")
    parser.add_argument("--num_points", "-n", type=int, default=3,
                        help="grid points per parameter")
    parser.add_argument("--out_dir", "-o", default="wfparam_configs")
    args = parser.parse_args(argv)
    with open(args.ranges) as f:
        ranges = json.load(f)
    if "param_ranges" in ranges:
        if "num_points" in ranges:
            args.num_points = int(ranges["num_points"])
        ranges = ranges["param_ranges"]
    if not os.path.exists(args.db):
        conn = sqlite3.connect(args.db)
        with open(SCHEMA) as f:
            conn.executescript(f.read())
        conn.commit()
        conn.close()
    db = WFParamsDB(args.db)
    with open(TEMPLATE) as f:
        template = f.read()
    os.makedirs(args.out_dir, exist_ok=True)
    n_written = 0
    for point in grid_points(ranges, args.num_points):
        params = {**DEFAULTS, **point}
        name = db.get_unique_name()
        db.insert_set({"name": name, **params})
        db.commit()
        with open(join(args.out_dir, f"{name}.cfg"), "w") as f:
            f.write(template % params)
        n_written += 1
    print(f"wrote {n_written} parameter sets to {args.db} and {args.out_dir}/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
