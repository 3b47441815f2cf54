"""Evaluate the best trials of a hyperparameter study (the port's counterpart
of scripts/EvalBestTrials.py):

    python -m waveformml_tpu_torch.scripts.eval_best_trials <config> [-n 3]
        [-c calgroup] [evaluate options ...]

reads ``<model folder>/studies/<exp_name>/study.db`` of the study's config
(``main -oc``), ranks its completed trials by value (``OptunaDB``) and runs
``python -m waveformml_tpu_torch.evaluate <trial_<n>/config.json> <best
checkpoint>`` on each of the top ``-n`` that has both, passing ``-c`` and
any further options on. A trial without them is skipped, with a line
saying so.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from os.path import join
from typing import Callable, List, Optional, Tuple


def top_trials(config, n_trials: int) -> List[Tuple[int, float, Optional[str],
                                                     Optional[str]]]:
    """The study's ``n_trials`` best completed trials: (number, value, its
    ``config.json`` or None, its best checkpoint or None)."""
    from waveformml_tpu_torch.optimization.hpo import OptunaDB
    from waveformml_tpu_torch.utils.util import get_model_folder, retrieve_best_checkpoint

    study_dir = join(get_model_folder(config), "studies", config.run_config.exp_name)
    db = OptunaDB(join(study_dir, "study.db"))
    try:
        top = db.get_top_trials(n_trials)
    finally:
        db.close()
    out = []
    for number, value in top:
        trial_dir = join(study_dir, f"trial_{number}")
        trial_config = join(trial_dir, "config.json")
        out.append((number, value,
                    trial_config if os.path.exists(trial_config) else None,
                    retrieve_best_checkpoint(trial_dir)))
    return out


def main(argv=None, call: Optional[Callable[[List[str]], int]] = None) -> int:
    """Evaluate the top trials, each through ``call(command)``
    (``subprocess.call`` by default)."""
    from waveformml_tpu_torch.config import load_config

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("config", help="config used for the study")
    parser.add_argument("--n_trials", "-n", type=int, default=3,
                        help="number of top trials to evaluate")
    parser.add_argument("--calgroup", "-c", type=str)
    args, extra = parser.parse_known_args(sys.argv[1:] if argv is None else list(argv))
    call = call or subprocess.call
    top = top_trials(load_config(args.config), args.n_trials)
    print("top trials:", [(number, value) for number, value, _, _ in top])
    for number, _, trial_config, ckpt in top:
        if ckpt is None or trial_config is None:
            print(f"trial {number}: no checkpoint/config found, skipping")
            continue
        argl = [sys.executable, "-m", "waveformml_tpu_torch.evaluate", trial_config, ckpt]
        if args.calgroup:
            argl += ["-c", args.calgroup]
        argl += list(extra)
        print(" ".join(argl))
        call(argl)
    return 0


if __name__ == "__main__":
    sys.exit(main())
