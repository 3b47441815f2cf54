"""Run ``python -m waveformml_tpu_torch.write_predictions`` over every
``.h5`` file of a directory (the port's counterpart of
scripts/WritePredictionBatch.py); flags it does not know pass through:

    python -m waveformml_tpu_torch.scripts.write_prediction_batch <dir> config.json ckpt -w z
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

#: the directory that holds the package, put on each run's PYTHONPATH
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input_dir", help="directory of input hdf5 files")
    parser.add_argument("config")
    parser.add_argument("checkpoint")
    parser.add_argument("--pattern", default="*.h5")
    args, extra = parser.parse_known_args(argv)
    files = sorted(Path(args.input_dir).glob(args.pattern))
    # outputs land beside their inputs: a rerun must not read them as inputs
    files = [f for f in files
             if not (f.name.endswith("ModelOut.h5") or f.name.endswith("_Phys.h5"))]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    for f in files:
        argl = [sys.executable, "-m", "waveformml_tpu_torch.write_predictions",
                str(f.resolve()), args.config, args.checkpoint] + list(extra)
        print(" ".join(argl))
        subprocess.call(argl, env=env)
    return 0


if __name__ == "__main__":
    sys.exit(main())
