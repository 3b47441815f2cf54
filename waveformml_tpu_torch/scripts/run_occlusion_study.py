"""Occlusion study: evaluate a checkpoint once per occluded feature index
(the port's counterpart of scripts/RunOcclusionStudy.py):

    python -m waveformml_tpu_torch.scripts.run_occlusion_study config.json ckpt N [-c calgroup] [...]

runs ``python -m waveformml_tpu_torch.evaluate config.json ckpt -oc n`` for
n = 0..N-1, each logging into its own ``occlude_<n>`` directory; flags it
does not know (``--device cpu``, ``-nt 2``, ...) pass through to each run.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

#: the directory that holds the package, put on each run's PYTHONPATH
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("config", help="path to config file")
    parser.add_argument("checkpoint", help="path to checkpoint")
    parser.add_argument("n_features", type=int, help="number of features to occlude")
    parser.add_argument("--calgroup", "-c", type=str)
    parser.add_argument("--verbosity", "-v", type=int, default=2)
    args, extra = parser.parse_known_args(argv)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    for n in range(args.n_features):
        argl = [sys.executable, "-m", "waveformml_tpu_torch.evaluate", args.config,
                args.checkpoint, "-oc", str(n), "-v", str(args.verbosity)]
        if args.calgroup:
            argl += ["-c", args.calgroup]
        argl += list(extra)
        print(" ".join(argl))
        subprocess.call(argl, env=env)
    return 0


if __name__ == "__main__":
    sys.exit(main())
