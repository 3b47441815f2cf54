"""Write PhysPulse records from a Z model and a segment classifier in one
pass over a WaveformPairCal file, and their XML sidecar (the port's
counterpart of scripts/WriteZAndClass.py, with its flags):

    python -m waveformml_tpu_torch.scripts.write_z_and_class input.h5 \\
        z.json z.ckpt class.json class.ckpt -c <calgroup>

The output is ``<stem>_Phys.h5`` beside the input, or as ``-o`` says; the
calgroup defaults to the input's P2X stem. ``--cpu`` runs on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from ntpath import basename
from os.path import expanduser, isdir, join

from waveformml_tpu_torch.utils.util import p2x_stem


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input_path")
    parser.add_argument("config_z")
    parser.add_argument("checkpoint_z")
    parser.add_argument("config_class")
    parser.add_argument("checkpoint_class")
    parser.add_argument("--calgroup", "-c", type=str)
    parser.add_argument("--output", "-o", type=str)
    parser.add_argument("--scale_factor_z", "-sz", type=float)
    parser.add_argument("--scale_factor_class", "-sc", type=float)
    parser.add_argument("--buffer_size", "-b", type=int, default=24576)
    parser.add_argument("--read_size", "-r", type=int, default=1024)
    parser.add_argument("--cpu", "-cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    args = parser.parse_args(argv)

    from waveformml_tpu_torch.inference.prediction_writer import ZAndClassWriter

    input_path = expanduser(args.input_path)
    base = basename(input_path)
    stem = p2x_stem(input_path)
    output = join(os.path.dirname(input_path), stem + "_Phys.h5")
    if args.output:
        out = expanduser(args.output)
        if out.endswith(".h5"):
            output = out
        elif isdir(out):
            output = join(out, stem + "_Phys.h5")
        else:
            raise IOError(f"Output path {args.output} not valid")
    print(f"Writing phys pulse output to {output}")
    if not args.calgroup and "_" not in base:
        raise IOError("cannot infer a calibration group from the filename (no P2X "
                      "'<calgroup>_<Type>.h5' pattern) — pass --calgroup explicitly")
    pw_args = {"n_buffer_rows": args.buffer_size, "n_rows_per_read": args.read_size,
               "calgroup": args.calgroup or stem}
    if args.scale_factor_z:
        pw_args["scale_factor_z"] = args.scale_factor_z
    if args.scale_factor_class:
        pw_args["scale_factor_class"] = args.scale_factor_class
    start = time.time()
    pw = ZAndClassWriter(output, input_path, args.config_z, args.checkpoint_z,
                         args.config_class, args.checkpoint_class,
                         device="cpu" if args.cpu else None, **pw_args)
    pw.write_predictions()
    pw.write_XML(time.time() - start)
    print("Success")
    return 0


if __name__ == "__main__":
    sys.exit(main())
