"""Stream an HDF5 event file through a trained model and write a new HDF5
file with the predictions in place, and its XML sidecar (the port's
counterpart of WritePredictions.py, with its flags):

    python -m waveformml_tpu_torch.write_predictions input.h5 config.json ckpt -w z

on the card, or with ``--cpu`` on the CPU (the kernels' plain versions).
``ckpt`` is a port checkpoint: a ``Trainer`` checkpoint or a
``torch.save``d state dict. The output is ``<input>ModelOut.h5`` beside
the input, or ``<stem>_Phys.h5`` with ``-d PhysPulse``; ``-o`` names a
file or a directory.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from os.path import basename, expanduser, isdir, join

from waveformml_tpu_torch.utils.util import apply_num_threads, p2x_stem


def output_path(input_path: str, output=None, datatype=None) -> str:
    """Where the writer's output goes: ``<input>ModelOut.h5`` (or
    ``<stem>_Phys.h5`` for PhysPulse) beside the input, or in the directory
    ``output``, or ``output`` itself where it is an ``.h5`` path."""
    def stem(path):
        return path[:-3] if path.endswith(".h5") else os.path.splitext(path)[0]

    if datatype == "PhysPulse":
        name = p2x_stem(input_path) + "_Phys.h5"
    else:
        name = basename(stem(input_path)) + "ModelOut.h5"
    if output is None:
        return join(os.path.dirname(input_path), name)
    out = expanduser(output)
    if out.endswith(".h5"):
        return out
    if isdir(out):
        return join(out, name)
    raise IOError(f"Output path {output} not a valid directory or .h5 file")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("input_path", help="path to input hdf5 file")
    parser.add_argument("config", help="path to config file for model")
    parser.add_argument("checkpoint", help="path to checkpoint for model")
    parser.add_argument("--writer", "-w", type=str, default="z", help="'z' | 'irn' | 'irnim'")
    parser.add_argument("--output", "-o", type=str, help="path to output hdf5 file or directory")
    parser.add_argument("--calgroup", "-c", type=str,
                        help="calibration group for normalization (WaveformPairCal)")
    parser.add_argument("--scale_factor", "-s", type=float, help="normalization scale factor")
    parser.add_argument("--datatype", "-d", type=str,
                        help="output datatype override ('WaveformPairCal'/'PhysPulse')")
    parser.add_argument("--cpu", "-cpu", action="store_true",
                        help="run on the CPU (the kernels' plain versions)")
    parser.add_argument("--num_threads", "-nt", type=int, help="host threads")
    parser.add_argument("--buffer_size", "-b", type=int, default=1024 * 16,
                        help="rows buffered before flushing to disk")
    parser.add_argument("--read_size", "-r", type=int, default=2048, help="rows per chunk read")
    args = parser.parse_args(sys.argv[1:] if argv is None else list(argv))
    apply_num_threads(args.num_threads)

    from waveformml_tpu_torch.inference.prediction_writer import (
        IRNIMPredictionWriter, IRNPredictionWriter, ZPredictionWriter)

    input_path = expanduser(args.input_path)
    output = output_path(input_path, args.output, args.datatype)
    print(f"Writing output to {output}")
    pw_args = {"n_buffer_rows": args.buffer_size, "n_rows_per_read": args.read_size}
    if args.calgroup:
        pw_args["calgroup"] = args.calgroup
    if args.scale_factor:
        pw_args["scale_factor"] = args.scale_factor
    if args.datatype:
        pw_args["datatype"] = args.datatype
    writers = {"z": ZPredictionWriter, "irn": IRNPredictionWriter,
               "irnim": IRNIMPredictionWriter}
    if args.writer not in writers:
        raise IOError(f"{args.writer} not a valid choice for writer.")
    start = time.time()
    pw = writers[args.writer](output, input_path, args.config, args.checkpoint,
                              device="cpu" if args.cpu else None, **pw_args)
    print("Writing predictions")
    pw.write_predictions()
    runtime = time.time() - start
    print("Success")
    print("Writing XML metadata")
    pw.write_XML(runtime)
    print("Success")
    return 0


if __name__ == "__main__":
    sys.exit(main())
