"""Copy an attribute of a table from a reference HDF5 file onto the same
table of another file (the port's counterpart of scripts/AddAttr.py):

    python -m waveformml_tpu_torch.scripts.add_attr ref.h5 file.h5 [--table PhysPulse] [--attr runtime]

Needs h5py.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    from waveformml_tpu_torch.io.hdf5 import open_h5

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("ref_file", help="file with the correct runtime")
    parser.add_argument("file", help="file to add it to")
    parser.add_argument("--table", default="PhysPulse")
    parser.add_argument("--attr", default="runtime")
    args = parser.parse_args(argv)
    with open_h5(args.ref_file, "r") as ref, open_h5(args.file, "r+") as f:
        f[args.table].attrs.create(args.attr, ref[args.table].attrs[args.attr])
        f.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
