"""Offline data prep: ``python -m waveformml_tpu_torch.combine_data dir1 dir2 -t 2d
[--base_path ...] [-n N] [-s SIZE] [-o OUT] [-c CONFIG]``.

The port's counterpart of the top-level ``CombineData.py``, flag for flag:
it builds the ``PulseDataset*`` class of ``-t`` over the class directories
(one per class, ``-n`` events each) and writes their class-interleaved
shuffle (``write_shuffled``) as ``Combined_*.h5`` files of ``-s`` events
with their JSON sidecars, into ``-o`` or the dataset's own data directory.
``-c`` takes ``shuffled_size`` and ``chunk_size`` from a config's
``dataset_config``. Needs h5py.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

#: type name → dataset class (ref: CombineData.py:6)
TYPE_MAP = {
    "2d": "PulseDataset2D",
    "3d": "PulseDataset3D",
    "pmt": "PulseDatasetPMT",
    "det": "PulseDatasetDet",
    "detz": "PulseDatasetDetWithZ",
    "detez": "PulseDatasetDetWithEZ",
    "2dz": "PulseDataset2DWithZ",
    "2dez": "PulseDataset2DWithEZ",
    "wfpair": "PulseDatasetWFPair",
    "wfpairez": "PulseDatasetWFPairEZ",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dirs", nargs="+", help="data directories (one per class)")
    p.add_argument("--type", "-t", default="2d", choices=sorted(TYPE_MAP),
                   help="dataset type")
    p.add_argument("--base_path", "-b", default="",
                   help="base path the directories are relative to")
    p.add_argument("--num_events", "-n", type=float, default=1e9,
                   help="events per directory")
    p.add_argument("--shuffled_size", "-s", type=int, default=16384,
                   help="events per combined output file")
    p.add_argument("--out_dir", "-o", default=None,
                   help="output directory for Combined_* files")
    p.add_argument("--verbosity", "-v", type=int, default=3)
    p.add_argument("--config", "-c", type=str, default=None,
                   help="config file overriding chunk_size / shuffled_size")
    return p


def main(argv: Optional[list] = None) -> int:
    from waveformml_tpu_torch.config import Config, load_config
    from waveformml_tpu_torch.registry import retrieve_class
    from waveformml_tpu_torch.utils.util import setup_logger

    args = build_parser().parse_args(sys.argv[1:] if argv is None else list(argv))
    setup_logger(args.verbosity)
    shuffled_size = args.shuffled_size
    chunk_size = None
    if args.config:
        dc = load_config(args.config, validate=False).dataset_config
        shuffled_size = int(getattr(dc, "shuffled_size", shuffled_size))
        chunk_size = getattr(dc, "chunk_size", None)
    dataset_config = {"base_path": args.base_path, "paths": list(args.dirs),
                      "data_prep": "shuffle", "shuffled_size": shuffled_size,
                      "dataset_params": {}}
    if chunk_size is not None:
        dataset_config["chunk_size"] = int(chunk_size)
    config = Config({
        "system_config": {"model_name": "combine", "model_base_path": "./model",
                          "n_samples": 0,
                          "type_names": [os.path.basename(d) for d in args.dirs]},
        "dataset_config": dataset_config,
    })
    cls = retrieve_class(TYPE_MAP[args.type])
    kwargs = {"data_dir": args.out_dir} if args.out_dir else {}
    dataset = cls(config, "train", int(args.num_events), **kwargs)
    dataset.write_shuffled()
    print(f"Combined files written to {dataset.data_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
