"""Evaluation entry point of the port: ``python -m waveformml_tpu_torch.evaluate
<config> <checkpoint> [options]``.

The counterpart of the JAX package's ``Evaluate.py``: load the config
(``-c`` overrides its ``dataset_config.calgroup``, ``-oc`` occludes a
feature column at test time) and a checkpoint of the port's ``Trainer``,
run the test pass (``Trainer.test``: the task's evaluator fed every test
batch, rendered by the ``LoggingCallback`` through the logger) and print
``test: {...}``. The TensorBoard files go into the checkpoint's version
directory where it holds a run's event file, else into its ``evaluate/``
subdirectory; ``-oc n`` writes into ``occlude_<n>`` below that. Without
tensorboardX the pass runs without a logger (no figures, no scalars), with
a warning; the figures need matplotlib.

``--device`` (default ``cuda``) picks the device: the card, or ``cpu`` for
the plain PyTorch versions of the kernels. HDF5 input needs h5py.
``--script`` writes the eval forward, traced on the first test block, to
``model.pt2`` in the log directory before the test pass (``torch.export``,
the counterpart of the JAX package's StableHLO export; the kernels are the
nodes of their custom ops); ``engineering.trainer.load_exported`` reloads
it.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Any, Dict, Optional

def build_parser() -> argparse.ArgumentParser:
    from waveformml_tpu_torch.engineering.trainer import int_or_float

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config", help="config file of the model")
    p.add_argument("checkpoint", help="checkpoint of the port's Trainer")
    p.add_argument("--calgroup", "-c", type=str, default=None,
                   help="calibration group for the evaluation")
    p.add_argument("--occlude", "-oc", type=int, default=None,
                   help="feature index to occlude (zero) at test time")
    p.add_argument("--script", "-s", action="store_true",
                   help="export the eval forward to <log dir>/model.pt2 before the "
                        "test pass (torch.export; reload with "
                        "engineering.trainer.load_exported)")
    p.add_argument("--verbosity", "-v", type=int, default=3)
    p.add_argument("--num_threads", "-nt", type=int, default=None)
    # an int is a batch count, a float <= 1 a fraction of the loader
    p.add_argument("--limit_test_batches", type=int_or_float, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the card, the default) or cpu")
    return p


def log_dir_for(checkpoint: str, occlude: Optional[int] = None) -> str:
    """The checkpoint's directory where it holds a TensorBoard event file,
    else its ``evaluate/`` subdirectory; with ``occlude``, ``occlude_<n>``
    below that (ref: Evaluate.py:52-68)."""
    ckpt_dir = os.path.dirname(os.path.abspath(checkpoint))
    has_events = os.path.isdir(ckpt_dir) and any("tfevents" in f for f in os.listdir(ckpt_dir))
    log_dir = ckpt_dir if has_events else os.path.join(ckpt_dir, "evaluate")
    if occlude is not None:
        log_dir = os.path.join(log_dir, f"occlude_{occlude}")
    return log_dir


def apply_overrides(config, args: argparse.Namespace) -> None:
    """``-c`` sets ``dataset_config.calgroup``, ``-oc`` its
    ``occlude_index``."""
    if args.calgroup:
        config.dataset_config["calgroup"] = args.calgroup
    if args.occlude is not None:
        config.dataset_config["occlude_index"] = args.occlude


def run(config, args: argparse.Namespace, data_module, logger=None) -> Dict[str, Any]:
    """Evaluate ``args.checkpoint`` on ``data_module``'s test set as
    ``main`` does once it has parsed the flags, applied the overrides to
    ``config`` (``apply_overrides``) and built the data module: the log
    directory and its logger (``logger`` where given, else a TensorBoard
    logger there, None without tensorboardX), the checkpoint, with
    ``args.script`` the export of the eval forward on the first test block
    to ``<log_dir>/model.pt2``, the test pass and the ``test:`` line.
    Returns ``{"log_dir", "test", "trainer", "exported"}`` (the export's
    path, or None)."""
    from waveformml_tpu_torch.engineering.trainer import Trainer, _take
    from waveformml_tpu_torch.main import _rounded, _tb_logger
    from waveformml_tpu_torch.registry import retrieve_class

    log = logging.getLogger("waveformml_tpu_torch")
    log_dir = log_dir_for(args.checkpoint, args.occlude)
    own_logger = logger is None
    if own_logger:
        logger = _tb_logger(log_dir, log)
    log.info("logging the evaluation to %s", log_dir)
    try:
        task = retrieve_class(config.run_config.run_class)(config, args.device)
        trainer = Trainer(config, task, args.device, logger=logger,
                          limit_test_batches=args.limit_test_batches)
        trainer.load_checkpoint(args.checkpoint)
        exported = None
        if args.script:
            data_module.setup("test")
            first = next(iter(_take(data_module.test_dataloader(), 1)))
            exported = trainer.export_model(os.path.join(log_dir, "model.pt2"), first)
        metrics = trainer.test(data_module)
    finally:
        if own_logger and logger is not None:
            # the event file is complete once this returns (the occlusion
            # study reads test_loss back from it)
            logger.close()
    print("test:", _rounded(metrics), flush=True)
    return {"log_dir": log_dir, "test": metrics, "trainer": trainer, "exported": exported}


def main(argv: Optional[list] = None) -> int:
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.main import choose_data_module
    from waveformml_tpu_torch.utils.util import apply_num_threads, setup_logger

    args = build_parser().parse_args(sys.argv[1:] if argv is None else list(argv))
    apply_num_threads(args.num_threads)
    setup_logger(args.verbosity)
    config = load_config(args.config)
    apply_overrides(config, args)
    run(config, args, choose_data_module(config))
    return 0


if __name__ == "__main__":
    sys.exit(main())
