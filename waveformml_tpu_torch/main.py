"""Train driver of the port: ``python -m waveformml_tpu_torch.main <config> [options]``.

The counterpart of the JAX package's ``main.py``, flag for flag: the
config is loaded and validated (``-cv`` validates against another
requirements file); the experiment name is ``run_config.exp_name`` (``-n``
overrides it), incremented as ``<name>_<i>`` where a run of that name
exists, unless a run resumes; each run writes
``<model_base_path>/<model_name>/runs/<exp>/version_<n>/`` with
``run_info.json``, the TensorBoard scalars (where tensorboardX is
installed) and the best checkpoint. ``-lc`` starts from a checkpoint,
``-lb`` from the best one under the model folder, ``-r`` also restores the
optimizer, scheduler and epoch; ``--auto_lr_find`` sets the lr from
``Trainer.lr_find``; the Trainer's arguments are flags. Then fit, printing
``fit: {...}``, and with ``-t`` a test pass, printing ``test: {...}``, with
the JAX CLI's keys. ``--validate`` checks the ``algorithm`` DSL's shapes
(``utils.model_validation``) before anything is built, and raises
``IOError`` on a mismatch. ``--profiler`` writes ``profile_results.txt``
and a ``torch.profiler`` trace (``profile/``) into the run directory.

``-oc <study.json>`` runs a hyperparameter study instead
(``optimization.hpo.ModelOptimization``, one fit per trial with the
Trainer flags given, ``-p`` pruning with the median pruner) into
``<model_base_path>/<model_name>/studies/<exp>/``; a study of that name
resumes.

``--distributed`` makes the process one rank of a data-parallel run
(``parallel.mesh.initialize_distributed``: ``--coordinator host:port`` or a
``file://`` URL with ``--num_processes`` and ``--process_id``, else
torchrun's environment), one process per GPU: rank 0 picks the run
directory and sends it to the others, and alone writes ``run_info.json``,
the TensorBoard scalars and the checkpoint; the group is left at the end.
With ``-oc`` it is refused. ``--parallel gspmd --tp N`` under
``--distributed`` runs the JAX package's GSPMD engine as tensor
parallelism: the ranks form a ``(world / N, N)`` grid of (data, model)
ranks, and the model's wide parameters are column-sharded over each model
group (``parallel.gspmd``); the checkpoint is the one-rank file. ``--tp``
> 1 without ``--distributed``, or over a ``--num_processes`` that does not
divide by it, raises before anything starts.

``--device`` (default ``cuda``) picks the device: the card (under
``--distributed``, ``cuda:<local rank>``), or ``cpu`` for the plain
PyTorch versions of the kernels (Gloo between ranks). HDF5 input needs
h5py.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Any, Dict, Optional


def build_parser() -> argparse.ArgumentParser:
    from waveformml_tpu_torch.engineering.trainer import Trainer, int_or_float

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config", help="path to the experiment config JSON/YAML")
    p.add_argument("--name", "-n", type=str, default=None,
                   help="override run_config.exp_name for this run")
    p.add_argument("--config_validation", "-cv", type=str, default=None,
                   help="path to a custom config-requirements JSON")
    p.add_argument("--test", "-t", action="store_true",
                   help="run the test pass after training")
    p.add_argument("--verbosity", "-v", type=int, default=3, help="log verbosity 0-5")
    p.add_argument("--logfile", "-l", default=None)
    p.add_argument("--load_checkpoint", "-lc", default=None,
                   help="checkpoint path to start from")
    p.add_argument("--load_best", "-lb", action="store_true",
                   help="find and load the best checkpoint in the model folder")
    p.add_argument("--restore_training", "-r", action="store_true",
                   help="resume optimizer/scheduler/epoch state as well")
    p.add_argument("--num_threads", "-nt", type=int, default=None)
    p.add_argument("--optuna_config", "-oc", default=None,
                   help="hyperparameter-optimization config (runs a study)")
    p.add_argument("--pruning", "-p", action="store_true",
                   help="enable trial pruning during HPO")
    p.add_argument("--auto_lr_find", action="store_true")
    p.add_argument("--validate", action="store_true",
                   help="statically validate the algorithm DSL before training")
    p.add_argument("--profiler", action="store_true",
                   help="write profile_results.txt and a torch.profiler trace "
                        "(<log dir>/profile/) of the fit")
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--overfit_batches", type=int_or_float, default=None)
    p.add_argument("--limit_train_batches", type=int_or_float, default=None)
    p.add_argument("--limit_val_batches", type=int_or_float, default=None)
    p.add_argument("--limit_test_batches", type=int_or_float, default=None)
    p.add_argument("--gradient_clip_val", type=float, default=None,
                   help="clip gradients to this global norm")
    p.add_argument("--accumulate_grad_batches", type=int, default=1,
                   help="apply the optimizer every k batches")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel (with --tp N, data x tensor-parallel) training, one "
                        "process per GPU (torchrun's environment, or --coordinator)")
    p.add_argument("--coordinator", default=None,
                   help="rendezvous address host:port, or a file:// URL")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (the card, the default) or cpu")
    Trainer.add_argparse_args(p)
    return p


def choose_data_module(config):
    """The config's ``dataset_config.data_module`` (``PSDDataModule`` by
    default), built from the config."""
    from waveformml_tpu_torch.registry import retrieve_class

    name = getattr(config.dataset_config, "data_module", None) or "PSDDataModule"
    return retrieve_class(name)(config)


def _tb_logger(log_dir: str, log: logging.Logger):
    from waveformml_tpu_torch.utils.tb import TBLogger

    try:
        return TBLogger(log_dir)
    except ImportError:
        log.warning("tensorboardX is not installed: no TensorBoard scalars are written")
        return None


def _rounded(metrics: Dict[str, Any]) -> Dict[str, float]:
    return {k: round(v, 5) for k, v in metrics.items() if isinstance(v, (int, float))}


def run(config, args: argparse.Namespace, data_module) -> Dict[str, Any]:
    """Train (and with ``args.test`` test) ``config``'s task on
    ``data_module`` as ``main`` does once it has parsed the flags and built
    the data module: with ``args.distributed`` the process group first
    (left again at the end), then the run directory, its run info and
    logger, the checkpoint to start from, the lr finder, fit and test,
    printing the ``fit:`` and ``test:`` lines. Returns ``{"log_dir", "fit",
    "test"}`` (``test`` None without ``args.test``)."""
    if not args.distributed:
        return _run(config, args, data_module, args.device, 0)
    import torch.distributed as dist

    from waveformml_tpu_torch.parallel.mesh import initialize_distributed

    rank, _, device, _ = initialize_distributed(
        args.coordinator, args.num_processes, args.process_id,
        device=None if args.device == "cuda" else args.device)
    try:
        return _run(config, args, data_module, device, rank)
    finally:
        dist.destroy_process_group()


def _run(config, args: argparse.Namespace, data_module, device, rank: int) -> Dict[str, Any]:
    from waveformml_tpu_torch.engineering.trainer import Trainer
    from waveformml_tpu_torch.optim import set_learning_rate
    from waveformml_tpu_torch.registry import retrieve_class
    from waveformml_tpu_torch.utils.util import (get_model_folder, next_experiment_name,
                                                 next_version_dir, retrieve_best_checkpoint,
                                                 write_run_info)

    log = logging.getLogger("waveformml_tpu_torch")
    model_folder = get_model_folder(config)
    exp_name = config.run_config.exp_name
    # -r resumes only from a checkpoint; without one a fresh run starts
    resuming = args.restore_training and (args.load_checkpoint or args.load_best)
    if args.restore_training and not resuming:
        log.warning("--restore_training ignored: no --load_checkpoint/--load_best given, "
                    "starting a fresh run")
    log_dir = None
    if rank == 0:
        if not resuming:
            exp_name = next_experiment_name(model_folder, exp_name)
        log_dir = next_version_dir(os.path.join(model_folder, "runs", exp_name))
    if args.distributed:
        # every rank writes into the run directory rank 0 picked
        import torch.distributed as dist

        box = [log_dir]
        dist.broadcast_object_list(box, src=0)
        log_dir = box[0]
    logger = None
    if rank == 0:
        logger = _tb_logger(log_dir, log)
        write_run_info(log_dir)
    log.info("logging to %s", log_dir)
    try:
        task = retrieve_class(config.run_config.run_class)(config, device)
        trainer = Trainer(config, task, logger=logger, checkpoint_dir=log_dir,
                          **{**Trainer.kwargs_from_args(args), "device": device})
        ckpt = args.load_checkpoint
        if args.load_best and not ckpt:
            ckpt = retrieve_best_checkpoint(model_folder)
            if ckpt is None:
                raise IOError(f"--load_best: no checkpoint found under {model_folder}")
            log.info("best checkpoint: %s", ckpt)
        if ckpt:
            trainer.load_checkpoint(ckpt, restore_training=args.restore_training)
        if args.auto_lr_find:
            new_lr = trainer.lr_find(data_module)
            trainer.lr = new_lr
            set_learning_rate(trainer.optimizer, new_lr)
            if trainer.scheduler is not None:
                trainer.scheduler.base_lr = new_lr
        fit_metrics = trainer.fit(data_module)
        print("fit:", _rounded(fit_metrics), flush=True)
        test_metrics = None
        if args.test:
            test_metrics = trainer.test(data_module)
            print("test:", _rounded(test_metrics), flush=True)
    finally:
        if logger is not None:
            logger.close()
    return {"log_dir": log_dir, "fit": fit_metrics, "test": test_metrics}


def main(argv: Optional[list] = None) -> int:
    from waveformml_tpu_torch.config import load_config, validate_config
    from waveformml_tpu_torch.utils.util import apply_num_threads, setup_logger

    args = build_parser().parse_args(sys.argv[1:] if argv is None else list(argv))
    if args.optuna_config and args.distributed:
        raise SystemExit("HPO studies are single-host (each trial already uses every "
                         "local device); drop --distributed for -oc runs")
    from waveformml_tpu_torch.engineering.trainer import Trainer

    Trainer.check_engine(args.parallel, args.tp,
                         (args.num_processes if args.distributed else 1))
    apply_num_threads(args.num_threads)
    config = load_config(args.config, validate=args.config_validation is None)
    if args.config_validation:
        with open(args.config_validation) as f:
            validate_config(config, json.load(f))
    if args.name:
        config.run_config.exp_name = args.name
    log = setup_logger(args.verbosity, args.logfile)
    if args.validate:
        from waveformml_tpu_torch.utils.model_validation import ModelValidation

        ModelValidation.validate(config)
        log.info("model validation passed")
    if args.optuna_config:
        from waveformml_tpu_torch.engineering.trainer import Trainer
        from waveformml_tpu_torch.optimization.hpo import ModelOptimization
        from waveformml_tpu_torch.utils.util import get_model_folder

        opt_config = load_config(args.optuna_config, validate=False)
        ModelOptimization(opt_config, config, get_model_folder(config),
                          trainer_args=Trainer.kwargs_from_args(args)
                          ).run_study(pruning=args.pruning)
        return 0
    run(config, args, choose_data_module(config))
    return 0


if __name__ == "__main__":
    sys.exit(main())
