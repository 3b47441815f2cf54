"""One rank of a data-parallel run of the port on the CPU, for
tests/test_torch_distributed.py: ``python _torch_dist_worker.py <job> <rank>
<world>``.

The job (a pickle the test wrote) names the rendezvous (``file://`` URL)
and the cases. The rank joins the process group once; for each case it
builds the task on the CPU from the case's config and initial
``state_dict`` and runs ``Trainer.fit`` (and ``Trainer.test`` where the
case has test blocks) over the case's blocks, which the Trainer reads
round-robin. It writes ``<job>.rank<r>`` (a pickle): each case's step
losses, fit and test metrics, final ``state_dict``, best checkpoint path,
dropout seed and whether it had a logger. Imports torch and the port
only.
"""
import pickle
import sys

import torch
import torch.distributed as dist


class _Logger:
    """A logger that keeps nothing (the Trainer keeps one on rank 0 only)."""

    log_dir = None

    def log_scalar(self, *args, **kwargs):
        pass

    log_scalars = log_figure = log_histogram = log_scalar

    def flush(self):
        pass


def run_case(case: dict, rank: int) -> dict:
    from waveformml_tpu_torch.config import Config
    from waveformml_tpu_torch.datasets.synthetic import BlockDataModule
    from waveformml_tpu_torch.engineering.trainer import Trainer
    from waveformml_tpu_torch.registry import retrieve_class

    cfg = Config(case["config"])
    task = retrieve_class(cfg.run_config.run_class)(cfg, "cpu")
    task.model.load_state_dict({k: torch.as_tensor(v) for k, v in case["init"].items()})
    trainer = Trainer(cfg, task, device="cpu", logger=_Logger(),
                      **case.get("trainer", {}))
    dm = BlockDataModule(case["train"], case.get("val", ()), case.get("test", ()))
    out = {"fit": trainer.fit(dm), "step_losses": list(trainer.step_losses),
           "best_ckpt_path": trainer.best_ckpt_path, "rank": trainer.rank,
           "world_size": trainer.world_size, "seed": trainer.generator.initial_seed(),
           "logger": trainer.logger is not None}
    if case.get("test"):
        collected = []
        out["test"] = trainer.test(dm, collect=lambda block, db, test_out: collected.append(
            (block.labels.shape[0], test_out["logits"].shape[0])))
        out["collected"] = collected
    out["state"] = {k: v.detach().cpu().numpy() for k, v in task.model.state_dict().items()}
    return out


def main(job_path: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    from waveformml_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(job["init_method"], world, rank, device="cpu")
    try:
        results = {name: run_case(case, rank) for name, case in job["cases"].items()}
    finally:
        dist.destroy_process_group()
    with open(f"{job_path}.rank{rank}", "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
