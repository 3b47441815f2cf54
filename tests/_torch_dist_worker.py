"""One rank of a data-parallel or tensor-parallel run of the port on the
CPU, for tests/test_torch_distributed.py and tests/test_torch_gspmd.py:
``python _torch_dist_worker.py <job> <rank> <world>``.

The job (a pickle the test wrote) names the rendezvous (``file://`` URL)
and the cases. The rank joins the process group once; for each case it
builds the task on the CPU from the case's config and initial
``state_dict`` and, where the case says so, loads a checkpoint
(``load``, ``restore``); then runs ``Trainer.fit`` (and ``Trainer.test``
where the case has test blocks) over the case's blocks, which the Trainer
reads round-robin, and saves a checkpoint where the case names one
(``save``). With ``units`` in the job it also runs ``run_units``, the
column functions' checks. It writes ``<job>.rank<r>`` (a pickle): each
case's step losses, fit and test metrics, final one-rank ``state_dict``
(gathered under tp), best checkpoint path, dropout seed, place on the
grid, the shapes of its blocks, whether it had a logger and the figures
that logger got. Imports torch and the port only.
"""
import pickle
import sys

import torch
import torch.distributed as dist


class _Logger:
    """A logger that keeps the tags of the figures it gets (the Trainer
    keeps one on rank 0 only)."""

    log_dir = None

    def __init__(self):
        self.figures = []

    def log_figure(self, tag, fig=None, step=0, close=True):
        self.figures.append(tag)
        if fig is not None:
            import matplotlib.pyplot as plt

            plt.close(fig)

    def log_histogram(self, tag, *args, **kwargs):
        self.figures.append(tag)

    def log_scalar(self, *args, **kwargs):
        pass

    log_scalars = log_scalar

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
    logger = _Logger()
    trainer = Trainer(cfg, task, device="cpu", logger=logger, **case.get("trainer", {}))
    out = {}
    if case.get("load"):
        trainer.load_checkpoint(case["load"], restore_training=case.get("restore", False))
        out["loaded"] = {k: v.detach().cpu().clone().numpy()
                         for k, v in trainer.model_state_dict().items()}
    dm = BlockDataModule(case["train"], case.get("val", ()), case.get("test", ()))
    mesh = trainer.mesh
    out.update(
        fit=trainer.fit(dm) if case["train"] else {}, step_losses=list(trainer.step_losses),
        best_ckpt_path=trainer.best_ckpt_path, rank=trainer.rank,
        world_size=trainer.world_size, seed=trainer.generator.initial_seed(),
        logger=trainer.logger is not None, mesh=mesh.shape if mesh is not None else None,
        data_index=trainer.data_index, model_index=trainer.model_index,
        blocks={k: tuple(v.shape) for k, v in task.model.state_dict().items()
                if trainer.tensor_parallel is not None and k in trainer.tensor_parallel.specs})
    if case.get("test"):
        collected = []
        collect = None
        if not case.get("evaluator"):
            def collect(block, db, test_out):
                collected.append((block.labels.shape[0], test_out["logits"].shape[0]))
        out["test"] = trainer.test(dm, collect=collect)
        out["collected"] = collected
        out["figures"] = list(logger.figures)
    if case.get("save"):
        trainer.save_checkpoint(case["save"])
    out["state"] = {k: v.detach().cpu().numpy() for k, v in trainer.model_state_dict().items()}
    return out


def run_units(rank: int) -> dict:
    """The column functions on a (world / 2, 2) grid: the forward and the
    gradients of ``gather_from_model``∘matmul∘``copy_to_model`` (a column
    block of a weight), of ``column_linear`` with its bias, and of
    ``gather_weight``; the global-norm clip of a sharded and a replicated
    gradient; a ``shard_params``/``gather_params`` round trip. The inputs
    are seeded alike on every rank, so each result can be held to one
    rank's arithmetic on the whole tensors."""
    from torch import nn

    from waveformml_tpu_torch.optim import clip_by_global_norm_
    from waveformml_tpu_torch.parallel.gspmd import (ShardSpec, TensorParallel, block_of,
                                                     column_linear, copy_to_model,
                                                     gather_from_model, gather_weight,
                                                     make_mesh_2d)

    mesh = make_mesh_2d(tp=2)
    m = mesh.model_index
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(5, 6, generator=gen, dtype=torch.float64)
    w = torch.randn(6, 16, generator=gen, dtype=torch.float64)
    b = torch.randn(16, generator=gen, dtype=torch.float64)
    g = torch.randn(5, 16, generator=gen, dtype=torch.float64)
    out = {"mesh": (mesh.data_index, mesh.model_index)}

    # Megatron's pair around a column block of w: y = x @ w
    xs = x.clone().requires_grad_()
    ws = block_of(w, ShardSpec(1, 1), 2, m).requires_grad_()
    y = gather_from_model(copy_to_model(xs, mesh) @ ws, mesh)
    y.backward(g)
    out["pair"] = (y.detach(), xs.grad, ws.grad)

    # nn.Linear's column form, the bias replicated and added after the gather
    wl = w.t().contiguous()                                   # [out, in]
    xs = x.clone().requires_grad_()
    wb = block_of(wl, ShardSpec(0, 1), 2, m).requires_grad_()
    bs = b.clone().requires_grad_()
    y = column_linear(xs, wb, bs, mesh)
    y.backward(g)
    out["linear"] = (y.detach(), xs.grad, wb.grad, bs.grad)

    # gather_weight of a gate-blocked parameter ([3·8, 6]: three blocks)
    spec = ShardSpec(0, 3)
    full = torch.randn(24, 6, generator=gen, dtype=torch.float64)
    gw = torch.randn(24, 6, generator=gen, dtype=torch.float64)
    blk = block_of(full, spec, 2, m).requires_grad_()
    whole = gather_weight(blk, spec, mesh)
    whole.backward(gw)
    out["gather_weight"] = (whole.detach(), blk.grad)

    # the global-norm clip: grads[0] sharded, grads[1] replicated
    sharded = block_of(g.clone(), ShardSpec(1, 1), 2, m)
    grads = [sharded, b.clone()]
    norm = clip_by_global_norm_(grads, 1.0, [True, False], mesh.model_group)
    out["clip"] = (norm, grads[0], grads[1])

    # shard_params then gather_params of a model with a sharded Linear, a
    # gate-blocked GRU and replicated leaves
    torch.manual_seed(0)
    model = nn.Module()
    model.dense_0 = nn.Linear(6, 16)
    model.cell_0 = nn.GRU(6, 16, 1, batch_first=True)
    model.dense_1 = nn.Linear(16, 2)
    full_state = {k: v.clone() for k, v in model.state_dict().items()}
    tp = TensorParallel(model, mesh)
    blocks = tp.shard_params(full_state)
    out["roundtrip"] = (full_state, tp.gather_params(blocks), sorted(tp.specs),
                        {k: tuple(v.shape) for k, v in blocks.items()})
    return out


def main(job_path: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    from waveformml_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(job["init_method"], world, rank, device="cpu")
    try:
        results = {name: run_case(case, rank) for name, case in job["cases"].items()}
        if job.get("units"):
            results["units"] = run_units(rank)
    finally:
        dist.destroy_process_group()
    with open(f"{job_path}.rank{rank}", "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
