"""The port's Trainer against the JAX Trainer: a narrow SubMPSD trained from
the same flax init, on the same blocks, with the shipped optimizer (SGD,
lr 0.01, momentum 0.98, nesterov) and ExponentialLR (γ 0.9) stepped once
per epoch, 3 epochs of 10 steps. Per-step losses and the BatchNorm running
statistics agree, the loss falls, and the best checkpoint serves through
``InferenceModel`` on the CPU."""
import copy

import numpy as np
import pytest
import torch

from waveformml_tpu_torch.config import Config
from waveformml_tpu_torch.convert import flax_to_state_dict
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.datasets.synthetic import BlockDataModule, labelled_block
from waveformml_tpu_torch.engineering.tasks import LitPSD
from waveformml_tpu_torch.engineering.trainer import Trainer
from waveformml_tpu_torch.inference.model import InferenceModel

NX, NY = 14, 11
EPOCHS, STEPS = 3, 10

CFG = {
    "run_config": {"exp_name": "t", "run_class": "LitPSD", "imports": []},
    "system_config": {"model_name": "t", "n_samples": 8, "n_type": 2,
                      "type_names": ["a", "b"], "half_precision": 0},
    "net_config": {"criterion_class": "CrossEntropyLoss", "criterion_params": [],
                   "imports": [], "net_class": "SubMPSDNet", "net_type": "2DConvolution",
                   "hparams": {"out_planes": 8, "n_lin": 2,
                               "conv_params": {"kernel_size": 3, "n_conv": 2, "n_point": 1,
                                               "conv_position": 1, "version": 2}}},
    "optimize_config": {"total_epoch": EPOCHS, "lr": 0.01, "validation_freq": 1,
                        "imports": [], "optimizer_class": "optim.SGD",
                        "optimizer_params": {"momentum": 0.98, "nesterov": True},
                        "scheduler_class": "lr_scheduler.ExponentialLR",
                        "scheduler_params": {"gamma": 0.9}},
    "dataset_config": {"mode": "path", "imports": [], "paths": ["a", "b"],
                       "dataset_class": "PulseDataset2D", "dataset_params": {}},
}


def _blocks(rng, n_blocks, n_events=12):
    """Events of 3 distinct sites each, 16 features a row, labels the sign of
    a sum of their first row's features (learnable)."""
    out = []
    for _ in range(n_blocks):
        coords = np.asarray([[s % NX, s // NX, e] for e in range(n_events)
                             for s in rng.choice(NX * NY, size=3, replace=False)], np.int32)
        feats = rng.normal(size=(coords.shape[0], 16)).astype(np.float32)
        labels = (feats[::3, :8].sum(1) > 0).astype(np.int64)
        out.append(FileBlock(coords, feats, labels))
    return out


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """The JAX Trainer stepped through its train step and its ExponentialLR
    as its fit does, and the port's Trainer.fit from the converted init."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict

    from waveformml_tpu import optim as wopt
    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock
    from waveformml_tpu.engineering.tasks import LitPSD as JaxLitPSD
    from waveformml_tpu.engineering.trainer import Trainer as JaxTrainer
    from waveformml_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(2025)
    train, val = _blocks(rng, STEPS), _blocks(rng, 2)
    jcfg = JaxConfig(copy.deepcopy(CFG))
    jtrainer = JaxTrainer(jcfg, JaxLitPSD(jcfg), mesh=make_mesh(jax.devices()[:1]), seed=0)
    jblocks = [JaxFileBlock(b.coords, b.feats, b.labels, {}) for b in train]
    jtrainer._ensure_state(jblocks[0])
    flat = flatten_dict(jax.device_get({"params": jtrainer.state.params,
                                        "batch_stats": jtrainer.state.batch_stats}), sep="/")
    init = flax_to_state_dict({k: np.asarray(v) for k, v in flat.items()})

    jax_losses = []
    for epoch in range(EPOCHS):
        for i, block in enumerate(jblocks):
            db = {k: jnp.asarray(v) for k, v in jtrainer._device_batch(block).items()}
            st = jtrainer.state
            st.params, st.batch_stats, st.opt_state, loss, _ = jtrainer._train_step_fn(
                st.params, st.batch_stats, st.opt_state,
                jax.random.PRNGKey(epoch * STEPS + i), db)
            jax_losses.append(float(loss))
        jtrainer.state.opt_state = wopt.set_learning_rate(jtrainer.state.opt_state,
                                                          jtrainer.scheduler.step())
    jax_stats = {k: np.asarray(v) for k, v in flatten_dict(
        jax.device_get(jtrainer.state.batch_stats), sep="/").items()}

    cfg = Config(copy.deepcopy(CFG))
    task = LitPSD(cfg, device="cpu")
    task.model.load_state_dict(init)
    trainer = Trainer(cfg, task, device="cpu",
                      checkpoint_dir=str(tmp_path_factory.mktemp("ckpt")))
    metrics = trainer.fit(BlockDataModule(train, val, val))
    return dict(cfg=cfg, trainer=trainer, metrics=metrics, jax_losses=jax_losses,
                jax_stats=jax_stats, val=val, jtrainer=jtrainer)


def test_losses_match_jax_step_by_step(trajectories):
    got = np.asarray(trajectories["trainer"].step_losses)
    want = np.asarray(trajectories["jax_losses"])
    assert got.shape == want.shape == (EPOCHS * STEPS,)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_loss_falls(trajectories):
    losses = np.asarray(trajectories["trainer"].step_losses).reshape(EPOCHS, STEPS)
    assert np.isfinite(losses).all()
    assert losses[-1].mean() < losses[0].mean(), losses.mean(1)


@pytest.mark.parametrize("layer", ["l1", "l4"])
@pytest.mark.parametrize("stat", ["mean", "var"])
def test_batchnorm_running_stats_match_jax(trajectories, layer, stat):
    model = trajectories["trainer"].task.model
    got = getattr(model.stack, layer).__getattr__(f"running_{stat}").numpy()
    np.testing.assert_allclose(got, trajectories["jax_stats"][f"stack/{layer}/{stat}"],
                               rtol=1e-3, atol=1e-4)


def test_scheduler_stepped_once_per_epoch(trajectories):
    trainer = trajectories["trainer"]
    assert trainer.current_epoch == EPOCHS and trainer.scheduler.epoch == EPOCHS
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(0.01 * 0.9 ** EPOCHS)
    assert len(trainer.step_phases) == EPOCHS * STEPS
    phase = trainer.step_phases[0]
    assert phase["device_ms"] is None and phase["events"] == 12
    assert all(phase[k] >= 0 for k in ("host_prep_s", "h2d_s", "wall_s"))
    assert {"train_loss", "train_accuracy", "val_loss", "val_accuracy"} <= set(
        trajectories["metrics"])


def test_best_checkpoint_serves_through_inference_model(trajectories):
    """The checkpoint holds the model, optimizer, scheduler and gradient
    accumulation state, the epoch, the step and the best validation loss;
    InferenceModel takes it and serves the validation blocks with the
    loss the trainer recorded for that epoch (rtol 1e-5)."""
    trainer = trajectories["trainer"]
    path = trainer.best_ckpt_path
    assert path is not None and f"val_loss={trainer.best_val_loss:.2f}.ckpt" in path
    ckpt = torch.load(path, weights_only=True)
    assert sorted(ckpt) == ["best_val_loss", "epoch", "multi_steps", "optimizer",
                            "scheduler", "state_dict", "step"]
    assert ckpt["best_val_loss"] == trainer.best_val_loss and ckpt["multi_steps"] is None
    server = InferenceModel(trajectories["cfg"], path, device="cpu")
    loss_sum, count = 0.0, 0
    for block in trajectories["val"]:
        logits = torch.from_numpy(server(block.coords, block.feats))
        loss_sum += float(torch.nn.functional.cross_entropy(
            logits, torch.from_numpy(block.labels), reduction="sum"))
        count += block.labels.shape[0]
    assert loss_sum / count == pytest.approx(trainer.best_val_loss, rel=1e-5)


def test_test_returns_the_test_outputs(trajectories):
    trainer = trajectories["trainer"]
    val = trajectories["val"]
    outputs, blocks = [], []

    def collect(block, db, test_out):
        blocks.append(block)
        outputs.append(test_out)

    metrics = trainer.test(BlockDataModule([], [], val), collect=collect)
    assert len(outputs) == len(val)
    for out, block, want in zip(outputs, blocks, val):
        assert block is want
        assert sorted(out) == ["logits", "logprob", "pred"]
        assert out["logits"].shape == (block.labels.shape[0], 2)
        np.testing.assert_array_equal(out["pred"], out["logits"].argmax(-1))
    assert set(metrics) == {"test_loss", "test_accuracy"}
    assert trainer.validate(BlockDataModule([], val))["val_loss"] == pytest.approx(
        metrics["test_loss"])


def test_test_metrics_match_the_jax_trainer_test(trajectories):
    """Trainer.test returns the test metrics under the JAX Trainer's keys,
    equal to its Trainer.test on the same weights and blocks, and hands
    each block's outputs to ``collect`` as the JAX one does."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict

    from waveformml_tpu_torch.convert import state_dict_to_flax

    trainer, jt, val = trajectories["trainer"], trajectories["jtrainer"], trajectories["val"]
    variables = unflatten_dict({k: jnp.asarray(v) for k, v in
                                state_dict_to_flax(trainer.task.model.state_dict()).items()},
                               sep="/")
    jt.state.params = jax.device_put(variables["params"])
    jt.state.batch_stats = jax.device_put(variables["batch_stats"])
    jax_logits, logits = [], []
    want = jt.test(BlockDataModule([], [], val),
                   collect=lambda block, db, out: jax_logits.append(
                       np.asarray(out["logits"])[0, :block.labels.shape[0]]))
    got = trainer.test(BlockDataModule([], [], val),
                       collect=lambda block, db, out: logits.append(out["logits"]))
    assert set(got) == set(want) == {"test_loss", "test_accuracy"}
    # the JAX package sums the accuracy in float32
    assert got["test_accuracy"] == pytest.approx(want["test_accuracy"], rel=1e-6)
    assert got["test_loss"] == pytest.approx(want["test_loss"], rel=1e-5)
    assert len(logits) == len(jax_logits) == len(val)
    for a, b in zip(logits, jax_logits):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_trainer_needs_cuda_without_a_device(monkeypatch):
    cfg = Config(copy.deepcopy(CFG))
    task = LitPSD(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, task)


def test_labelled_blocks_interleave_both_kinds():
    block = labelled_block(np.random.default_rng(3), 200, 8)
    assert set(np.unique(block.labels)) == {0, 1}
    # neither kind comes in one run: the kinds change many times
    assert (np.diff(block.labels) != 0).sum() > 50
    assert block.coords[:, -1].max() == 199 and block.feats.shape[1] == 16
    assert 0 <= block.feats.min() and block.feats.max() <= 1
