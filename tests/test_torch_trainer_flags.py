"""The port's Trainer arguments against the JAX Trainer's: a narrow
SubMPSD from the same flax init, on the same blocks, through each package's
``fit`` (the JAX per-step losses recorded around its train step). Losses
and final weights agree at the trajectory tolerance rtol 2e-3, atol 2e-4
(tests/test_parity_torch.py), for gradient clipping, gradient accumulation
across an epoch boundary, Adam with StepLR, early stopping, the batch
limits, terminate_on_nan and lr_find; a resumed fit equals an uninterrupted
one on the CPU."""
import copy

import numpy as np
import pytest
import torch

from waveformml_tpu_torch.config import Config
from waveformml_tpu_torch.convert import flax_to_state_dict
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.datasets.synthetic import BlockDataModule
from waveformml_tpu_torch.engineering.tasks import LitPSD
from waveformml_tpu_torch.engineering.trainer import Trainer

NX, NY = 14, 11
RTOL, ATOL = 2e-3, 2e-4
CLIP = 0.25

CFG = {
    "run_config": {"exp_name": "t", "run_class": "LitPSD", "imports": []},
    "system_config": {"model_name": "t", "n_samples": 8, "n_type": 2,
                      "type_names": ["a", "b"], "half_precision": 0},
    "net_config": {"criterion_class": "CrossEntropyLoss", "criterion_params": [],
                   "imports": [], "net_class": "SubMPSDNet", "net_type": "2DConvolution",
                   "hparams": {"out_planes": 8, "n_lin": 2,
                               "conv_params": {"kernel_size": 3, "n_conv": 2, "n_point": 1,
                                               "conv_position": 1, "version": 2}}},
    "optimize_config": {"total_epoch": 2, "lr": 0.01, "validation_freq": 1,
                        "imports": [], "optimizer_class": "optim.SGD",
                        "optimizer_params": {"momentum": 0.98, "nesterov": True},
                        "scheduler_class": "lr_scheduler.ExponentialLR",
                        "scheduler_params": {"gamma": 0.9}},
    "dataset_config": {"mode": "path", "imports": [], "paths": ["a", "b"],
                       "dataset_class": "PulseDataset2D", "dataset_params": {}},
}
ADAM = {"optimizer_class": "optim.Adam", "optimizer_params": {"weight_decay": 1e-3},
        "scheduler_class": "lr_scheduler.StepLR",
        "scheduler_params": {"step_size": 1, "gamma": 0.5}, "lr": 0.003}


def _config(optimize=None):
    d = copy.deepcopy(CFG)
    d["optimize_config"].update(optimize or {})
    return d


def _blocks(rng, n_blocks, n_events=12, nan=False):
    """Events of 3 distinct sites each, 16 features a row, labels the sign
    of a sum of their first row's features (``nan``: NaN features)."""
    out = []
    for _ in range(n_blocks):
        coords = np.asarray([[s % NX, s // NX, e] for e in range(n_events)
                             for s in rng.choice(NX * NY, size=3, replace=False)], np.int32)
        feats = rng.normal(size=(coords.shape[0], 16)).astype(np.float32)
        labels = (feats[::3, :8].sum(1) > 0).astype(np.int64)
        if nan:
            feats[:] = np.nan
        out.append(FileBlock(coords, feats, labels))
    return out


RNG = np.random.default_rng(2026)
TRAIN = _blocks(RNG, 5)
VAL = _blocks(RNG, 2)
NAN_TRAIN = _blocks(RNG, 2, nan=True)


def _jax_fit(cfg_dict, train, val, max_epochs, **kwargs):
    """The JAX Trainer's fit; returns it, its per-step losses and metrics,
    and its initial weights as a port state_dict."""
    jt = _jax_trainer(cfg_dict, max_epochs=max_epochs, **kwargs)
    jt._ensure_state(train[0])
    init = _state_dict(jt)
    losses = []
    step = jt._train_step_fn

    def recorded(*args):
        out = step(*args)
        losses.append(float(out[3]))
        return out

    jt._train_step_fn = recorded
    metrics = jt.fit(BlockDataModule(train, val))
    return jt, losses, metrics, init


def _jax_trainer(cfg_dict, **kwargs):
    import jax

    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.engineering.tasks import LitPSD as JaxLitPSD
    from waveformml_tpu.engineering.trainer import Trainer as JaxTrainer
    from waveformml_tpu.parallel.mesh import make_mesh

    jcfg = JaxConfig(copy.deepcopy(cfg_dict))
    return JaxTrainer(jcfg, JaxLitPSD(jcfg), mesh=make_mesh(jax.devices()[:1]), seed=0,
                      callbacks=[], **kwargs)


def _state_dict(jt):
    import jax
    from flax.traverse_util import flatten_dict

    flat = flatten_dict(jax.device_get({"params": jt.state.params,
                                        "batch_stats": jt.state.batch_stats}), sep="/")
    return flax_to_state_dict({k: np.asarray(v) for k, v in flat.items()})


def _port_trainer(cfg_dict, init, max_epochs, **kwargs):
    cfg = Config(copy.deepcopy(cfg_dict))
    task = LitPSD(cfg, device="cpu")
    task.model.load_state_dict(init)
    return Trainer(cfg, task, device="cpu", max_epochs=max_epochs, **kwargs)


def _pair(cfg_dict, train, val, max_epochs, **kwargs):
    jt, jlosses, jmetrics, init = _jax_fit(cfg_dict, train, val, max_epochs, **kwargs)
    trainer = _port_trainer(cfg_dict, init, max_epochs, **kwargs)
    metrics = trainer.fit(BlockDataModule(train, val))
    return dict(jax=jt, jax_losses=jlosses, jax_metrics=jmetrics, init=init,
                trainer=trainer, metrics=metrics)


def _biases_before_batchnorm(model):
    """The conv biases a BatchNorm follows: the loss does not depend on
    them, so their gradient is rounding noise."""
    specs = model.stack.specs
    return {f"stack.l{i}.bias" for i, s in enumerate(specs[:-1])
            if s[0] == "subm" and specs[i + 1][0] == "bn"}


def _assert_trajectory(run, n_steps, skip_noise=False):
    """Per-step losses, the final validation loss and the final weights
    against the JAX run; with ``skip_noise`` (Adam, which scales the
    rounding noise in the gradient of a bias before a BatchNorm up to steps
    of ±lr) not those biases, which must stay finite."""
    got, want = np.asarray(run["trainer"].step_losses), np.asarray(run["jax_losses"])
    assert got.shape == want.shape == (n_steps,)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    jstate = _state_dict(run["jax"])
    state = run["trainer"].task.model.state_dict()
    assert sorted(state) == sorted(jstate)
    noise = _biases_before_batchnorm(run["trainer"].task.model) if skip_noise else set()
    assert len(noise) == (2 if skip_noise else 0)
    for k, v in state.items():
        if k in noise:
            assert torch.isfinite(v).all(), k
            continue
        np.testing.assert_allclose(v.numpy(), jstate[k].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert run["metrics"]["val_loss"] == pytest.approx(run["jax_metrics"]["val_loss"],
                                                       rel=RTOL, abs=ATOL)


def _first_grad_norm(init):
    """The global norm of the first step's gradients, unclipped."""
    t = _port_trainer(CFG, init, 1)
    t.training_step(t.device_batch(TRAIN[0])[0])
    return float(torch.sqrt(sum(p.grad.pow(2).sum() for p in t.params)))


@pytest.fixture(scope="module")
def clipped():
    return _pair(CFG, TRAIN, VAL, 2, gradient_clip_val=CLIP)


@pytest.fixture(scope="module")
def accumulated():
    return _pair(CFG, TRAIN, VAL, 2, gradient_clip_val=CLIP, accumulate_grad_batches=2)


def test_gradient_clip_matches_jax(clipped):
    assert _first_grad_norm(clipped["init"]) > 2 * CLIP      # the clip engaged
    _assert_trajectory(clipped, 10)


def test_gradient_accumulation_across_epochs_matches_jax(accumulated):
    """Micro-steps 0-9 over 2 epochs of 5 blocks step the optimizer on
    every second one: the fifth block's gradient is carried into the next
    epoch, and clipped as part of that mean."""
    _assert_trajectory(accumulated, 10)
    trainer = accumulated["trainer"]
    assert trainer.multi_steps.mini_step == 0 and trainer.global_step == 10
    # accumulation changed the steps: the trajectory is not the clipped one's
    clip_only = _port_trainer(CFG, accumulated["init"], 2, gradient_clip_val=CLIP)
    clip_only.fit(BlockDataModule(TRAIN, VAL))
    assert not np.allclose(trainer.step_losses[2:], clip_only.step_losses[2:], rtol=RTOL)


def test_adam_with_step_lr_matches_jax():
    cfg = _config(ADAM)
    run = _pair(cfg, TRAIN[:4], VAL, 3)
    _assert_trajectory(run, 12, skip_noise=True)
    trainer = run["trainer"]
    assert trainer.scheduler.epoch == 3
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(0.003 * 0.5 ** 3)


def test_early_stopping_at_the_jax_epoch():
    """Trained on 3 blocks, the model's loss on the validation blocks rises
    from the first epoch on: both trainers stop at the same epoch, before
    max_epochs, without that epoch's scheduler step."""
    epochs = []
    run = _pair(CFG, TRAIN[:3], VAL, 8, early_stopping_patience=2)
    for t in (run["trainer"], run["jax"]):
        epochs.append(t.current_epoch)
    assert epochs[0] == epochs[1] < 7, epochs
    trainer = run["trainer"]
    assert trainer.early_stopping.stopped
    assert trainer.scheduler.epoch == trainer.current_epoch
    assert len(trainer.step_losses) == 3 * (trainer.current_epoch + 1)
    np.testing.assert_allclose(trainer.step_losses, run["jax_losses"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("flags,steps", [({"limit_train_batches": 0.5}, 2),
                                         ({"limit_train_batches": 3}, 3),
                                         ({"limit_val_batches": 1.0}, 5),
                                         ({"overfit_batches": 2}, 2)],
                         ids=["fraction", "count", "whole", "overfit"])
def test_batch_limits_match_jax(flags, steps):
    from waveformml_tpu.engineering.trainer import Trainer as JaxTrainer

    run = _pair(CFG, TRAIN, VAL, 2, **flags)
    trainer = run["trainer"]
    assert len(trainer.step_losses) == 2 * steps
    np.testing.assert_allclose(trainer.step_losses, run["jax_losses"], rtol=RTOL, atol=ATOL)
    assert run["metrics"]["val_loss"] == pytest.approx(run["jax_metrics"]["val_loss"],
                                                       rel=RTOL, abs=ATOL)
    for limit in (None, 0.5, 0.1, 1.0, 1, 3, 9):
        assert Trainer._limit(TRAIN, limit) == JaxTrainer._limit(None, TRAIN, limit), limit


@pytest.mark.parametrize("terminate", [True, False])
def test_terminate_on_nan_matches_jax(terminate):
    run = _pair(CFG, NAN_TRAIN, VAL, 3, terminate_on_nan=terminate)
    trainer = run["trainer"]
    assert not np.isfinite(trainer.step_losses).any()
    assert trainer.current_epoch == run["jax"].current_epoch == (1 if terminate else 3)


def test_lr_find_matches_jax_and_restores_the_state():
    jt = _jax_trainer(CFG)
    jt._ensure_state(TRAIN[0])
    init = _state_dict(jt)
    kw = dict(min_lr=1e-4, max_lr=30.0, num_steps=20)
    want = jt.lr_find(BlockDataModule(TRAIN), **kw)

    trainer = _port_trainer(CFG, init, 2)
    trainer.fit(BlockDataModule(TRAIN[:1], VAL))          # optimizer state to restore
    before = (copy.deepcopy(trainer.task.model.state_dict()),
              copy.deepcopy(trainer.optimizer.state_dict()))
    got = trainer.lr_find(BlockDataModule(TRAIN), **kw)
    assert np.isclose(np.logspace(-4, np.log10(30.0), 20), got, rtol=1e-12).any()
    fresh = _port_trainer(CFG, init, 2)
    assert fresh.lr_find(BlockDataModule(TRAIN), **kw) == pytest.approx(want, rel=1e-9)
    state, opt = trainer.task.model.state_dict(), trainer.optimizer.state_dict()
    for k, v in before[0].items():
        assert torch.equal(state[k], v), k
    assert opt["param_groups"] == before[1]["param_groups"]
    for i, s in before[1]["state"].items():
        for k, v in s.items():
            assert torch.equal(opt["state"][i][k], v), (i, k)


def test_resume_equals_an_uninterrupted_fit(tmp_path):
    """2 epochs, saved, then a new Trainer resumed for a third, against 3
    epochs in one fit, with accumulation over 5 blocks (a micro-step carried
    across the save) and ExponentialLR: the same losses and weights within
    1e-6, and the epoch, best validation loss, step and scheduler restored."""
    init = LitPSD(Config(_config()), device="cpu").model.state_dict()
    kw = dict(accumulate_grad_batches=2, gradient_clip_val=CLIP)
    whole = _port_trainer(CFG, init, 3, **kw)
    whole.fit(BlockDataModule(TRAIN, VAL))

    first = _port_trainer(CFG, init, 2, checkpoint_dir=str(tmp_path / "best"), **kw)
    first.fit(BlockDataModule(TRAIN, VAL))
    assert first.multi_steps.mini_step == 0 and first.global_step == 10
    path = str(tmp_path / "last.ckpt")
    first.save_checkpoint(path)

    resumed = _port_trainer(CFG, init, 3, **kw)
    resumed.task.model.load_state_dict(LitPSD(Config(_config()), device="cpu")
                                       .model.state_dict())   # overwritten by the load
    resumed.load_checkpoint(path, restore_training=True)
    assert resumed.current_epoch == 2 and resumed.global_step == 10
    assert resumed.best_val_loss == first.best_val_loss < np.inf
    assert resumed.scheduler.state_dict() == first.scheduler.state_dict()
    assert resumed.optimizer.param_groups[0]["lr"] == pytest.approx(0.01 * 0.9 ** 2)
    resumed.fit(BlockDataModule(TRAIN, VAL))
    np.testing.assert_allclose(first.step_losses + resumed.step_losses, whole.step_losses,
                               rtol=1e-6, atol=1e-6)
    for k, v in resumed.task.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), whole.task.model.state_dict()[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    # weights only: the training state stays as it was
    weights_only = _port_trainer(CFG, init, 3)
    weights_only.load_checkpoint(path)
    assert weights_only.current_epoch == 0 and weights_only.best_val_loss == np.inf


def test_callbacks_and_throughput():
    calls = []

    class Recorder:
        def on_validation_end(self, trainer, metrics, epoch):
            calls.append(("val", epoch, trainer.multi_steps.mini_step))

        def on_train_end(self, trainer):
            calls.append(("train_end",))

        def on_test_end(self, trainer, metrics):
            calls.append(("test_end", sorted(metrics)))

    init = LitPSD(Config(_config()), device="cpu").model.state_dict()
    trainer = _port_trainer(CFG, init, 2, callbacks=[Recorder()], accumulate_grad_batches=2,
                            limit_test_batches=1)
    trainer.fit(BlockDataModule(TRAIN, VAL))
    outputs = []
    metrics = trainer.test(BlockDataModule([], [], VAL),
                           collect=lambda block, db, out: outputs.append(out))
    assert len(outputs) == 1
    assert sorted(metrics) == ["test_accuracy", "test_loss"]
    # after the first epoch's 5 micro-steps one is carried
    assert calls == [("val", 0, 1), ("val", 1, 0), ("train_end",),
                     ("test_end", ["test_accuracy", "test_loss"])]
    rows = 2 * sum(b.coords.shape[0] for b in TRAIN)
    assert trainer.waveforms_per_second > 0
    assert sum(trainer._epoch_rows) == rows
