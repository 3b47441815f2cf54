"""The waveform nets of the port against the JAX package, at narrow widths:
``TemporalWaveformNet`` (SingleWaveformTCN.json), ``RecurrentWaveformNet``
(SingleWaveformRNN.json), ``ConvWaveformNet`` with and without the
detector-number side channel and ``LinearWaveformNet`` (both plane forms)
under ``LitWaveform``; the blocks under them (``Conv1DNet``,
``DilationBlock``, ``PointwiseReducer``, ``LinearPlanes``, ``RecurrentNet``
and the recurrent DSL layers ``nn.RNN``, ``nn.GRU``, ``nn.LSTM``) and their
schedules against the JAX static methods. From the same flax weights
(``convert.py``, whose round trip is held too): the eval and train-mode
forwards, ``LitWaveform.prepare_block`` and ``loss_and_metrics``,
``InferenceModel`` on per-waveform 1-D coords, a 10-step training
trajectory against the JAX ``Trainer`` (rtol 2e-3, atol 2e-4), the
evaluators ``TensorEvaluator`` and ``WaveformEvaluator``, and the CLI.
Forwards are held to rtol 1e-5, atol 1e-6."""
import copy
import os

import numpy as np
import pytest
import torch

from _torch_eval_common import FakeLogger, caldb  # noqa: F401
from test_torch_sparse_nets import _flat, _train_forward, _unflatten

from waveformml_tpu_torch.config import Config, load_config, to_dict
from waveformml_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.datasets.synthetic import BlockDataModule, waveform_block
from waveformml_tpu_torch.engineering.tasks import LitWaveform
from waveformml_tpu_torch.engineering.trainer import Trainer
from waveformml_tpu_torch.inference.model import InferenceModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SAMPLES = 12
RTOL, ATOL = 1e-5, 1e-6
TRAIN_RTOL, TRAIN_ATOL = 2e-3, 2e-4
EPOCHS, STEPS = 2, 5

CNN_PARAMS = {"num_channels": 1, "out_size": 3, "num_expand": 1, "num_contract": 2,
              "expand_factor": 4, "size_factor": 3, "pad_factor": 1, "stride_factor": 1}


def _config(name, **net):
    """A shipped waveform config at N_SAMPLES samples."""
    d = to_dict(load_config(os.path.join(ROOT, "config", "examples", f"{name}.json")))
    d["system_config"]["n_samples"] = N_SAMPLES
    d["net_config"].update(net)
    return d


def _net_config(key):
    if key == "TCN":
        return _config("SingleWaveformTCN")
    if key == "RNN":
        d = _config("SingleWaveformRNN")
        d["net_config"]["hparams"]["n_hidden"] = 6
        return d
    if key.startswith("Conv"):
        extra = ({"use_detector_number": True, "num_detectors": 308}
                 if key == "Conv_det" else {})
        return _config("SingleWaveformTCN", net_class="WaveformModels.ConvWaveformNet",
                       net_type="CNN", hparams={"cnn_params": CNN_PARAMS, "n_lin": 2,
                                                "out_size": 1}, **extra)
    if key == "Linear_planes":
        return _config("SingleWaveformTCN", net_class="WaveformModels.LinearWaveformNet",
                       net_type="MLP", hparams={"n_expand": 1, "expansion_factor": 2.0,
                                                "n_contract": 2, "out_size": 1})
    return _config("SingleWaveformTCN", net_class="WaveformModels.LinearWaveformNet",
                   net_type="MLP", hparams={"n_lin": 3, "out_size": 1})


NETS = ("TCN", "RNN", "Conv", "Conv_det", "Linear_planes", "Linear_block")


def _jax_variables(jt):
    v = {"params": jt.state.params}
    if jt.state.batch_stats:
        v["batch_stats"] = jt.state.batch_stats
    return v


def _jax_trainer(d, block, seed=0):
    """A JAX Trainer over LitWaveform on one device, its state built from
    ``block``."""
    import jax

    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock
    from waveformml_tpu.engineering import tasks as jtasks
    from waveformml_tpu.engineering.trainer import Trainer as JaxTrainer
    from waveformml_tpu.parallel.mesh import make_mesh

    jcfg = JaxConfig(copy.deepcopy(d))
    jt = JaxTrainer(jcfg, jtasks.LitWaveform(jcfg), mesh=make_mesh(jax.devices()[:1]),
                    seed=seed, callbacks=[])
    jt._ensure_state(JaxFileBlock(block.coords, block.feats, block.labels, {}))
    return jt


def _state_flat(jt):
    return {k: v for k, v in _flat(_jax_variables(jt)).items() if "/" in k}


def _redraw(jt, seed):
    """Every variable redrawn (the TCN's N(0, 0.01) kernels would leave the
    outputs ~1e-15; init leaves biases zero, and a zero bias before the
    final ReLU of ``LinearPlanes`` leaves half the outputs zero: the
    biases are drawn positive); returns the flat variables."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in _state_flat(jt).items():
        if k.endswith("/var"):
            value = rng.uniform(0.5, 2.0, size=v.shape)
        elif k.endswith("/kernel"):
            value = rng.normal(size=v.shape) / np.sqrt(max(1, np.prod(v.shape[:-1])))
        elif k.endswith("/bias"):
            value = np.abs(rng.normal(size=v.shape)) * 0.3
        else:
            value = rng.normal(size=v.shape) * 0.1 + k.endswith("/scale")
        flat[k] = value.astype(np.float32)
    tree = _unflatten(flat)
    jt.state.params, jt.state.batch_stats = tree["params"], tree.get("batch_stats", {})
    return flat


def _jax_db(jt, block):
    import jax.numpy as jnp

    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock

    jb = JaxFileBlock(block.coords, block.feats, block.labels, {})
    db = jt.task.prepare_block(jb, jt.task.row_bucket(jb), jt.task.event_bucket(jb))
    return {k: jnp.asarray(v) for k, v in db.items()}


def _block(rng, n=40):
    return waveform_block(rng, n, N_SAMPLES)


@pytest.fixture(scope="module", params=NETS)
def served(request, tmp_path_factory):
    """One net's JAX Trainer with redrawn weights saved as an orbax
    checkpoint, the same weights as a port state_dict, and a block."""
    d = _net_config(request.param)
    block = _block(np.random.default_rng(51), 230)
    jt = _jax_trainer(d, block)
    flat = _redraw(jt, 52)
    path = str(tmp_path_factory.mktemp(request.param) / "epoch=0-val_loss=0.50.ckpt")
    jt.save_checkpoint(path)
    task = LitWaveform(Config(copy.deepcopy(d)), device="cpu")
    task.model.load_state_dict(flax_to_state_dict(flat))
    return dict(key=request.param, d=d, jt=jt, flat=flat, path=path, block=block, task=task)


def _prepared(served):
    task, block = served["task"], served["block"]
    db = task.prepare_block(block, task.row_bucket(block), task.event_bucket(block))
    jdb = _jax_db(served["jt"], block)
    assert sorted(db) == sorted(jdb) == ["det", "feats", "label_mask", "labels", "mask"]
    for k in db:
        np.testing.assert_array_equal(db[k], np.asarray(jdb[k]), err_msg=k)
    return task.to_device(db), jdb


def test_forward_matches_jax(served):
    jt, task = served["jt"], served["task"]
    db, jdb = _prepared(served)
    want = np.asarray(jt.task.apply_model(_jax_variables(jt), jdb, train=False)[0])
    got = task.apply_model(db).numpy()
    assert got.shape == want.shape == (db["feats"].shape[0], 1)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert task.model.plan_requirements() == set()
    if served["key"] == "Conv_det":
        # the detector coordinates ride along: 12 samples + 3
        assert task.config.system_config.n_samples == N_SAMPLES + 3
        assert db["feats"].shape[1] == N_SAMPLES + 3


def test_train_mode_forward_and_statistics_match_jax(served):
    """Train mode: Conv1DNet's BatchNorm takes its statistics over every
    row of the bucket (the JAX net gives it no mask), padding included: the
    port's within float32 rounding of its float64 run, and within 1e-4 of
    the JAX package's where that is as close to float64 (the padding rows,
    each the conv's bias alone, cancel digits of the variance's sums)."""
    jt, task = served["jt"], served["task"]
    db, jdb = _prepared(served)
    want, stats = jt.task.apply_model(_jax_variables(jt), jdb, train=True)
    want = np.asarray(want, np.float64)
    got, state = _train_forward(task, db, torch.float32)
    ref, ref_state = _train_forward(task, db, torch.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert np.all(np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-5 + np.abs(want - ref))
    want_stats = flax_to_state_dict({k: v for k, v in _flat({"batch_stats": stats}).items()
                                     if "/" in k})
    assert bool(want_stats) == served["key"].startswith("Conv")
    for k, v in want_stats.items():
        v = v.double().numpy()
        np.testing.assert_allclose(state[k].numpy(), ref_state[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
        slack = np.abs(v - ref_state[k].numpy())
        assert np.all(np.abs(state[k].numpy() - v) <= 1e-4 * np.abs(v) + 1e-6 + slack), k


def test_loss_and_metrics_match_jax(served):
    """LitWaveform's loss sum and weight (rows × outputs), and the test
    outputs (predictions, per-row losses), against the JAX task; the
    padding rows are out of both."""
    jt, task = served["jt"], served["task"]
    db, jdb = _prepared(served)
    out = task.apply_model(db)
    jout = jt.task.apply_model(_jax_variables(jt), jdb, train=False)[0]
    ls, w, metrics = task.loss_and_metrics(out, db)
    jls, jw, jmetrics = jt.task.loss_and_metrics(jout, jdb)
    assert sorted(metrics) == sorted(jmetrics) == []
    np.testing.assert_allclose(float(ls), float(jls), rtol=1e-5)
    assert float(w) == float(jw) == served["block"].coords.shape[0]
    got, want = task.test_outputs(out, db), jt.task.test_outputs(jout, jdb)
    assert sorted(got) == sorted(want) == ["loss_no_reduce", "predictions"]
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_inference_model_on_waveform_coords_matches_jax(served):
    """A chunk of per-waveform detector ids ``[N]``: N events, one output
    a row, against the JAX InferenceModel from the same checkpoint."""
    from waveformml_tpu.inference.model import InferenceModel as JaxInferenceModel

    block = served["block"]
    port = InferenceModel(Config(copy.deepcopy(served["d"])),
                          flax_to_state_dict(served["flat"]), device="cpu")
    jax_model = JaxInferenceModel(served["jt"].config, served["path"])
    got = port(block.coords, block.feats)
    want = np.asarray(jax_model(block.coords, block.feats))
    n = block.coords.shape[0]
    assert block.coords.ndim == 1 and got.shape == want.shape == (n, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_weights_round_trip_through_convert(served):
    state = flax_to_state_dict(served["flat"])
    own = served["task"].model.state_dict()
    assert sorted(state) == sorted(own)
    for k, v in own.items():
        assert state[k].shape == v.shape, k
    back = state_dict_to_flax(state)
    assert sorted(back) == sorted(served["flat"])
    for k, v in served["flat"].items():
        np.testing.assert_allclose(back[k], v, rtol=1e-7, atol=1e-7, err_msg=k)


def test_nets_build_from_the_shipped_configs():
    """SingleWaveformTCN.json: planes [2, 4, 2, 1] and a LinearBlock from
    59 features; SingleWaveformRNN.json: 2 ReLU RNN layers of 32 over 59
    samples, a LinearBlock from 32·59."""
    from waveformml_tpu_torch.models.waveform_models import (RecurrentWaveformNet,
                                                             TemporalWaveformNet)

    path = os.path.join(ROOT, "config", "examples")
    tcn = LitWaveform(load_config(os.path.join(path, "SingleWaveformTCN.json")), "cpu").model
    assert type(tcn) is TemporalWaveformNet and tcn.planes == [2, 4, 2, 1]
    assert tcn.linear.dense_0.in_features == 59
    rnn = LitWaveform(load_config(os.path.join(path, "SingleWaveformRNN.json")), "cpu").model
    assert type(rnn) is RecurrentWaveformNet
    cells = [rnn.model.rnn_block.cell_0, rnn.model.rnn_block.cell_1]
    assert [(c.input_size, c.hidden_size, c.nonlinearity) for c in cells] == [
        (1, 32, "relu"), (32, 32, "relu")]
    assert rnn.model.linear.dense_0.in_features == 32 * 59


@pytest.mark.parametrize("criterion,phys", [("L1Loss", False), ("MSELoss", True),
                                             ("CrossEntropyLoss", False)])
def test_make_evaluator_matches_jax(criterion, phys):
    """LitWaveform's evaluator: ``TensorEvaluator``, its metric named after
    the criterion, phys targets where the test set's labels are the whole
    phys record, as the JAX task builds it."""
    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.engineering.tasks import LitWaveform as JaxTask

    d = _net_config("TCN")
    d["net_config"]["criterion_class"] = criterion
    if phys:
        d["dataset_config"]["test_dataset_params"] = {"label_name": "phys"}
    want = JaxTask(JaxConfig(copy.deepcopy(d))).make_evaluator()
    got = LitWaveform(Config(copy.deepcopy(d)), "cpu").make_evaluator()
    assert type(got).__name__ == type(want).__name__ == "TensorEvaluator"
    for attr in ("metric_name", "target_has_phys", "target_index", "E_scale", "hascal"):
        assert getattr(got, attr) == getattr(want, attr), attr


def test_detector_coordinates_are_appended_once():
    """Two tasks of one config: n_samples grows by 3 once."""
    cfg = Config(_net_config("Conv_det"))
    LitWaveform(cfg, "cpu")
    task = LitWaveform(cfg, "cpu")
    assert cfg.system_config.n_samples == N_SAMPLES + 3
    block = _block(np.random.default_rng(3), 20)
    db = task.prepare_block(block, 256, 256)
    det = block.coords
    seg = det // 2
    np.testing.assert_allclose(db["feats"][:det.shape[0], -3:], np.stack(
        [(seg % 14) / 13.0, (seg // 14) / 10.0, det % 2], 1), rtol=1e-6)


# -- training ----------------------------------------------------------------------

@pytest.fixture(scope="module", params=("TCN", "RNN"))
def trajectories(request, tmp_path_factory):
    """The JAX Trainer stepped through its train step and ExponentialLR as
    its fit does, and the port's Trainer.fit from the converted init, over
    EPOCHS × STEPS blocks."""
    import jax
    import jax.numpy as jnp

    from waveformml_tpu import optim as wopt
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock

    d = _net_config(request.param)
    rng = np.random.default_rng(61)
    train = [_block(rng) for _ in range(STEPS)]
    val = [_block(rng)]
    jt = _jax_trainer(d, train[0])
    flat = _redraw(jt, 62)
    jax_losses = []
    for epoch in range(EPOCHS):
        for i, b in enumerate(train):
            db = {k: jnp.asarray(v) for k, v in jt._device_batch(
                JaxFileBlock(b.coords, b.feats, b.labels, {})).items()}
            st = jt.state
            st.params, st.batch_stats, st.opt_state, loss, _ = jt._train_step_fn(
                st.params, st.batch_stats, st.opt_state,
                jax.random.PRNGKey(epoch * STEPS + i), db)
            jax_losses.append(float(loss))
        jt.state.opt_state = wopt.set_learning_rate(jt.state.opt_state, jt.scheduler.step())
    cfg = Config(copy.deepcopy(d))
    task = LitWaveform(cfg, device="cpu")
    task.model.load_state_dict(flax_to_state_dict(flat))
    trainer = Trainer(cfg, task, device="cpu", max_epochs=EPOCHS,
                      checkpoint_dir=str(tmp_path_factory.mktemp("ckpt")))
    metrics = trainer.fit(BlockDataModule(train, val, val))
    return dict(trainer=trainer, metrics=metrics, jax_losses=jax_losses,
                jax_flat=_state_flat(jt), val=val, d=d)


def test_training_losses_match_jax(trajectories):
    got = np.asarray(trajectories["trainer"].step_losses)
    want = np.asarray(trajectories["jax_losses"])
    assert got.shape == want.shape == (EPOCHS * STEPS,)
    assert np.all(np.isfinite(got)) and len(set(np.round(got, 6))) > 1
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)


def test_trained_weights_match_jax(trajectories):
    want = flax_to_state_dict(trajectories["jax_flat"])
    state = trajectories["trainer"].task.model.state_dict()
    assert sorted(want) == sorted(state)
    for k, v in want.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def test_best_checkpoint_serves_and_tests(trajectories):
    """The best checkpoint serves the validation waveforms through
    ``InferenceModel`` and tests with its recorded loss, the evaluator
    (``TensorEvaluator``) fed."""
    from waveformml_tpu_torch.evaluation.tensor_eval import TensorEvaluator

    trainer = trajectories["trainer"]
    assert set(trajectories["metrics"]) == {"train_loss", "val_loss"}
    val = trajectories["val"][0]
    cfg = Config(copy.deepcopy(trajectories["d"]))
    out = InferenceModel(cfg, trainer.best_ckpt_path, device="cpu")(val.coords, val.feats)
    assert out.shape == (val.coords.shape[0], 1) and np.isfinite(out).all()
    best = Trainer(cfg, LitWaveform(cfg, device="cpu"), device="cpu", callbacks=[])
    best.load_checkpoint(trainer.best_ckpt_path)
    test = best.test(BlockDataModule([], [], [val]))
    assert test["test_loss"] == pytest.approx(trainer.best_val_loss, rel=1e-5)
    from waveformml_tpu_torch.evaluation import accumulated_arrays

    ev = best.task.evaluator
    assert isinstance(ev, TensorEvaluator) and ev.metric_name == "mean absolute error"
    assert any(np.any(v) for v in accumulated_arrays(ev).values())


# -- the blocks and their schedules ------------------------------------------------

@pytest.mark.parametrize("args", [
    (8, 4, 3, dict()), (6, 6, 2, dict(size_factor=5, pad_factor=0.5)),
    (3, 9, 4, dict(stride_factor=2, dil_factor=1.5)), (10, 2, 1, dict(pad_factor=1))])
def test_dilation_block_schedule_matches_jax(args):
    from waveformml_tpu.models.blocks import DilationBlock as JaxBlock
    from waveformml_tpu_torch.models.blocks import DilationBlock

    nin, nout, n, kw = args
    assert DilationBlock.schedule(nin, nout, n, **kw) == JaxBlock.schedule(nin, nout, n, **kw)
    assert (DilationBlock(nin, nout, n, 40, **kw).out_length()
            == JaxBlock(nin, nout, n, 40, **kw).out_length())


@pytest.mark.parametrize("kw", [
    dict(num_channels=1, out_size=3, num_expand=1, num_contract=2, expand_factor=4),
    dict(num_channels=2, out_size=1, num_expand=0, num_contract=3, expand_factor=1,
         size_factor=5, pad_factor=0.5, stride_factor=2),
    dict(num_channels=4, out_size=8, num_expand=2, num_contract=1, expand_factor=3,
         min_kernel=3, stride_factor=1),
    dict(num_channels=1, out_size=2, num_expand=0, num_contract=1, expand_factor=2,
         stride_factor=2)])
def test_conv1d_net_schedule_matches_jax(kw):
    from waveformml_tpu.models.blocks import Conv1DNet as JaxNet
    from waveformml_tpu_torch.models.blocks import Conv1DNet

    assert Conv1DNet.schedule(59, **kw) == JaxNet.schedule(59, **kw)
    assert Conv1DNet(59, **kw).out_shape() == JaxNet(59, **kw).out_shape()


def _block_case(name):
    """(JAX module, port module, input [B, L, C] channels-last, train-mode
    BN?) of a block at narrow widths."""
    from waveformml_tpu.models import blocks as jb
    from waveformml_tpu_torch.models import blocks as pb

    if name == "Conv1DNet":
        kw = dict(num_channels=3, out_size=2, num_expand=1, num_contract=2, expand_factor=2)
        return jb.Conv1DNet(20, **kw), pb.Conv1DNet(20, **kw), (7, 20, 3), True
    if name == "DilationBlock":
        return (jb.DilationBlock(3, 5, 3, 20, pad_factor=0.5),
                pb.DilationBlock(3, 5, 3, 20, pad_factor=0.5), (7, 20, 3), True)
    if name == "PointwiseReducer":
        return (jb.PointwiseReducer([6, 4, 2]), pb.PointwiseReducer([6, 4, 2]), (7, 20, 6),
                False)
    import jax

    return (jb.LinearPlanes([9, 7, 4], activation=jax.nn.relu),
            pb.LinearPlanes([9, 7, 4], torch.relu), (7, 9), False)


@pytest.mark.parametrize("name", ["Conv1DNet", "DilationBlock", "PointwiseReducer",
                                  "LinearPlanes"])
def test_blocks_match_jax(name):
    """Eval forward (and for the conv stacks the train-mode forward and its
    running statistics, over every row) from the same flax variables,
    channels-first in the port, and the weights' round trip."""
    import jax
    import jax.numpy as jnp

    jmod, mod, shape, has_bn = _block_case(name)
    rng = np.random.default_rng(71)
    x = rng.normal(size=shape).astype(np.float32)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    flat = {k: (v if k.endswith("/kernel") else rng.uniform(0.5, 1.5, size=v.shape)
                if k.endswith("/var") else rng.normal(size=v.shape) * 0.2 + k.endswith("/scale")
                ).astype(np.float32) for k, v in _flat(variables).items()}
    state = flax_to_state_dict(flat)
    assert sorted(state) == sorted(mod.state_dict())
    mod.load_state_dict(state)
    xt = torch.from_numpy(x)
    to_port = (lambda a: a.transpose(1, 2)) if x.ndim == 3 else (lambda a: a)
    for train in ((False, True) if has_bn else (False,)):
        if train:
            want, stats = jmod.apply(_unflatten(flat), jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
        else:
            want = jmod.apply(_unflatten(flat), jnp.asarray(x))
        mod.train(train)
        with torch.no_grad():
            got = to_port(mod(to_port(xt))).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
        if train:
            for k, v in flax_to_state_dict(_flat(stats)).items():
                np.testing.assert_allclose(mod.state_dict()[k].numpy(), v.numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=k)
    back = state_dict_to_flax(state)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def _recurrent_case(kind):
    """(JAX module, port module) of a recurrent layer or net over [B, L, C]."""
    from waveformml_tpu.models import recurrent_blocks as jr
    from waveformml_tpu.nn import layers as jl
    from waveformml_tpu_torch.models import recurrent_blocks as pr
    from waveformml_tpu_torch.nn import layers as pl

    if kind == "nn.RNN":
        return jl.RNNLayer(3, 5, 2), pl.RNNLayer(3, 5, 2)
    if kind == "nn.RNN relu":
        return (jl.RNNLayer(3, 5, 1, nonlinearity="relu"),
                pl.RNNLayer(3, 5, 1, nonlinearity="relu"))
    if kind == "nn.GRU":
        return jl.GRULayer(3, 5, 2), pl.GRULayer(3, 5, 2)
    if kind == "nn.LSTM":
        return jl.LSTMLayer(3, 5, 2), pl.LSTMLayer(3, 5, 2)
    if kind == "RecurrentNet":
        return jr.RecurrentNet(9, 3, 5, 2, 2, 4), pr.RecurrentNet(9, 3, 5, 2, 2, 4)
    return jr.RecurrentNet(9, 3, 5, 2, 0, 1), pr.RecurrentNet(9, 3, 5, 2, 0, 1)


@pytest.mark.parametrize("kind", ["nn.RNN", "nn.RNN relu", "nn.GRU", "nn.LSTM",
                                  "RecurrentNet", "RecurrentNet last step"])
def test_recurrent_layers_match_jax(kind):
    """flax's cells (``SimpleCell``, ``GRUCell``, ``LSTMCell``) through
    ``convert.py`` onto torch's RNN, GRU and LSTM: the forward, the
    gradients of the input and of every weight (through the port's IEEE
    recurrence), and the weights' round trip."""
    import jax
    import jax.numpy as jnp

    jmod, mod = _recurrent_case(kind)
    rng = np.random.default_rng(81)
    x = rng.normal(size=(4, 9, 3)).astype(np.float32)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x))
    flat = {k: (rng.normal(size=v.shape) * 0.4).astype(np.float32)
            for k, v in _flat(variables).items()}
    state = flax_to_state_dict(flat)
    assert sorted(state) == sorted(mod.state_dict())
    mod.load_state_dict(state)
    mod.eval()
    tree = _unflatten(flat)
    want = np.asarray(jmod.apply(tree, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = mod(xt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    # gradients of sum(out²): the input's and the weights', in flax's layout
    gx, gv = jax.grad(lambda xx, vv: jnp.sum(jmod.apply(vv, xx) ** 2), argnums=(0, 1))(
        jnp.asarray(x), tree)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)
    grads = {k: p.grad.numpy() for k, p in mod.named_parameters()}
    want_grads = _flat(gv)
    for k, v in flax_to_state_dict(want_grads).items():
        if "bias_" not in k:
            np.testing.assert_allclose(grads[k], v.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
    # flax's one bias a gate: torch's input bias gets its gradient, the
    # recurrent bias only where flax has one there (a GRU's n gate)
    gates = {1: (("i",), ()), 3: (("ir", "iz", "in"), (None, None, "hn")),
             4: (("hi", "hf", "hg", "ho"), ())}
    for name, p in mod.named_parameters():
        if "bias_" in name:
            cell = name.rsplit(".", 1)[0]
            w_hh = state[f"{cell}.weight_hh_l0"]
            hidden = w_hh.shape[1]
            which = gates[w_hh.shape[0] // hidden][0 if "_ih_" in name else 1]
            which = which or (None,) * (w_hh.shape[0] // hidden)
            path = f"params/{cell.replace('.', '/')}"
            want = np.concatenate([want_grads[f"{path}/{g}/bias"] if g else np.zeros(hidden)
                                   for g in which])
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
    back = state_dict_to_flax(state)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_allclose(back[k], v, rtol=1e-6, atol=1e-7, err_msg=k)


# -- the evaluators -----------------------------------------------------------------

def _waveform_eval_batch(seed, phys):
    """A padded LitWaveform batch (host arrays) and its per-row test
    outputs over the real rows."""
    rng = np.random.default_rng(seed)
    n, rows = 45, 64
    det = rng.integers(0, 308, n).astype(np.int32)
    if phys:
        labels = np.stack([rng.uniform(0, 1, n) for _ in range(7)], 1).astype(np.float32)
    else:
        labels = rng.uniform(0, 1, n).astype(np.float32)
    pad = lambda a: np.concatenate([a, np.zeros((rows - n,) + a.shape[1:], a.dtype)])  # noqa
    db = {"det": pad(det), "feats": pad(rng.normal(size=(n, N_SAMPLES)).astype(np.float32)),
          "mask": pad(np.ones(n, bool)), "labels": pad(labels),
          "label_mask": pad(np.ones(n, bool))}
    out = {"predictions": rng.uniform(0, 1, n), "loss_no_reduce": rng.uniform(0, 0.5, n)}
    return db, out


@pytest.mark.parametrize("phys", [False, True])
def test_tensor_evaluator_matches_jax(phys):
    """The arrays TensorEvaluator accumulates over two batches (the JAX one
    with a leading device axis of 1), and the tags ``dump()`` logs."""
    pytest.importorskip("matplotlib")
    from waveformml_tpu.evaluation.tensor_eval import TensorEvaluator as JaxEvaluator
    from waveformml_tpu_torch.evaluation import accumulated_arrays
    from waveformml_tpu_torch.evaluation.tensor_eval import TensorEvaluator

    kw = dict(target_has_phys=phys, target_index=4 if phys else None,
              metric_name="mean absolute error")
    jev, ev = JaxEvaluator(**kw), TensorEvaluator(**kw)
    for seed in (1, 2):
        db, out = _waveform_eval_batch(seed, phys)
        jev.add_batch(None, {k: v[None] for k, v in db.items()},
                      {k: np.concatenate([v, np.zeros(64 - v.shape[0])])[None]
                       for k, v in out.items()})
        ev.add_batch(None, db, out)
    want, got = accumulated_arrays(jev), accumulated_arrays(ev)
    assert sorted(got) == sorted(want) and any(np.any(v) for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)
    jlog, plog = FakeLogger(), FakeLogger()
    jev.logger, ev.logger = jlog, plog
    jev.dump()
    ev.dump()
    assert jlog.figures and plog.figures == jlog.figures
    assert sorted(plog.scalars) == sorted(jlog.scalars)


@pytest.mark.parametrize("pid", [False, True])
def test_waveform_evaluator_matches_jax(pid, caldb):  # noqa: F811
    """WaveformEvaluator's aligned waveforms and first-sample shares by z
    (``add``), the first-sample z metrics by z bin and PID class
    (``analyze_wf_z``), ``fft_pulses`` and the classical reconstruction
    (``z_E_from_cal``) against the JAX evaluator's, and ``dump()``'s tags
    (without the PID split)."""
    pytest.importorskip("matplotlib")
    from waveformml_tpu.evaluation.waveform_eval import WaveformEvaluator as JaxEvaluator
    from waveformml_tpu_torch.datasets.synthetic import make_events
    from waveformml_tpu_torch.evaluation import accumulated_arrays
    from waveformml_tpu_torch.evaluation.pid_eval import PID_MAP
    from waveformml_tpu_torch.evaluation.waveform_eval import WaveformEvaluator

    kw = dict(calgroup=caldb, wf_analysis=True,
              additional_field_names=["PID"] if pid else None)
    jev, ev = JaxEvaluator(**kw), WaveformEvaluator(**kw)
    for seed in (3, 4):
        rng = np.random.default_rng(seed)
        events = make_events(rng, 20, 40)
        wfs = events["waveforms"] / 16383.0
        z = events["z"]
        z_pred = z + rng.normal(0, 50, z.shape)
        fields = [rng.choice(list(PID_MAP), z.shape[0])] if pid else None
        for e in (jev, ev):
            e.add(wfs, z)
            e.analyze_wf_z(wfs, events["coords"], z, z_pred, fields)
        np.testing.assert_allclose(ev.fft_pulses(wfs), jev.fft_pulses(wfs), rtol=1e-12)
        for a, b in zip(ev.z_E_from_cal(events["coords"], wfs),
                        jev.z_E_from_cal(events["coords"], wfs)):
            assert a is not None
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)
    want, got = accumulated_arrays(jev), accumulated_arrays(ev)
    assert sorted(got) == sorted(want) and any(np.any(v) for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)
    if pid:
        return  # dump() draws the same figures for each of the 6 PID classes
    jlog, plog = FakeLogger(), FakeLogger()
    jev.logger, ev.logger = jlog, plog
    jev.dump()
    ev.dump()
    assert jlog.figures and plog.figures == jlog.figures


# -- the CLI -------------------------------------------------------------------------

def test_cli_trains_and_tests_a_waveform_net(tmp_path, capsys, monkeypatch):
    """``python -m waveformml_tpu_torch.main`` on SingleWaveformTCN.json
    (``--device cpu``, 1 epoch and a test) over in-memory waveform blocks:
    it no longer raises for ``LitWaveform`` and prints the JAX CLI's keys."""
    import ast
    import json
    import logging

    from waveformml_tpu_torch import main as cli

    d = _net_config("TCN")
    d["system_config"]["model_base_path"] = str(tmp_path / "model")
    path = tmp_path / "SingleWaveformTCN.json"
    path.write_text(json.dumps(d))
    rng = np.random.default_rng(91)
    blocks = [_block(rng) for _ in range(4)]
    monkeypatch.setattr(cli, "choose_data_module",
                        lambda config: BlockDataModule(blocks[:2], blocks[2:3], blocks[3:]))
    logger = logging.getLogger("waveformml_tpu_torch")
    saved = (list(logger.handlers), logger.level)
    try:
        assert cli.main([str(path), "--device", "cpu", "--max_epochs", "1", "-t"]) == 0
    finally:
        logger.handlers, logger.level = saved
    out = capsys.readouterr().out
    fit = [ln for ln in out.splitlines() if ln.startswith("fit: ")]
    test = [ln for ln in out.splitlines() if ln.startswith("test: ")]
    assert len(fit) == len(test) == 1, out
    assert set(ast.literal_eval(fit[0][5:])) == {"train_loss", "val_loss"}
    assert set(ast.literal_eval(test[0][6:])) == {"test_loss"}


def test_waveform_blocks_are_per_waveform_rows():
    """``waveform_block``: two rows a pulse (its PMTs), detector channel
    ids within the 308 of the detector, labels in [0, 1]."""
    block = _block(np.random.default_rng(5), 100)
    assert isinstance(block, FileBlock) and block.coords.ndim == 1
    n = block.coords.shape[0]
    assert n % 2 == 0 and block.feats.shape == (n, N_SAMPLES) and block.labels.shape == (n,)
    assert block.coords.min() >= 0 and block.coords.max() < 308
    assert np.all(block.coords[1::2] == block.coords[0::2] + 1)
    assert np.all((block.labels >= 0) & (block.labels <= 1))


# -- on the card ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_relu_rnn_gradients_on_the_card_match_the_cpu(cuda):
    """SingleWaveformRNN.json's net from a zero-bias init over waveforms
    clipped at 0 (zero pre-activations abound): every gradient on the card
    equals the CPU's, in float64 to rounding and in float32 to 1e-4 of its
    norm (cuDNN's backward takes another derivative of ReLU at 0, which
    moved the bias gradients by several percent), and the served outputs
    (cuDNN's forward) equal the CPU's."""
    cfg = load_config(os.path.join(ROOT, "config", "examples", "SingleWaveformRNN.json"))
    block = waveform_block(np.random.default_rng(17), 4096, 59)
    torch.manual_seed(3)
    state = LitWaveform(cfg, "cpu").model.state_dict()
    grads = {}
    for device, dtype in (("cpu", torch.float64), ("cuda", torch.float64),
                          ("cuda", torch.float32)):
        task = LitWaveform(cfg, device)
        task.model.load_state_dict(state)
        task.model.to(dtype).train()
        db = {k: v.to(dtype) if v.is_floating_point() else v for k, v in task.to_device(
            task.prepare_block(block, task.row_bucket(block), task.event_bucket(block))).items()}
        loss_sum, weight, _ = task.loss_and_metrics(task.forward_model(db), db)
        (loss_sum / weight).backward()
        grads[(device, dtype)] = {k: p.grad.double().cpu()
                                  for k, p in task.model.named_parameters()}
    want = grads[("cpu", torch.float64)]
    for key, tol in ((("cuda", torch.float64), 1e-12), (("cuda", torch.float32), 1e-4)):
        for k, v in want.items():
            got = grads[key][k]
            assert float((got - v).norm()) <= tol * float(v.norm()) + 1e-30, (key, k)
    served = InferenceModel(cfg, state)(block.coords, block.feats)
    cpu = InferenceModel(cfg, state, device="cpu")(block.coords, block.feats)
    np.testing.assert_allclose(served, cpu, rtol=1e-4, atol=1e-5)
