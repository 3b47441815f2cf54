"""The sparse nets of the slice against the JAX package, at narrow widths:
GEP.json and IoniClassifierCNN.json (``SPConvNet`` from ``hparams``: the
weight-normed TCN, ``SparseConv2DBlock`` version 3 on the grid,
``LinearBlock``), DensePSD.json (``DenseConvNet``: ``Conv2DBlock`` with
BatchNorm over the real events), OPs3ns_SCNet.json (``SCNet``: a pure-SubM
DSL stack in row space), ``ExtractedFeatureConvNet`` and a DSL
``SPConvNet`` with a leading ``nn.Conv1d`` section. From the same flax
weights (``convert.py``): the eval forward, the train-mode forward with its
BatchNorm statistics, ``InferenceModel``, a 10-step training trajectory
against the JAX ``Trainer`` for GEP and OPs3ns_SCNet (rtol 2e-3, atol
2e-4), the weights' round trip, the TCN alone, the layer schedules against
the JAX static methods and ``NLLLoss`` with class weights. Card tests hold
K1 and K4 at OPs3ns_SCNet.json's shipped widths against their plain
versions."""
import copy
import os

import numpy as np
import pytest
import torch

from waveformml_tpu_torch.config import Config, load_config, to_dict
from waveformml_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.datasets.synthetic import BlockDataModule, labelled_block
from waveformml_tpu_torch.engineering.tasks import LitPSD
from waveformml_tpu_torch.engineering.trainer import Trainer
from waveformml_tpu_torch.inference.model import InferenceModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX, NY = 14, 11
N_SAMPLES = 8
N_FEATURES = 5
RTOL, ATOL = 1e-5, 1e-6
TRAIN_RTOL, TRAIN_ATOL = 2e-3, 2e-4
EPOCHS, STEPS = 2, 5

#: OPs3ns_SCNet.json's DSL at N_SAMPLES: SubM 16→6→4 (BatchNorm, ReLU after
#: the first, ReLU after the second), ToDense, Linear 4·154→8, ReLU, Linear 8→2
OPS_NARROW = ["spconv.SubMConv2d", [2 * N_SAMPLES, 6, 3, 1, 1, 1], "nn.BatchNorm1d", [6],
              "nn.ReLU", "spconv.SubMConv2d", [6, 4, 3, 1, 1, 1], "nn.ReLU",
              "spconv.ToDense", "nn.Linear", [4 * NX * NY, 8], "nn.ReLU", "nn.Linear", [8, 2]]
#: a DSL SPConvNet with a waveform section (masked BatchNorm over the rows),
#: SubM on the grid and a BatchNorm in the head
DSL_WAVEFORM = ["nn.Conv1d", [2, 4, 3, 1, 1, 1], "nn.BatchNorm1d", [4], "nn.ReLU",
                "spconv.SubMConv2d", [4 * N_SAMPLES, 8, 3, 1, 1, 1], "nn.BatchNorm1d", [8],
                "nn.ReLU", "spconv.ToDense", "nn.Linear", [8 * NX * NY, 16],
                "nn.BatchNorm1d", [16], "nn.ReLU", "nn.Linear", [16, 2]]


def _config(name, **net):
    """A shipped example config at N_SAMPLES samples a waveform."""
    d = to_dict(load_config(os.path.join(ROOT, "config", "examples", f"{name}.json")))
    d["system_config"]["n_samples"] = N_SAMPLES
    d["net_config"].update(net)
    return d


def _net_config(key):
    if key == "OPs3ns_SCNet":
        return _config(key, algorithm=copy.deepcopy(OPS_NARROW))
    if key == "ExtractedFeatureConvNet":
        d = _config("IoniClassifierCNN", net_class="ExtractedFeatureConvNet",
                    hparams={"n_conv": 2, "n_lin": 2, "out_planes": 4,
                             "conv": {"size_factor": 3, "pad_factor": 0.5,
                                      "expansion_factor": 2.0}})
        d["system_config"]["n_features"] = N_FEATURES
        return d
    if key == "SPConvNet_dsl":
        d = _config("IoniClassifierCNN", algorithm=copy.deepcopy(DSL_WAVEFORM))
        del d["net_config"]["hparams"]
        return d
    return _config(key)


NETS = ("GEP", "IoniClassifierCNN", "DensePSD", "OPs3ns_SCNet", "ExtractedFeatureConvNet",
        "SPConvNet_dsl")


def _block(rng, key, n_events=12):
    block = labelled_block(rng, n_events, N_SAMPLES)
    if key == "ExtractedFeatureConvNet":
        feats = rng.normal(size=(block.coords.shape[0], N_FEATURES)).astype(np.float32)
        block = FileBlock(block.coords, feats, block.labels)
    return block


def _jax_trainer(d, block, seed=0):
    """A JAX Trainer on one device with its state built from ``block``."""
    import jax

    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock
    from waveformml_tpu.engineering import tasks as jtasks
    from waveformml_tpu.engineering.trainer import Trainer as JaxTrainer
    from waveformml_tpu.parallel.mesh import make_mesh

    jcfg = JaxConfig(copy.deepcopy(d))
    jt = JaxTrainer(jcfg, jtasks.LitPSD(jcfg), mesh=make_mesh(jax.devices()[:1]), seed=seed,
                    callbacks=[])
    jt._ensure_state(JaxFileBlock(block.coords, block.feats, block.labels, {}))
    return jt


def _jax_db(jt, block):
    import jax.numpy as jnp

    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock

    jb = JaxFileBlock(block.coords, block.feats, block.labels, {})
    db = jt.task.prepare_block(jb, jt.task.row_bucket(jb), jt.task.event_bucket(jb))
    return {k: jnp.asarray(v) for k, v in db.items()}


def _flat(variables):
    import jax
    from flax.traverse_util import flatten_dict

    return {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(variables),
                                                        sep="/").items()}


def _state_flat(jt):
    return _flat({"params": jt.state.params, "batch_stats": jt.state.batch_stats})


def _unflatten(flat):
    """Flat variables back to flax's tree: below ``WeightNorm_<j>`` the
    rest of the path is one key, as flax names the scale."""
    import jax.numpy as jnp

    tree = {}
    for key, value in flat.items():
        parts = key.split("/")
        for i, part in enumerate(parts):
            if part.startswith("WeightNorm_"):
                parts = parts[:i + 1] + ["/".join(parts[i + 1:])]
                break
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(value)
    return tree


def _redraw(jt, seed):
    """Biases, scales (BatchNorm's and weight norm's) and statistics
    redrawn (init leaves them trivial); returns the flat variables."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in _state_flat(jt).items():
        if k.endswith("/kernel"):
            value = v
        elif k.endswith("/var"):
            value = rng.uniform(0.5, 2.0, size=v.shape)
        else:
            value = rng.normal(size=v.shape) * 0.1 + k.endswith("/scale")
        flat[k] = value.astype(np.float32)
    tree = _unflatten(flat)
    jt.state.params, jt.state.batch_stats = tree["params"], tree.get("batch_stats", {})
    return flat


@pytest.fixture(scope="module", params=NETS)
def served(request, tmp_path_factory):
    """One net's JAX Trainer with redrawn weights saved as an orbax
    checkpoint, the same weights as a port state_dict, and a block."""
    d = _net_config(request.param)
    rng = np.random.default_rng(31)
    block = _block(rng, request.param, n_events=20)
    jt = _jax_trainer(d, block)
    flat = _redraw(jt, 32)
    path = str(tmp_path_factory.mktemp(request.param) / "epoch=0-val_loss=0.50.ckpt")
    jt.save_checkpoint(path)
    task = LitPSD(Config(copy.deepcopy(d)), device="cpu")
    task.model.load_state_dict(flax_to_state_dict(flat))
    return dict(key=request.param, d=d, jt=jt, flat=flat, path=path, block=block, task=task)


def _prepared(served):
    task, block = served["task"], served["block"]
    db = task.prepare_block(block, task.row_bucket(block), task.event_bucket(block))
    jdb = _jax_db(served["jt"], block)
    assert sorted(db) == sorted(jdb)
    for k in db:
        np.testing.assert_array_equal(db[k], np.asarray(jdb[k]), err_msg=k)
    return task.to_device(db), jdb


def test_forward_matches_jax(served):
    jt = served["jt"]
    db, jdb = _prepared(served)
    want = np.asarray(jt.task.apply_model({"params": jt.state.params,
                                           "batch_stats": jt.state.batch_stats},
                                          jdb, train=False)[0])
    got = served["task"].apply_model(db).numpy()
    assert got.shape == want.shape == (db["labels"].shape[0], 2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    model = served["task"].model
    row = served["key"] == "OPs3ns_SCNet"
    assert model.plan_requirements() == ({"k3"} if row else set())
    if row:
        assert "plan_k3" in db


def _train_forward(task, db, dtype):
    """The task's train-mode forward and the running statistics it leaves,
    from a copy of its model in ``dtype``; the task keeps its own."""
    model = task.model
    task.model = copy.deepcopy(model).to(dtype)
    try:
        db = {k: v.to(dtype) if v.is_floating_point() else v for k, v in db.items()}
        with torch.no_grad():
            out = task.model_outputs(db, train=True).double().numpy()
        return out, {k: v.double() for k, v in task.model.state_dict().items()}
    finally:
        task.model = model


def test_train_mode_forward_and_statistics_match_jax(served):
    """Batch statistics over the real rows (the waveform section's and the
    grid's masked BatchNorm), the real events (Conv2DBlock's) or every
    event (a BatchNorm of the head), and the running statistics they
    move: the port's within float32 rounding of its float64 run, and
    within 1e-4 of the JAX package's where that is as close to float64
    (DensePSD's BatchNorm over 10^4 sites, most of which hold the conv's
    bias alone, cancels most digits of its sums: XLA's float32 sums on the
    CPU lie ~3e-4 from float64 there, the port's pairwise ones ~1e-6)."""
    jt, task = served["jt"], served["task"]
    db, jdb = _prepared(served)
    want, stats = jt.task.apply_model({"params": jt.state.params,
                                       "batch_stats": jt.state.batch_stats},
                                      jdb, train=True)
    want = np.asarray(want, np.float64)
    got, state = _train_forward(task, db, torch.float32)
    ref, ref_state = _train_forward(task, db, torch.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert np.all(np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-5 + np.abs(want - ref))
    want_stats = flax_to_state_dict(_flat({"batch_stats": stats}))
    assert want_stats
    for k, v in want_stats.items():
        v = v.double().numpy()
        np.testing.assert_allclose(state[k].numpy(), ref_state[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
        slack = np.abs(v - ref_state[k].numpy())
        assert np.all(np.abs(state[k].numpy() - v) <= 1e-4 * np.abs(v) + 1e-6 + slack), k


def test_inference_model_matches_jax(served):
    from waveformml_tpu.inference.model import InferenceModel as JaxInferenceModel

    port = InferenceModel(Config(copy.deepcopy(served["d"])),
                          flax_to_state_dict(served["flat"]), device="cpu")
    jax_model = JaxInferenceModel(served["jt"].config, served["path"])
    block = served["block"]
    got = port(block.coords, block.feats)
    want = np.asarray(jax_model(block.coords, block.feats))
    assert got.shape == want.shape == (20, 2)
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
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_nets_build_from_the_shipped_configs():
    """The four configs as shipped: their nets, widths and flatten sizes."""
    from waveformml_tpu_torch.models.nets import DenseConvNet, SCNet, SPConvNet
    from waveformml_tpu_torch.models.sparse_blocks import RowSubMConv2d

    want = {"GEP": (SPConvNet, 1040), "IoniClassifierCNN": (SPConvNet, 1040),
            "DensePSD": (DenseConvNet, 520), "OPs3ns_SCNet": (SCNet, 1232)}
    for name, (cls, flat) in want.items():
        cfg = load_config(os.path.join(ROOT, "config", "examples", f"{name}.json"))
        model = LitPSD(cfg, device="cpu").model
        assert type(model) is cls and model.n_linear == flat, name
    ops = LitPSD(load_config(os.path.join(ROOT, "config", "examples", "OPs3ns_SCNet.json")),
                 device="cpu").model
    assert ops.row_path
    assert [tuple(m.weight.shape) for m in ops.modules() if isinstance(m, RowSubMConv2d)] \
        == [(9, 130, 32), (9, 32, 8)]
    gep = LitPSD(load_config(os.path.join(ROOT, "config", "examples", "GEP.json")),
                 device="cpu").model
    assert gep.stack.specs == [("conv", 130, 69, 3, 1, 1, 1), ("bn", 69), ("relu",),
                               ("conv", 69, 8, 2, 1, 0, 1), ("bn", 8), ("relu",),
                               ("todense",)]


def test_seeded_init_is_reproducible():
    """A net built twice from one seed has the same weights, the DSL's
    layers included (they are built without a generator of their own)."""
    from waveformml_tpu_torch.registry import retrieve_class

    for key in ("OPs3ns_SCNet", "SPConvNet_dsl", "GEP"):
        cfg = Config(_net_config(key))
        cls = retrieve_class(cfg.net_config.net_class)
        a = cls(cfg, generator=torch.Generator().manual_seed(5)).state_dict()
        b = cls(cfg, generator=torch.Generator().manual_seed(5)).state_dict()
        c = cls(cfg, generator=torch.Generator().manual_seed(6)).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), key
        assert any(not torch.equal(a[k], c[k]) for k in a if k.endswith("weight")), key


# -- training trajectories ---------------------------------------------------------

@pytest.fixture(scope="module", params=("GEP", "OPs3ns_SCNet"))
def trajectories(request, tmp_path_factory):
    """The JAX Trainer stepped through its train step and ExponentialLR as
    its fit does, and the port's Trainer.fit from the converted init, over
    EPOCHS × STEPS blocks."""
    import jax
    import jax.numpy as jnp

    from waveformml_tpu import optim as wopt
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock

    d = _net_config(request.param)
    rng = np.random.default_rng(41)
    train = [_block(rng, request.param) for _ in range(STEPS)]
    val = [_block(rng, request.param)]
    jt = _jax_trainer(d, train[0])
    init = flax_to_state_dict(_state_flat(jt))
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
    task = LitPSD(cfg, device="cpu")
    task.model.load_state_dict(init)
    trainer = Trainer(cfg, task, device="cpu", max_epochs=EPOCHS,
                      checkpoint_dir=str(tmp_path_factory.mktemp("ckpt")))
    metrics = trainer.fit(BlockDataModule(train, val, val))
    return dict(key=request.param, trainer=trainer, metrics=metrics, jax_losses=jax_losses,
                jax_flat=_state_flat(jt), val=val, d=d)


def test_training_losses_match_jax(trajectories):
    got = np.asarray(trajectories["trainer"].step_losses)
    want = np.asarray(trajectories["jax_losses"])
    assert got.shape == want.shape == (EPOCHS * STEPS,)
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)


def test_trained_weights_and_statistics_match_jax(trajectories):
    want = flax_to_state_dict(trajectories["jax_flat"])
    state = trajectories["trainer"].task.model.state_dict()
    assert sorted(want) == sorted(state)
    for k, v in want.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def test_best_checkpoint_serves_with_its_loss(trajectories):
    trainer = trajectories["trainer"]
    assert set(trajectories["metrics"]) == {"train_loss", "train_accuracy", "val_loss",
                                            "val_accuracy"}
    val = trajectories["val"][0]
    cfg = Config(copy.deepcopy(trajectories["d"]))
    out = InferenceModel(cfg, trainer.best_ckpt_path, device="cpu")(val.coords, val.feats)
    assert out.shape == (12, 2) and np.isfinite(out).all()
    best = Trainer(cfg, LitPSD(cfg, device="cpu"), device="cpu")
    best.load_checkpoint(trainer.best_ckpt_path)
    test = best.test(BlockDataModule([], [], [val]))
    assert test["test_loss"] == pytest.approx(trainer.best_val_loss, rel=1e-5)


# -- the TCN, the schedules, the criterion -----------------------------------------

@pytest.mark.parametrize("channels", [[1, 1], [3, 5, 5]])
def test_tcn_with_weight_norm_matches_jax(channels):
    """The causal dilated TCN (a 1×1 downsample where widths change) from
    flax's weight-normed variables (scale and direction), and its weights'
    round trip."""
    import jax
    import jax.numpy as jnp

    from waveformml_tpu.models.blocks import TemporalConvNet as JaxTCN
    from waveformml_tpu_torch.models.blocks import TemporalConvNet

    rng = np.random.default_rng(7)
    nin = channels[0]
    x = rng.normal(size=(4, 20, nin)).astype(np.float32)
    jnet = JaxTCN(nin, channels[1:], kernel_size=3, dropout=0.0)
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    flat = {k: (v if k.endswith("/kernel") else
                (rng.normal(size=v.shape) * 0.3 + 1.0)).astype(np.float32)
            for k, v in _flat(variables).items()}
    want = np.asarray(jnet.apply(_unflatten(flat), jnp.asarray(x)))
    net = TemporalConvNet(nin, channels[1:], kernel_size=3, dropout=0.0)
    state = flax_to_state_dict(flat)
    assert sorted(state) == sorted(net.state_dict())
    net.load_state_dict(state)
    with torch.no_grad():
        got = net(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    back = state_dict_to_flax(net.state_dict())
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("version", [0, 1, 2, 3])
@pytest.mark.parametrize("params", [
    dict(size_factor=3, pad_factor=1.0),
    dict(size_factor=5, pad_factor=0.5, stride_factor=2, dil_factor=1, dropout=0.1),
    dict(size_factor=3, pointwise_factor=0.5, n_expansion=1, expansion_factor=1.5),
    dict(size_factor=4, depth_factor=0.8, pad_factor=1.0),
])
def test_sparse_conv2d_block_schedule_matches_jax(version, params):
    from waveformml_tpu.models.sparse_blocks import SparseConv2DBlock as JaxBlock
    from waveformml_tpu_torch.models.sparse_blocks import SparseConv2DBlock

    for nin, nout, n in ((130, 8, 2), (64, 16, 4), (32, 32, 3)):
        try:
            want = JaxBlock.schedule(nin, nout, n, True, version=version, **params)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                SparseConv2DBlock.schedule(nin, nout, n, True, version=version, **params)
            continue
        got = SparseConv2DBlock.schedule(nin, nout, n, True, version=version, **params)
        assert got == want
        assert SparseConv2DBlock.out_size(got, (NX, NY, nin)) == \
            JaxBlock.out_size(want, (NX, NY, nin))


@pytest.mark.parametrize("params", [
    dict(size_factor=3, pad_factor=1.0),
    dict(size_factor=5, pad_factor=0.5, stride_factor=2.0, dil_factor=1.0),
    dict(size_factor=3, pointwise_factor=0.5, n_expansion=1, expansion_factor=1.5),
])
def test_conv2d_block_and_extracted_feature_schedules_match_jax(params):
    from waveformml_tpu.models.blocks import Conv2DBlock as JaxConv2DBlock
    from waveformml_tpu.models.sparse_blocks import ExtractedFeatureConv as JaxEFC
    from waveformml_tpu_torch.models.blocks import Conv2DBlock
    from waveformml_tpu_torch.models.sparse_blocks import ExtractedFeatureConv

    for nin, nout, n in ((32, 4, 2), (130, 8, 3)):
        try:
            want = JaxConv2DBlock.schedule(nin, nout, n, **params)
        except ValueError:
            with pytest.raises(ValueError):
                Conv2DBlock.schedule(nin, nout, n, **params)
            continue
        assert Conv2DBlock.schedule(nin, nout, n, **params) == want
        size = (NX, NY, nin)
        assert Conv2DBlock(nin, nout, n, size, **params).out_size() == \
            JaxConv2DBlock(nin, nout, n, size, **params).out_size()
    ef = {k: v for k, v in params.items() if k in ("size_factor", "pad_factor",
                                                    "stride_factor", "dil_factor")}
    for nin, nout, n in ((5, 4, 2), (7, 3, 3)):
        assert ExtractedFeatureConv.schedule(nin, nout, n, 2.0, **ef) == \
            JaxEFC.schedule(nin, nout, n, 2.0, **ef)


@pytest.mark.parametrize("weight", [None, [0.3, 1.7, 1.0]])
def test_nll_loss_matches_jax(weight):
    import jax.numpy as jnp

    from waveformml_tpu.nn.functional import NLLLoss as JaxNLLLoss
    from waveformml_tpu_torch.nn.functional import NLLLoss, build_criterion

    rng = np.random.default_rng(3)
    logp = np.log(rng.dirichlet(np.ones(3), size=17)).astype(np.float32)
    target = rng.integers(0, 3, 17)
    ours = build_criterion("nn.NLLLoss", [weight] if weight else [])
    assert isinstance(ours, NLLLoss)
    theirs = JaxNLLLoss(weight, reduction="none")
    got = ours.elementwise(torch.from_numpy(logp), torch.from_numpy(target))
    want = theirs.elementwise(jnp.asarray(logp), jnp.asarray(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    den = ours.mean_denominator(torch.from_numpy(target))
    want_den = theirs.mean_denominator(jnp.asarray(target))
    if weight is None:
        assert den is None and want_den is None
    else:
        np.testing.assert_allclose(den.numpy(), np.asarray(want_den))
    with pytest.raises(ValueError):
        NLLLoss(None, 2)


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _ops_card_batch():
    """OPs3ns_SCNet.json as shipped, seeded random weights, on the card,
    and one prepared batch of 2048 events."""
    torch.manual_seed(0)
    task = LitPSD(load_config(os.path.join(ROOT, "config", "examples",
                                           "OPs3ns_SCNet.json")))
    block = labelled_block(np.random.default_rng(71), 2048, 65)
    db = task.to_device(task.prepare_block(block, task.row_bucket(block),
                                           task.event_bucket(block)))
    return task, db


@pytest.mark.cuda
def test_k1_at_ops3ns_widths_on_the_card(cuda):
    """K1 at 130→32 and 32→8, and as d_feats of the second conv (32 output
    columns), against its plain version."""
    from waveformml_tpu_torch.models.sparse_blocks import RowSubMConv2d
    from waveformml_tpu_torch.ops.row_conv import (subm_conv_rows, subm_conv_rows_bwd_plain,
                                                   subm_conv_rows_plain, transposed_kernel)

    task, db = _ops_card_batch()
    convs = [m for m in task.model.modules() if isinstance(m, RowSubMConv2d)]
    assert [tuple(m.weight.shape[1:]) for m in convs] == [(130, 32), (32, 8)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    mask, plan = db["mask"], db["plan_k3"]
    for conv in convs:
        cin, cout = conv.weight.shape[1:]
        feats = torch.randn(mask.shape[0], cin, device="cuda", generator=gen)
        feats = torch.where(mask[:, None], feats, 0.0).contiguous()
        args = (feats, plan, conv.weight.detach(), conv.bias.detach(), mask)
        torch.testing.assert_close(subm_conv_rows(*args), subm_conv_rows_plain(*args),
                                   rtol=1e-5, atol=1e-5)
        g = torch.randn(mask.shape[0], cout, device="cuda", generator=gen)
        g = torch.where(mask[:, None], g, 0.0).contiguous()
        weight = conv.weight.detach()
        got = subm_conv_rows(g, plan, transposed_kernel(weight), None, mask)
        want = subm_conv_rows_bwd_plain(feats, plan, weight, mask, g)[0]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_k4_at_ops3ns_widths_on_the_card(cuda):
    """K4 at the two convs (Cin + 1 = 131 and 33) against its plain
    version, each output within 1e-5 of the sum of its terms' magnitudes,
    and bitwise equal over two runs."""
    from waveformml_tpu_torch.models.sparse_blocks import RowSubMConv2d
    from waveformml_tpu_torch.ops.row_conv import (subm_conv_rows_wgrad,
                                                   subm_conv_rows_wgrad_plain)

    task, db = _ops_card_batch()
    convs = [m for m in task.model.modules() if isinstance(m, RowSubMConv2d)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    mask, plan = db["mask"], db["plan_k3"]
    for conv in convs:
        _, cin, cout = conv.weight.shape
        feats = torch.relu(torch.randn(mask.shape[0], cin, device="cuda", generator=gen))
        feats = torch.where(mask[:, None], feats, 0.0).contiguous()
        g = torch.randn(mask.shape[0], cout, device="cuda", generator=gen)
        g = torch.where(mask[:, None], g, 0.0).contiguous()
        got = subm_conv_rows_wgrad(feats, plan, g, mask)
        again = subm_conv_rows_wgrad(feats, plan, g, mask)
        want = subm_conv_rows_wgrad_plain(feats, plan, g, mask)
        scale = subm_conv_rows_wgrad_plain(feats.abs(), plan, g.abs(), mask)
        for a, b, s, c in zip(got, want, scale, again):
            assert bool(((a - b).abs() <= 1e-5 * s + 1e-30).all())
            assert torch.equal(a, c)


def test_basic_network_gives_the_features():
    """``BasicNetwork`` (the config-holding base model): the batch's
    features as they are, as the JAX package's gives them."""
    import jax.numpy as jnp

    from waveformml_tpu.models.nets import BasicNetwork as JaxBasicNetwork
    from waveformml_tpu.ops.sparse import SparseBatch as JaxBatch
    from waveformml_tpu_torch.ops.sparse import SparseBatch
    from waveformml_tpu_torch.registry import retrieve_class

    cfg = Config(_net_config("GEP"))
    net = retrieve_class("BasicNetwork.BasicNetwork")(cfg)
    assert net.plan_requirements() == set() and not list(net.parameters())
    rng = np.random.default_rng(2)
    coords = rng.integers(0, 11, (6, 3)).astype(np.int32)
    feats = rng.normal(size=(6, 4)).astype(np.float32)
    mask = np.ones(6, bool)
    got = net(SparseBatch(torch.from_numpy(coords), torch.from_numpy(feats),
                          torch.from_numpy(mask), 11))
    jb = JaxBatch(jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(mask), 11)
    want = JaxBasicNetwork(None).apply({}, jb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = torch.ones(2, 3)
    assert net(x) is x
