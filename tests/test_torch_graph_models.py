"""The graph family of the port against the JAX package, at narrow widths
(12 samples a PMT): ``GraphNet`` as IoniClassifierGraph.json builds it
(SAGEConv, k = 4, two convs, two Linear layers) and at other conv indices,
multi-head ones included; ``GraphZNet`` under ``LitZ`` and
``SingleEndedEZGraph`` under ``LitEZ`` (window edges and the ``knn1`` self
edges, the dense scatter); ``PointNet``; ``Graph3DNet``; the dynamic convs
(``feature_knn`` in the forward); ``GraphDataset``'s cache, read by each
package from the other's; ``InferenceModel`` on IoniClassifierGraph
against the JAX task's forward; a 10-step ``Trainer.fit`` trajectory of
IoniClassifierGraph.json against the JAX ``Trainer`` (rtol 2e-3, atol
2e-4); the CLI and the exported program. From the same flax weights
(``convert.py``): batches prepared by both packages equal, forwards within
rtol 1e-5, atol 1e-6 (the train-mode forward and its statistics within
rtol 1e-4, atol 1e-5), ``InferenceModel`` within rtol 1e-4, atol 1e-5.
The dynamic convs are held under the near-tie rule of
tests/test_parity_graph_torch.py: the rebuilt edge sets equal, or differ
only between candidates whose float64 distances agree to 1e-5 relative,
whose events are then left out of the value comparison."""
import copy
import json
import os

import numpy as np
import pytest
import torch

from waveformml_tpu_torch.config import Config, load_config, to_dict
from waveformml_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.datasets.synthetic import (BlockDataModule, labelled_block,
                                                     segment_block)
from waveformml_tpu_torch.engineering import tasks
from waveformml_tpu_torch.engineering.trainer import Trainer
from waveformml_tpu_torch.inference.model import InferenceModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "config", "examples", "IoniClassifierGraph.json")
N_SAMPLES = 12
RTOL, ATOL = 1e-5, 1e-6
TRAIN_RTOL, TRAIN_ATOL = 2e-3, 2e-4
EPOCHS, STEPS = 2, 5
#: GraphZNet's hparams in the JAX package's tests (tests/test_inference.py)
GRAPH_Z = {"neighbors": 1, "n_conv": 1, "n_point": 1, "conv_position": 1, "graph_index": 0}


def _graph_config(index=1, graph_params=None, net_class="GraphNet.GraphNet", **hparams):
    """IoniClassifierGraph.json at N_SAMPLES samples, conv ``index``."""
    d = to_dict(load_config(CONFIG))
    d["system_config"]["n_samples"] = N_SAMPLES
    d["net_config"]["net_class"] = net_class
    hp = d["net_config"]["hparams"]
    hp["graph_class_index"] = index
    if graph_params:
        hp["graph_params"] = graph_params
    hp.update(hparams)
    return d


def _segment_config(run_class, net_class, hparams):
    d = _graph_config(net_class=net_class)
    d["run_config"]["run_class"] = run_class
    d["net_config"].update(criterion_class="L1Loss", net_type="graph", hparams=hparams)
    d["dataset_config"]["dataset_class"] = "PulseDataset2DWithZ"
    return d


#: name → (config, the port's task class, the block maker)
MODELS = {
    "sage": (_graph_config(1), "LitPSD"),
    "gcn": (_graph_config(0), "LitPSD"),
    "gat_heads2": (_graph_config(3, {"heads": 2}), "LitPSD"),
    "transformer_heads2": (_graph_config(5, {"heads": 2}), "LitPSD"),
    "gmm": (_graph_config(10), "LitPSD"),
    "edgeconv": (_graph_config(12), "LitPSD"),
    "gen_localcartesian": (_graph_config(16, edge_transform="localcartesian"), "LitPSD"),
    "supergat_heads2_expand": (_graph_config(17, {"heads": 2}, n_graph=3, n_expand=1,
                                             expansion_factor=1.5), "LitPSD"),
    "pointnet": (_graph_config(net_class="GraphNet.PointNet", graph_out=8), "LitPSD"),
    "graph3d": (_graph_config(net_class="GraphNet.Graph3DNet", graph_out=8), "LitPSD"),
    "graphz": (_segment_config("LitZ", "GraphNet.GraphZNet", GRAPH_Z), "LitZ"),
    "ez_graph_edgeconv": (_segment_config("LitEZ", "SingleEndedEZGraph", dict(
        GRAPH_Z, graph_index=12, n_point=2)), "LitEZ"),
    "graphz_transformer": (_segment_config("LitZ", "GraphZNet", dict(
        GRAPH_Z, graph_index=5, neighbors=2, n_conv=2, conv_position=2)), "LitZ"),
    "ez_graph": (_segment_config("LitEZ", "GraphNet.SingleEndedEZGraph", dict(
        GRAPH_Z, graph_index=2)), "LitEZ"),
}


def _block(rng, task_name, n_events=24):
    if task_name == "LitZ":
        return segment_block(rng, n_events, N_SAMPLES, label="z", max_mult=8)
    if task_name == "LitEZ":
        return segment_block(rng, n_events, N_SAMPLES, label="ez", max_mult=8)
    return labelled_block(rng, n_events, N_SAMPLES, max_mult=8)


def _jax_trainer(d, block, seed=0):
    import jax

    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock
    from waveformml_tpu.engineering import tasks as jtasks
    from waveformml_tpu.engineering.trainer import Trainer as JaxTrainer
    from waveformml_tpu.parallel.mesh import make_mesh

    jcfg = JaxConfig(copy.deepcopy(d))
    task = getattr(jtasks, d["run_config"]["run_class"])(jcfg)
    jt = JaxTrainer(jcfg, task, mesh=make_mesh(jax.devices()[:1]), seed=seed, callbacks=[])
    jt._ensure_state(JaxFileBlock(block.coords, block.feats, block.labels, {}))
    return jt


def _flat(variables):
    import jax
    from flax.traverse_util import flatten_dict

    return {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(variables),
                                                        sep="/").items()}


def _tree(flat):
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict

    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def _variables(jt):
    v = {"params": jt.state.params}
    if jt.state.batch_stats:
        v["batch_stats"] = jt.state.batch_stats
    return v


def _redraw(jt, seed):
    """Every variable redrawn (init leaves biases zero and statistics
    trivial); returns the flat variables."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in _flat(_variables(jt)).items():
        if k.endswith("/var"):
            value = rng.uniform(0.5, 2.0, size=v.shape)
        elif k.endswith("/kernel"):
            value = rng.normal(size=v.shape) / np.sqrt(max(1, v.shape[0]))
        elif k.endswith("/bias"):
            value = np.abs(rng.normal(size=v.shape)) * 0.3
        else:
            value = rng.normal(size=v.shape) * 0.1 + k.endswith(("/scale", "/sigma"))
        flat[k] = value.astype(np.float32)
    tree = _tree(flat)
    jt.state.params, jt.state.batch_stats = tree["params"], tree.get("batch_stats", {})
    return flat


def _jax_db(jt, block):
    import jax.numpy as jnp

    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock

    jb = JaxFileBlock(block.coords, block.feats, block.labels, {})
    db = jt.task.prepare_block(jb, jt.task.row_bucket(jb), jt.task.event_bucket(jb))
    return {k: jnp.asarray(v) for k, v in db.items()}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model_case(request):
    d, task_name = MODELS[request.param]
    block = _block(np.random.default_rng(41), task_name)
    jt = _jax_trainer(d, block)
    flat = _redraw(jt, 42)
    task = getattr(tasks, task_name)(Config(copy.deepcopy(d)), device="cpu")
    state = flax_to_state_dict(flat)
    assert sorted(state) == sorted(task.model.state_dict())
    task.model.load_state_dict(state)
    return dict(name=request.param, d=d, jt=jt, flat=flat, task=task, block=block)


def _prepared(case):
    task, block = case["task"], case["block"]
    db = task.prepare_block(block, task.row_bucket(block), task.event_bucket(block))
    jdb = _jax_db(case["jt"], block)
    assert sorted(db) == sorted(jdb)
    assert any(k.startswith("edges_") for k in db)
    for k in db:
        np.testing.assert_array_equal(db[k], np.asarray(jdb[k]), err_msg=k)
    return task.to_device(db), jdb


def test_forward_matches_jax(model_case):
    jt, task = model_case["jt"], model_case["task"]
    db, jdb = _prepared(model_case)
    want = np.asarray(jt.task.apply_model(_variables(jt), jdb, train=False)[0])
    got = task.apply_model(db).numpy()
    assert got.shape == want.shape and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert task.model.plan_requirements() == set()


def test_train_mode_forward_and_statistics_match_jax(model_case):
    jt, task = model_case["jt"], model_case["task"]
    db, jdb = _prepared(model_case)
    want, stats = jt.task.apply_model(_variables(jt), jdb, train=True)
    model = copy.deepcopy(task.model)
    saved, task.model = task.model, model
    try:
        with torch.no_grad():
            got = task.model_outputs(db, train=True).numpy()
    finally:
        task.model = saved
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    want_stats = flax_to_state_dict(_flat({"batch_stats": stats}) if stats else {})
    for k, v in want_stats.items():
        np.testing.assert_allclose(model.state_dict()[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_loss_and_weights_round_trip(model_case):
    jt, task = model_case["jt"], model_case["task"]
    db, jdb = _prepared(model_case)
    out = task.apply_model(db)
    jout = jt.task.apply_model(_variables(jt), jdb, train=False)[0]
    ls, w, _ = task.loss_and_metrics(out, db)
    jls, jw, _ = jt.task.loss_and_metrics(jout, jdb)
    np.testing.assert_allclose(float(ls), float(jls), rtol=1e-5)
    assert float(w) == pytest.approx(float(jw))
    back = state_dict_to_flax(task.model.state_dict())
    assert sorted(back) == sorted(model_case["flat"])
    for k, v in model_case["flat"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_shipped_config_builds_its_planes():
    """IoniClassifierGraph.json as shipped: SAGEConv 130 → 73 → 16, masked
    BatchNorm after each, a max pool, LinearBlock 16 → 2; the edges it
    wants are the kNN graph with k = 4 and no self loops."""
    from waveformml_tpu_torch.models.graph_layers import SAGEConv
    from waveformml_tpu_torch.models.graph_net import GraphNet

    task = tasks.LitPSD(load_config(CONFIG), device="cpu")
    net = task.model
    assert type(net) is GraphNet and net.is_graph and task.is_graph
    assert [type(net.gconv_0), type(net.gconv_1)] == [SAGEConv, SAGEConv]
    assert (net.gconv_0.lin_l.in_features, net.gconv_0.lin_l.out_features,
            net.gconv_1.lin_l.out_features) == (130, 73, 16)
    assert net.gconv_0.lin_r.bias is None
    assert [net.linear.dense_0.in_features, net.linear.dense_1.out_features] == [16, 2]
    assert net.edge_requirements() == [("knn", 4, False)]


# -- serving and training ---------------------------------------------------------------

def test_inference_model_matches_the_jax_task():
    """IoniClassifierGraph through ``InferenceModel`` on the CPU: the edges
    built on the host for each chunk, the outputs of the real events
    against the JAX task's forward over the same chunk; the edge build is
    its own phase, inside host prep."""
    d, _ = MODELS["sage"]
    rng = np.random.default_rng(43)
    block = _block(rng, "LitPSD", n_events=40)
    jt = _jax_trainer(d, block)
    flat = _redraw(jt, 44)
    server = InferenceModel(Config(copy.deepcopy(d)), flax_to_state_dict(flat), device="cpu")
    chunks = [block, _block(rng, "LitPSD", n_events=13)]
    for b in chunks:
        got = server(b.coords, b.feats)
        n_ev = b.labels.shape[0]
        want = np.asarray(jt.task.apply_model(_variables(jt), _jax_db(jt, b), train=False)[0])
        assert got.shape == (n_ev, 2)
        np.testing.assert_allclose(got, want[:n_ev], rtol=1e-4, atol=1e-5)
    phases = server.dispatch_phases
    assert 0 < phases["edge_build_s"] < phases["host_prep_s"]


@pytest.fixture(scope="module")
def trajectory(tmp_path_factory):
    """The JAX Trainer stepped as its fit steps (train step, then the
    ExponentialLR step an epoch) and the port's ``Trainer.fit`` from the
    converted weights, EPOCHS × STEPS blocks of IoniClassifierGraph.json
    (SGD, nesterov momentum 0.98)."""
    import jax
    import jax.numpy as jnp

    from waveformml_tpu import optim as wopt
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock

    d, _ = MODELS["sage"]
    rng = np.random.default_rng(45)
    train = [_block(rng, "LitPSD", 32) for _ in range(STEPS)]
    val = [_block(rng, "LitPSD", 32)]
    jt = _jax_trainer(d, train[0])
    flat = _redraw(jt, 46)
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
    task = tasks.LitPSD(cfg, device="cpu")
    task.model.load_state_dict(flax_to_state_dict(flat))
    trainer = Trainer(cfg, task, device="cpu", max_epochs=EPOCHS,
                      checkpoint_dir=str(tmp_path_factory.mktemp("ckpt")))
    trainer.fit(BlockDataModule(train, val, val))
    return dict(trainer=trainer, jax_losses=jax_losses, jax_flat=_flat(_variables(jt)),
                val=val, d=d)


def test_training_losses_match_jax(trajectory):
    got = np.asarray(trajectory["trainer"].step_losses)
    want = np.asarray(trajectory["jax_losses"])
    assert got.shape == want.shape == (EPOCHS * STEPS,)
    assert np.all(np.isfinite(got)) and len(set(np.round(got, 6))) > 1
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)


def test_trained_weights_match_jax(trajectory):
    want = flax_to_state_dict(trajectory["jax_flat"])
    state = trajectory["trainer"].task.model.state_dict()
    assert sorted(want) == sorted(state)
    for k, v in want.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def test_best_checkpoint_serves_tests_and_exports(trajectory, tmp_path):
    """The best checkpoint serves the validation chunk and tests with its
    recorded loss (``PSDEvaluator`` fed); its exported eval forward reloads
    and gives the eager outputs."""
    from waveformml_tpu_torch.engineering.trainer import load_exported
    from waveformml_tpu_torch.evaluation.psd_eval import PSDEvaluator

    trainer = trajectory["trainer"]
    val = trajectory["val"][0]
    cfg = Config(copy.deepcopy(trajectory["d"]))
    out = InferenceModel(cfg, trainer.best_ckpt_path, device="cpu")(val.coords, val.feats)
    assert out.shape == (val.labels.shape[0], 2) and np.isfinite(out).all()
    best = Trainer(cfg, tasks.LitPSD(cfg, device="cpu"), device="cpu", callbacks=[])
    best.load_checkpoint(trainer.best_ckpt_path)
    test = best.test(BlockDataModule([], [], [val]))
    assert test["test_loss"] == pytest.approx(trainer.best_val_loss, rel=1e-5)
    assert isinstance(best.task.evaluator, PSDEvaluator)
    path = best.export_model(str(tmp_path / "model.pt2"), val)
    db = best.device_batch(val)[0]
    got = load_exported(path, "cpu")(db)
    want = best.task.apply_model(db)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)


def test_cli_trains_tests_and_exports(tmp_path, capsys):
    """``python -m waveformml_tpu_torch.main`` on IoniClassifierGraph.json
    (``--validate``, ``--device cpu``, 1 epoch and a test) over HDF5 class
    directories, then ``python -m waveformml_tpu_torch.evaluate --script``
    on its checkpoint: ``model.pt2`` in the version directory."""
    import ast
    import glob
    import logging

    from waveformml_tpu_torch import evaluate
    from waveformml_tpu_torch import main as cli
    from waveformml_tpu_torch.datasets.synthetic import write_classification_dirs

    write_classification_dirs(str(tmp_path / "data"), ["Ioni", "Recoil"], n_files=4,
                              events_per_file=20, n_samples=N_SAMPLES, seed=5)
    d, _ = MODELS["sage"]
    d = copy.deepcopy(d)
    d["system_config"]["model_base_path"] = str(tmp_path / "model")
    d["dataset_config"].update(base_path=str(tmp_path / "data"), n_train=40, n_validate=20,
                               n_test=20, shuffled_size=20,
                               dataloader_params={"batch_size": 1, "num_workers": 0})
    path = str(tmp_path / "IoniClassifierGraph.json")
    with open(path, "w") as f:
        json.dump(d, f)
    logger = logging.getLogger("waveformml_tpu_torch")
    saved = (list(logger.handlers), logger.level)
    try:
        assert cli.main([path, "--validate", "--device", "cpu", "--max_epochs", "1", "-t",
                         "-v", "1"]) == 0
        out = capsys.readouterr().out
        test = [ln for ln in out.splitlines() if ln.startswith("test: ")]
        assert len(test) == 1, out
        assert set(ast.literal_eval(test[0][6:])) == {"test_loss", "test_accuracy"}
        ckpt = glob.glob(str(tmp_path / "model" / "IoniClassifierGraph" / "runs" / "*" /
                             "version_0" / "*.ckpt"))
        assert len(ckpt) == 1
        assert evaluate.main([path, ckpt[0], "--script", "--limit_test_batches", "1",
                              "--device", "cpu", "-v", "1"]) == 0
    finally:
        logger.handlers, logger.level = saved
    assert os.path.getsize(os.path.join(os.path.dirname(ckpt[0]), "model.pt2")) > 0


def test_config_names_resolve():
    """The graph net_type and data module validate and resolve: the port's
    ``choose_data_module`` builds a ``GraphDataModule``, a
    ``PSDDataModule``."""
    from waveformml_tpu_torch.config import validate_config
    from waveformml_tpu_torch.datasets.data_module import GraphDataModule, PSDDataModule
    from waveformml_tpu_torch.main import choose_data_module
    from waveformml_tpu_torch.registry import retrieve_class

    for net_type in ("Graph", "graph"):
        d, _ = MODELS["sage"]
        d = copy.deepcopy(d)
        d["net_config"]["net_type"] = net_type
        cfg = validate_config(Config(d))
        assert cfg.net_config.net_type == net_type
        dm = choose_data_module(cfg)
        assert type(dm) is GraphDataModule and isinstance(dm, PSDDataModule)
    for name in ("GraphNet", "GraphNet.GraphNet", "GraphZNet", "GraphNet.SingleEndedEZGraph",
                 "GraphNet.PointNet", "GraphNet.Graph3DNet", "GraphDataModule.GraphDataModule",
                 "GraphDataset"):
        assert retrieve_class(name) is not None


# -- the dynamic convs ------------------------------------------------------------------

def _knn_sets(edges, mask):
    sets = {}
    for s, d, m in zip(edges[0], edges[1], mask):
        if m:
            sets.setdefault(int(d), set()).add(int(s))
    return sets


def _near_tie_centres(x, got, want):
    """The centres whose live neighbour sets differ, each difference
    between candidates whose float64 distances agree to 1e-5 relative (an
    assertion otherwise)."""
    x64 = x.astype(np.float64)
    tied = []
    for c in set(got) | set(want):
        a, b = got.get(c, set()), want.get(c, set())
        if a == b:
            continue
        d64 = [float(np.sum((x64[c] - x64[j]) ** 2)) for j in a ^ b]
        assert max(d64) - min(d64) <= 1e-5 * max(max(d64), 1e-30), (c, a, b, d64)
        tied.append(c)
    return tied


@pytest.mark.parametrize("block", [1024, 7])
def test_feature_knn_matches_jax(block):
    """Live edges in the same order and the same masks, in one strip and in
    strips of 7 centres; exact ties (equal rows) to the lower row index;
    masked rows and lone rows without live neighbours."""
    import jax.numpy as jnp

    from waveformml_tpu.models.graph_layers import feature_knn as jknn
    from waveformml_tpu_torch.models.graph_layers import feature_knn

    rng = np.random.default_rng(47)
    sizes = rng.integers(1, 9, 12)
    batch = np.repeat(np.arange(12), sizes).astype(np.int32)
    n = batch.size
    x = rng.normal(size=(n, 5)).astype(np.float32)
    x[3] = x[1] = x[2]                                  # exact ties
    mask = rng.random(n) > 0.15
    # padding rows at the end, event 0, masked
    batch = np.r_[batch, np.zeros(5, np.int32)]
    x = np.r_[x, np.zeros((5, 5), np.float32)]
    mask = np.r_[mask, np.zeros(5, bool)]
    for k in (1, 3, 6):
        je, jm = jknn(jnp.asarray(x), jnp.asarray(batch), jnp.asarray(mask), k)
        je, jm = np.asarray(je), np.asarray(jm)
        te, tm = feature_knn(torch.from_numpy(x), torch.from_numpy(batch),
                             torch.from_numpy(mask), k, block=block)
        assert te.dtype == torch.int32 and te.shape == (2, (n + 5) * k)
        te, tm = te.numpy(), tm.numpy()
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_array_equal(te[:, tm], je[:, jm])


class _DynStack(torch.nn.Module):
    """The port's counterpart of tests/test_parity_graph_torch.py
    ``_DynStack``: two dynamic convs (the kNN rebuilt from each layer's
    input), masked BatchNorm, the max pool and a LinearBlock."""

    def __init__(self, conv, planes, k):
        super().__init__()
        from waveformml_tpu_torch.models.blocks import LinearBlock, MaskedArrayBatchNorm
        from waveformml_tpu_torch.models.graph_net import DynamicEdgeConv, DynamicGraphConv

        cls = DynamicEdgeConv if conv == "edge" else DynamicGraphConv
        for i in range(2):
            self.add_module(f"gconv_{i}", cls(planes[i], planes[i + 1], k=k))
            self.add_module(f"norm_{i}", MaskedArrayBatchNorm(planes[i + 1]))
        self.linear = LinearBlock(planes[-1], 2, 2)

    def forward(self, db, inputs=None):
        from waveformml_tpu_torch.models.graph_layers import global_max_pool

        x, coords, mask = db["feats"], db["coords"], db["mask"]
        for i in range(2):
            if inputs is not None:
                inputs.append(x.detach().numpy().copy())
            x = getattr(self, f"gconv_{i}")(x, x, coords[:, 2], mask)
            x = getattr(self, f"norm_{i}")(x, mask)
        return self.linear(global_max_pool(x, coords[:, 2], db["labels"].shape[0], mask))


@pytest.mark.parametrize("conv", ["edge", "gcn"])
def test_dynamic_convs_match_jax(conv, tmp_path):
    import jax
    import jax.numpy as jnp

    from test_parity_graph_torch import _DynStack as JaxDynStack
    from test_parity_graph_torch import _events_to_compare, _randomize_tree, _stack_db
    from waveformml_tpu.models.graph_layers import feature_knn as jknn
    from waveformml_tpu_torch.models.graph_layers import feature_knn

    db, n_ev = _stack_db(np.random.default_rng(48), tmp_path)
    jmodel = JaxDynStack(conv=conv)
    dbj = {k: jnp.asarray(v) for k, v in db.items()}
    variables = _randomize_tree(jmodel.init(jax.random.PRNGKey(0), dbj),
                                np.random.default_rng(49))
    want = np.asarray(jmodel.apply(variables, dbj))[:n_ev]
    model = _DynStack(conv, jmodel.planes, jmodel.k)
    model.load_state_dict(flax_to_state_dict(_flat(variables)))
    model.eval()
    inputs = []
    tdb = {k: torch.from_numpy(np.asarray(v)) for k, v in db.items()}
    with torch.no_grad():
        got = model(tdb, inputs).numpy()[:n_ev]
    batch, mask = np.asarray(db["coords"][:, 2]), np.asarray(db["mask"])
    tied = []
    for x in inputs:
        te, tm = feature_knn(torch.from_numpy(x), torch.from_numpy(batch),
                             torch.from_numpy(mask), jmodel.k)
        je, jm = jknn(jnp.asarray(x), jnp.asarray(batch.astype(np.int32)), jnp.asarray(mask),
                      jmodel.k)
        tied += _near_tie_centres(x, _knn_sets(te.numpy(), tm.numpy()),
                                  _knn_sets(np.asarray(je), np.asarray(jm)))
    keep = _events_to_compare(tied, batch, n_ev)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-4, atol=1e-4)


# -- GraphDataset's cache ---------------------------------------------------------------

class _Blocks:
    """A block dataset over files on disk (their mtimes key the cache)."""

    def __init__(self, root, blocks):
        self.files = []
        for i in range(len(blocks)):
            path = os.path.join(root, f"part{i}.h5")
            with open(path, "w") as f:
                f.write("x")
            self.files.append(path)
        self.blocks = blocks
        self.reads = 0

    def get_file_list(self):
        return list(self.files)

    def get_path_info(self, path):
        return {"event_range": [0, int(self.blocks[self.files.index(path)].labels.shape[0])]}

    def __getitem__(self, i):
        self.reads += 1
        return self.blocks[i]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_graph_dataset_cache_is_read_by_the_other_package(writer, tmp_path):
    """One package writes the cache, the other reads it without reading
    the source or rebuilding (equal signatures); the cached blocks are
    equal; a batch prepared from the cached edges (compacted and re-padded
    to its bucket) equals one whose edges are built anew."""
    from waveformml_tpu.datasets.graph_dataset import GraphDataset as JaxGraphDataset
    from waveformml_tpu_torch.datasets.graph_dataset import GraphDataset

    rng = np.random.default_rng(50)
    blocks = [labelled_block(rng, 12, N_SAMPLES, max_mult=8) for _ in range(2)]
    specs = [("knn", 4, False), ("window", 1, True)]
    first, second = ((JaxGraphDataset, GraphDataset) if writer == "jax"
                     else (GraphDataset, JaxGraphDataset))
    source = _Blocks(str(tmp_path), blocks)
    written = first(source, edge_specs=specs)
    mtimes = [os.path.getmtime(p) for p in written.processed_file_names]
    reads = source.reads
    assert reads == 2
    read = second(source, edge_specs=[list(s) for s in specs])
    assert source.reads == reads
    assert [os.path.getmtime(p) for p in read.processed_file_names] == mtimes
    assert [written._signature(i) for i in range(2)] == [read._signature(i) for i in range(2)]
    task = tasks.LitPSD(Config(copy.deepcopy(MODELS["sage"][0])), device="cpu")
    for i, b in enumerate(blocks):
        got, want = read[i], written[i]
        for name in ("coords", "feats", "labels"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        assert sorted(got.extras) == sorted(want.extras) == [
            "edge_mask_knn4", "edge_mask_w1", "edges_knn4", "edges_w1"]
        cached = GraphDataset(source, edge_specs=specs)[i]
        rb, eb = task.row_bucket(b), task.event_bucket(b)
        from_cache = task.prepare_block(cached, rb, eb)
        fresh = task.prepare_block(FileBlock(b.coords, b.feats, b.labels), rb, eb)
        assert sorted(from_cache) == sorted(fresh)
        for k, v in fresh.items():
            np.testing.assert_array_equal(from_cache[k], v, err_msg=k)
    # a changed edge spec rebuilds
    GraphDataset(source, edge_specs=[("knn", 3, False)])
    assert source.reads == reads + 2
