"""The 3D path of the port against the JAX package: the 3D grid ops
(``flat_site_3d``, ``scatter_to_dense_3d``, ``occupancy_mask_3d``,
``rows_to_dense_3d``, ``batch_to_grid_3d``), the K×K×K neighbour plan
(``host_neighbor_plan(..., n_t)``), the rank-3 grid convs
(``spconv.SubMConv3d``, ``SparseConv3d``, ``SparseInverseConv3d``), the 3D
row stack ``DSLSpecNet(n_t)`` (its forward, its train-mode forward and
statistics, and the gradients of its input, kernels and biases through the
plain versions of K1 and K4) and SCNet3D.json (``SCNet`` on the dense
grid) at T = 4 samples: its forward, ``InferenceModel`` against the JAX
task's forward, a 10-step
training trajectory against the JAX ``Trainer`` (rtol 2e-3, atol 2e-4),
the weights' round trip through ``convert.py`` and the CLI. The row stack
is also held to the grid's SubM convs at every occupied site. Card tests
hold K1 (2→8 forward, 8→8 as d_feats) and K4 (Cin + 1 = 3) at 27 taps
against their plain versions."""
import copy
import os

import numpy as np
import pytest
import torch

from test_torch_sparse_nets import _flat, _jax_db, _jax_trainer, _redraw, _unflatten

from waveformml_tpu_torch.config import Config, load_config, to_dict
from waveformml_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from waveformml_tpu_torch.datasets.synthetic import BlockDataModule, labelled_block_3d
from waveformml_tpu_torch.engineering.tasks import LitPSD
from waveformml_tpu_torch.engineering.trainer import Trainer
from waveformml_tpu_torch.inference.model import InferenceModel
from waveformml_tpu_torch.ops.sparse import SparseBatch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX, NY = 14, 11
T = 4
RTOL, ATOL = 1e-5, 1e-6
TRAIN_RTOL, TRAIN_ATOL = 2e-3, 2e-4
EPOCHS, STEPS = 2, 5
#: SCNet3D.json's sparse section, in row specs (SubM 2→8, BN, ReLU, ToDense)
#: and with a second SubM conv for the gradient checks
ROW_SPECS = (("subm", 2, 8, 3, 1, "subm3"), ("bn", 8), ("relu",),
             ("subm", 8, 5, 3, 1, "subm3"), ("todense",))


def _scnet3d_config(n_t=T):
    """SCNet3D.json at ``n_t`` samples: its head's width follows."""
    d = to_dict(load_config(os.path.join(ROOT, "config", "examples", "SCNet3D.json")))
    d["system_config"]["n_samples"] = n_t
    alg = d["net_config"]["algorithm"]
    alg[alg.index("nn.Linear") + 1] = [8 * NX * NY * n_t, 32]
    return d


def _block(rng, n_events=16):
    return labelled_block_3d(rng, n_events, T)


def _batches(block, n_events):
    """The block as a padded JAX and port SparseBatch, with the 3D plan."""
    import jax.numpy as jnp

    from waveformml_tpu.ops.row_conv import host_neighbor_plan as jax_plan
    from waveformml_tpu.ops.sparse import SparseBatch as JaxBatch
    from waveformml_tpu_torch.ops.sparse import pad_sparse

    coords, feats, mask = pad_sparse(block.coords, block.feats, 512)
    plan = jax_plan(coords, mask, n_events, 3, T)
    jb = JaxBatch(jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(mask), n_events,
                  plans={"k3": jnp.asarray(plan)})
    pb = SparseBatch(torch.from_numpy(coords), torch.from_numpy(feats), torch.from_numpy(mask),
                     n_events, plans={f"k3t{T}": torch.from_numpy(plan)})
    return jb, pb


# -- plans and grid ops ------------------------------------------------------------

@pytest.mark.parametrize("k,n_t", [(1, 4), (3, 4), (3, 16), (5, 7)])
def test_host_plan_3d_matches_jax(k, n_t):
    """The [N, K³] plan, tap order (dx, dy, dt) row-major, -1 where absent
    (empty, outside the grid or its T samples, padding rows), equals the
    JAX package's; and the 2D plan is unchanged."""
    from waveformml_tpu.ops.row_conv import host_neighbor_plan as jax_plan
    from waveformml_tpu_torch.ops.row_conv import host_neighbor_plan

    rng = np.random.default_rng(k * 31 + n_t)
    n = 700
    coords = np.stack([rng.integers(0, NX, n), rng.integers(0, NY, n),
                       rng.integers(0, n_t, n), np.sort(rng.integers(0, 30, n))],
                      1).astype(np.int32)
    mask = rng.random(n) < 0.9
    got = host_neighbor_plan(coords, mask, 30, k, n_t)
    assert got.shape == (n, k ** 3) and got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_plan(coords, mask, 30, k, n_t))
    c2 = coords[:, [0, 1, 3]]
    np.testing.assert_array_equal(host_neighbor_plan(c2, mask, 30, k),
                                  jax_plan(c2, mask, 30, k))


def test_grid_ops_3d_match_jax():
    import jax.numpy as jnp

    from waveformml_tpu.models.nets import batch_to_grid_3d as jax_grid
    from waveformml_tpu.ops import row_conv as jrc
    from waveformml_tpu.ops import sparse as js
    from waveformml_tpu_torch.ops import row_conv, sparse
    from waveformml_tpu_torch.ops.sparse_conv import batch_to_grid_3d

    block = _block(np.random.default_rng(3))
    jb, pb = _batches(block, 16)
    np.testing.assert_array_equal(sparse.occupancy_mask_3d(pb, T).numpy(),
                                  np.asarray(js.occupancy_mask_3d(jb, T)))
    np.testing.assert_allclose(sparse.scatter_to_dense_3d(pb, T).numpy(),
                               np.asarray(js.scatter_to_dense_3d(jb, T)), rtol=0, atol=0)
    rows = np.random.default_rng(4).normal(size=(512, 3)).astype(np.float32)
    np.testing.assert_allclose(
        row_conv.rows_to_dense_3d(torch.from_numpy(rows), pb, T).numpy(),
        np.asarray(jrc.rows_to_dense_3d(jnp.asarray(rows), jb, T)), rtol=1e-7, atol=0)
    grid, jgrid = batch_to_grid_3d(pb, T), jax_grid(jb, T)
    np.testing.assert_array_equal(grid.features.permute(0, 2, 3, 4, 1).numpy(),
                                  np.asarray(jgrid.features))
    np.testing.assert_array_equal(grid.occupancy.numpy(), np.asarray(jgrid.occupancy))
    site = sparse.flat_site_3d(pb, T).numpy()
    want = np.asarray(jb.flat_site_3d(T))
    np.testing.assert_array_equal(site, want)
    assert np.all(site[~pb.mask.numpy()] == 16 * NX * NY * T)
    np.testing.assert_array_equal(pb.t.numpy(), np.asarray(jb.t))


@pytest.mark.parametrize("kind", ["subm", "sparse", "inverse"])
def test_grid_convs_3d_match_jax(kind):
    """The rank-3 grid convs (their 3D registry names) against the JAX
    package's rank-generic classes, the SparseGrid's occupancy included,
    and their weights' round trip."""
    import jax
    import jax.numpy as jnp

    from waveformml_tpu.models.nets import batch_to_grid_3d as jax_grid
    from waveformml_tpu.ops import sparse_conv as jsc
    from waveformml_tpu_torch.ops.sparse_conv import batch_to_grid_3d
    from waveformml_tpu_torch.registry import retrieve_class

    block = _block(np.random.default_rng(5))
    jb, pb = _batches(block, 16)
    grid, jgrid = batch_to_grid_3d(pb, T), jax_grid(jb, T)
    if kind == "subm":
        name, args = "spconv.SubMConv3d", (2, 4, 3)
        jmod = jsc.SubMConv2d(*args)
    elif kind == "sparse":
        name, args = "spconv.SparseConv3d", (2, 4, 3, 1, 1)
        jmod = jsc.SparseConv2d(*args)
    else:
        name, args = "spconv.SparseInverseConv3d", (2, 4, 3)
        jgrid = jsc.SparseConv2d(2, 2, 3, 1, 1, indice_key="k").apply(
            {"params": {"conv": {"kernel": jnp.eye(2)[None, None, None].repeat(3, 0)
                                 .repeat(3, 1).repeat(3, 2) / 27, "bias": jnp.zeros(2)}}},
            jgrid)
        jmod = jsc.SparseInverseConv2d(2, 4, 3, indice_key="k")
    mod = retrieve_class(name)(*args, **({"indice_key": "k"} if kind == "inverse" else {}))
    variables = jmod.init(jax.random.PRNGKey(0), jgrid)
    rng = np.random.default_rng(6)
    flat = {k: (rng.normal(size=v.shape) * 0.3).astype(np.float32)
            for k, v in _flat(variables).items()}
    mod.load_state_dict(flax_to_state_dict(flat))
    want = jmod.apply(_unflatten(flat), jgrid)
    if kind == "inverse":
        from waveformml_tpu_torch.ops.sparse_conv import SparseConv2d, SparseConv3d

        first = SparseConv3d(2, 2, 3, 1, 1, indice_key="k")
        assert isinstance(first, SparseConv2d) and first.ndim == 3
        with torch.no_grad():
            first.conv.weight.copy_(torch.eye(2)[:, :, None, None, None].repeat(1, 1, 3, 3, 3)
                                    / 27)
            first.conv.bias.zero_()
            grid = first(grid)
    with torch.no_grad():
        got = mod(grid)
    np.testing.assert_allclose(got.features.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(want.features), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.occupancy.numpy(), np.asarray(want.occupancy))
    back = state_dict_to_flax(mod.state_dict())
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_sparseconvnet_adapters_take_their_dimension():
    from waveformml_tpu_torch.models.algorithm import (SCNConvolution,
                                                       SCNSubmanifoldConvolution)
    from waveformml_tpu_torch.ops.sparse_conv import SparseConv3d, SubMConv2d, SubMConv3d

    assert type(SCNSubmanifoldConvolution(3, 2, 4, 3).conv) is SubMConv3d
    assert type(SCNSubmanifoldConvolution(2, 2, 4, 3).conv) is SubMConv2d
    conv = SCNConvolution(3, 2, 4, 2, 2).conv
    assert type(conv) is SparseConv3d and conv.conv.weight.shape == (4, 2, 2, 2, 2)


# -- the 3D row stack --------------------------------------------------------------

@pytest.fixture(scope="module")
def row_stack():
    """The JAX DSLSpecNet(n_t) and the port's from the same redrawn flax
    variables, and one padded batch of both."""
    import jax

    from waveformml_tpu.models.sparse_blocks import DSLSpecNet as JaxNet
    from waveformml_tpu_torch.models.sparse_blocks import DSLSpecNet

    block = _block(np.random.default_rng(7))
    jb, pb = _batches(block, 16)
    jnet = JaxNet(ROW_SPECS, n_t=T)
    variables = jnet.init(jax.random.PRNGKey(1), jb)
    rng = np.random.default_rng(8)
    flat = {}
    for k, v in _flat(variables).items():
        if k.endswith("/var"):
            value = rng.uniform(0.5, 2.0, size=v.shape)
        elif k.endswith("/kernel"):
            value = v
        else:
            value = rng.normal(size=v.shape) * 0.2 + k.endswith("/scale")
        flat[k] = value.astype(np.float32)
    net = DSLSpecNet(ROW_SPECS, n_t=T)
    net.load_state_dict(flax_to_state_dict(flat))
    return dict(jnet=jnet, net=net, flat=flat, jb=jb, pb=pb)


def test_dsl_spec_net_3d_forward_matches_jax(row_stack):
    """Eval and train mode (BatchNorm statistics over the real rows, the
    running statistics they move); the output on the [B, C, NX, NY, T]
    grid; the stack reads the k3t<T> plan, 27 taps a row."""
    jnet, net, flat = row_stack["jnet"], row_stack["net"], row_stack["flat"]
    jb, pb = row_stack["jb"], row_stack["pb"]
    assert net.plan_requirements() == {f"k3t{T}"}
    assert [tuple(m.weight.shape) for m in (net.l0, net.l3)] == [(27, 2, 8), (27, 8, 5)]
    net.eval()
    with torch.no_grad():
        got = net(pb).numpy()
    want = np.asarray(jnet.apply(_unflatten(flat), jb))
    assert got.shape == want.shape == (16, 5, NX, NY, T)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    train = copy.deepcopy(net).train()
    with torch.no_grad():
        got = train(pb).numpy()
    want, stats = jnet.apply(_unflatten(flat), jb, train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)
    for k, v in flax_to_state_dict(_flat(stats)).items():
        np.testing.assert_allclose(train.state_dict()[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_dsl_spec_net_3d_gradients_match_jax(row_stack):
    """The gradients of Σ out·g (train mode) with respect to the input
    features, the row kernels [27, Cin, Cout], the biases and the
    BatchNorm's scale and bias, through the plain versions of K1 (the
    forward and d_feats over the 27-tap plan) and K4, against jax.grad of
    the JAX stack's custom VJP (tests/test_sparse_conv3d.py's check). The
    first conv's bias, before the BatchNorm, has a gradient of rounding on
    both sides."""
    import jax
    import jax.numpy as jnp

    jnet, flat, jb, pb = row_stack["jnet"], row_stack["flat"], row_stack["jb"], row_stack["pb"]
    net = copy.deepcopy(row_stack["net"]).train()
    g = np.random.default_rng(9).normal(size=(16, 5, NX, NY, T)).astype(np.float32)
    tree = _unflatten(flat)

    def loss(feats, params):
        batch = type(jb)(jb.coords, feats, jb.mask, jb.n_events, plans=jb.plans)
        out, _ = jnet.apply({"params": params, "batch_stats": tree["batch_stats"]}, batch,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * g)

    want_x, want_p = jax.grad(loss, argnums=(0, 1))(jb.feats, tree["params"])
    feats = pb.feats.clone().requires_grad_()
    out = net(SparseBatch(pb.coords, feats, pb.mask, pb.n_events, plans=pb.plans))
    (out * torch.from_numpy(g)).sum().backward()
    mask = pb.mask.numpy()
    np.testing.assert_allclose(feats.grad.numpy()[mask], np.asarray(want_x)[mask], rtol=1e-4,
                               atol=1e-5)
    want = flax_to_state_dict(_flat({"params": want_p}))
    grads = {k: p.grad for k, p in net.named_parameters()}
    assert sorted(grads) == sorted(want)
    largest = max(float(v.abs().max()) for v in want.values())
    for k, v in want.items():
        if k == "l0.bias":
            # a conv bias before a BatchNorm: its gradient is rounding on
            # both sides, far below a trained one
            assert max(float(grads[k].abs().max()), float(v.abs().max())) <= 1e-5 * largest
            continue
        np.testing.assert_allclose(grads[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_row_stack_matches_the_grid_subm_convs(row_stack):
    """SCNet3D's sparse section in row space (K1's plain version over the
    27-tap plan) against the dense SubMConv3d stack on the grid, with the
    SubM weights carried over, at every occupied site (what chip_smoke.py
    holds on the card at full size)."""
    from waveformml_tpu_torch.ops.sparse_conv import SubMConv3d, batch_to_grid_3d

    net, pb = row_stack["net"], row_stack["pb"]
    net.eval()
    grid = batch_to_grid_3d(pb, T)
    convs = []
    for layer in (net.l0, net.l3):
        kk, cin, cout = layer.weight.shape
        conv = SubMConv3d(cin, cout, 3)
        with torch.no_grad():
            conv.conv.weight.copy_(layer.weight.detach().reshape(3, 3, 3, cin, cout)
                                   .permute(4, 3, 0, 1, 2))
            conv.conv.bias.copy_(layer.bias.detach())
        convs.append(conv)
    bn = net.l1
    with torch.no_grad():
        x = convs[0](grid)
        y = (x.features - bn.running_mean.view(1, -1, 1, 1, 1)) * torch.rsqrt(
            bn.running_var.view(1, -1, 1, 1, 1) + bn.eps) * bn.weight.view(1, -1, 1, 1, 1) \
            + bn.bias.view(1, -1, 1, 1, 1)
        x = x.with_features(torch.relu(y) * x.occupancy[:, None])
        want = convs[1](x).masked()
        got = net(pb)
    occ = grid.occupancy[:, None].expand_as(got)
    assert int(occ.sum()) > 0
    np.testing.assert_allclose(got[occ].numpy(), want[occ].numpy(), rtol=1e-4, atol=1e-5)
    assert float(got[~occ].abs().max()) == 0.0


# -- SCNet3D.json ------------------------------------------------------------------

@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = _scnet3d_config()
    block = _block(np.random.default_rng(11), 20)
    jt = _jax_trainer(d, block)
    flat = _redraw(jt, 12)
    path = str(tmp_path_factory.mktemp("scnet3d") / "epoch=0-val_loss=0.50.ckpt")
    jt.save_checkpoint(path)
    task = LitPSD(Config(copy.deepcopy(d)), device="cpu")
    task.model.load_state_dict(flax_to_state_dict(flat))
    return dict(d=d, jt=jt, flat=flat, path=path, block=block, task=task)


def test_scnet3d_forward_matches_jax(served):
    task, jt, block = served["task"], served["jt"], served["block"]
    db = task.prepare_block(block, task.row_bucket(block), task.event_bucket(block))
    jdb = _jax_db(jt, block)
    assert sorted(db) == sorted(jdb)
    for k in db:
        np.testing.assert_array_equal(db[k], np.asarray(jdb[k]), err_msg=k)
    variables = {"params": jt.state.params, "batch_stats": jt.state.batch_stats}
    want = np.asarray(jt.task.apply_model(variables, jdb, train=False)[0])
    got = task.apply_model(task.to_device(db)).numpy()
    assert got.shape == want.shape == (32, 2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    want, _ = jt.task.apply_model(variables, jdb, train=True)
    with torch.no_grad():
        got = copy.deepcopy(task).model_outputs(task.to_device(db), train=True).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


def test_scnet3d_inference_model_matches_jax(served):
    """``InferenceModel`` over a chunk of 4-column (x, y, t, event) coords:
    the real events' logits, against the JAX task's forward (the JAX
    ``InferenceModel`` packs 3-column coords only and cannot serve it)."""
    jt, block = served["jt"], served["block"]
    port = InferenceModel(Config(copy.deepcopy(served["d"])),
                          flax_to_state_dict(served["flat"]), device="cpu")
    got = port(block.coords, block.feats)
    variables = {"params": jt.state.params, "batch_stats": jt.state.batch_stats}
    want = np.asarray(jt.task.apply_model(variables, _jax_db(jt, block), train=False)[0])[:20]
    assert got.shape == want.shape == (20, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_scnet3d_weights_round_trip(served):
    """The conv3d kernel, flax [3, 3, 3, Cin, Cout], as torch's [Cout, Cin,
    3, 3, 3], and back."""
    state = flax_to_state_dict(served["flat"])
    assert tuple(state["sparse_model.layers_0.conv.weight"].shape) == (8, 2, 3, 3, 3)
    np.testing.assert_array_equal(
        state["sparse_model.layers_0.conv.weight"].numpy(),
        np.moveaxis(served["flat"]["params/sparse_model/layers_0/conv/kernel"], (-1, -2),
                    (0, 1)))
    own = served["task"].model.state_dict()
    assert sorted(state) == sorted(own)
    back = state_dict_to_flax(state)
    assert sorted(back) == sorted(served["flat"])
    for k, v in served["flat"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_row_stack_weights_round_trip(row_stack):
    """The 3D row kernels [27, Cin, Cout] cross as they are."""
    state = flax_to_state_dict(row_stack["flat"])
    np.testing.assert_array_equal(state["l0.weight"].numpy(),
                                  row_stack["flat"]["params/l0/kernel"])
    back = state_dict_to_flax(state)
    assert sorted(back) == sorted(row_stack["flat"])
    for k, v in row_stack["flat"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.fixture(scope="module")
def trajectory(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from waveformml_tpu import optim as wopt
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock

    d = _scnet3d_config()
    rng = np.random.default_rng(13)
    train = [_block(rng) for _ in range(STEPS)]
    val = [_block(rng)]
    jt = _jax_trainer(d, train[0])
    init = flax_to_state_dict({k: v for k, v in _flat(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats}).items()})
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
    return dict(trainer=trainer, metrics=metrics, jax_losses=jax_losses,
                jax_flat=_flat({"params": jt.state.params,
                                "batch_stats": jt.state.batch_stats}))


def test_scnet3d_training_losses_match_jax(trajectory):
    got = np.asarray(trajectory["trainer"].step_losses)
    want = np.asarray(trajectory["jax_losses"])
    assert got.shape == want.shape == (EPOCHS * STEPS,)
    np.testing.assert_allclose(got, want, rtol=TRAIN_RTOL, atol=TRAIN_ATOL)
    assert set(trajectory["metrics"]) == {"train_loss", "train_accuracy", "val_loss",
                                          "val_accuracy"}


def test_scnet3d_trained_weights_match_jax(trajectory):
    want = flax_to_state_dict(trajectory["jax_flat"])
    state = trajectory["trainer"].task.model.state_dict()
    assert sorted(want) == sorted(state)
    for k, v in want.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=1e-3, atol=1e-4,
                                   err_msg=k)


def test_cli_trains_scnet3d(tmp_path, capsys, monkeypatch):
    """``python -m waveformml_tpu_torch.main`` on SCNet3D.json at T = 4
    (``--device cpu --validate``, 1 epoch and a test) over in-memory 3D
    blocks: it no longer raises for ``3DConvolution``."""
    import ast
    import json
    import logging

    from waveformml_tpu_torch import main as cli

    d = _scnet3d_config()
    d["system_config"]["model_base_path"] = str(tmp_path / "model")
    path = tmp_path / "SCNet3D.json"
    path.write_text(json.dumps(d))
    rng = np.random.default_rng(14)
    blocks = [_block(rng) for _ in range(4)]
    monkeypatch.setattr(cli, "choose_data_module",
                        lambda config: BlockDataModule(blocks[:2], blocks[2:3], blocks[3:]))
    logger = logging.getLogger("waveformml_tpu_torch")
    saved = (list(logger.handlers), logger.level)
    try:
        assert cli.main([str(path), "--device", "cpu", "--max_epochs", "1", "-t",
                         "--validate"]) == 0
    finally:
        logger.handlers, logger.level = saved
    out = capsys.readouterr().out
    test = [ln for ln in out.splitlines() if ln.startswith("test: ")]
    assert len(test) == 1, out
    assert set(ast.literal_eval(test[0][6:])) == {"test_loss", "test_accuracy"}


def test_3d_blocks_are_sorted_time_rows():
    """``labelled_block_3d``: (x, y, t, event) rows sorted by (event, x, y,
    t), each pulse's rows where a PMT clears the threshold, two features."""
    block = _block(np.random.default_rng(15), 30)
    c = block.coords
    assert c.shape[1] == 4 and block.feats.shape == (c.shape[0], 2)
    assert block.labels.shape == (30,) and set(np.unique(block.labels)) <= {0, 1}
    order = np.lexsort((c[:, 2], c[:, 1], c[:, 0], c[:, 3]))
    np.testing.assert_array_equal(order, np.arange(c.shape[0]))
    assert c[:, 2].min() >= 0 and c[:, 2].max() < T
    assert np.unique(c[:, 3]).size == 30


# -- on the card --------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _card_case(cin, cout, n_events=1024, n_t=16):
    """A 3D plan [N, 27] over labelled 3D events at n_t samples, on the
    card, random masked features of width cin and a kernel [27, cin, cout]."""
    from waveformml_tpu_torch.ops.row_conv import host_neighbor_plan
    from waveformml_tpu_torch.ops.sparse import pad_sparse

    block = labelled_block_3d(np.random.default_rng(21), n_events, n_t)
    coords, _, mask = pad_sparse(block.coords, block.feats, block.coords.shape[0] + 37)
    plan = host_neighbor_plan(coords, mask, n_events, 3, n_t)
    gen = torch.Generator(device="cuda").manual_seed(cin)
    m = torch.from_numpy(mask).cuda()
    feats = torch.where(m[:, None], torch.randn(mask.shape[0], cin, device="cuda",
                                                generator=gen), 0.0).contiguous()
    kernel = torch.randn(27, cin, cout, device="cuda", generator=gen) / 27 ** 0.5
    bias = torch.randn(cout, device="cuda", generator=gen)
    return feats, torch.from_numpy(plan).cuda(), kernel, bias, m


@pytest.mark.cuda
def test_k1_at_27_taps_on_the_card(cuda):
    """K1 at SCNet3D's 2→8 over the 27-tap plan, and as d_feats 8→8 (the
    reversed, transposed kernel), against its plain version."""
    from waveformml_tpu_torch.ops.row_conv import (subm_conv_rows, subm_conv_rows_bwd_plain,
                                                   subm_conv_rows_plain, transposed_kernel)

    args = _card_case(2, 8)
    torch.testing.assert_close(subm_conv_rows(*args), subm_conv_rows_plain(*args),
                               rtol=1e-5, atol=1e-5)
    feats, plan, kernel, _, mask = _card_case(8, 8)
    g = torch.where(mask[:, None], torch.randn_like(feats), 0.0).contiguous()
    got = subm_conv_rows(g, plan, transposed_kernel(kernel), None, mask)
    want = subm_conv_rows_bwd_plain(feats, plan, kernel, mask, g)[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_k4_at_27_taps_on_the_card(cuda):
    """K4 at Cin + 1 = 3 (SCNet3D's first conv) and 9 over the 27-tap plan:
    each output within 1e-5 of the sum of its terms' magnitudes, bitwise
    equal over two runs."""
    from waveformml_tpu_torch.ops.row_conv import (subm_conv_rows_wgrad,
                                                   subm_conv_rows_wgrad_plain)

    for cin, cout in ((2, 8), (8, 8)):
        feats, plan, _, _, mask = _card_case(cin, cout)
        g = torch.where(mask[:, None], torch.randn(mask.shape[0], cout, device="cuda"),
                        0.0).contiguous()
        got = subm_conv_rows_wgrad(feats, plan, g, mask)
        again = subm_conv_rows_wgrad(feats, plan, g, mask)
        want = subm_conv_rows_wgrad_plain(feats, plan, g, mask)
        scale = subm_conv_rows_wgrad_plain(feats.abs(), plan, g.abs(), mask)
        for a, b, s, c in zip(got, want, scale, again):
            assert bool(((a - b).abs() <= 1e-5 * s + 1e-30).all())
            assert torch.equal(a, c)


def _shipped_on_card(n_events=4096, seed=31):
    """SCNet3D.json as shipped (T = 16) on the card from seeded weights, and
    a block of ``n_events`` labelled 3D events as a prepared device batch."""
    cfg = load_config(os.path.join(ROOT, "config", "examples", "SCNet3D.json"))
    torch.manual_seed(seed)
    task = LitPSD(cfg, device="cuda")
    block = labelled_block_3d(np.random.default_rng(seed), n_events,
                              cfg.system_config.n_samples)
    db = task.to_device(task.prepare_block(block, task.row_bucket(block),
                                           task.event_bucket(block)))
    return cfg, task, block, db


@pytest.mark.cuda
def test_plan_kernel_matches_its_plain_version(cuda):
    """The device plan's kernel against ``subm_conv_rows_plan_plain`` on
    the card, at K = 1, 3 and 5 over 4096 labelled 3D events with two rows
    at some sites (the batch's mask: both rows live) and over the grid's
    live rows; one launch counted a call."""
    from waveformml_tpu_torch.ops.row_conv import (device_site_table, subm_conv_rows_plan,
                                                   subm_conv_rows_plan_plain)
    from waveformml_tpu_torch.ops.sparse import bucket_size, flat_site_3d, pad_sparse
    from waveformml_tpu_torch.ops.sparse_conv import batch_to_grid_3d

    n_t = 16
    block = labelled_block_3d(np.random.default_rng(25), 4096, n_t)
    coords = np.concatenate([block.coords, block.coords[::97]])
    feats = np.concatenate([block.feats, block.feats[::97]])
    arrays = pad_sparse(coords, feats, bucket_size(coords.shape[0]))
    batch = SparseBatch(*(torch.from_numpy(a).cuda() for a in arrays), 4096)
    rows = batch_to_grid_3d(batch, n_t).rows
    assert int(rows.live.sum()) < int(batch.mask.sum())
    site = flat_site_3d(batch, n_t)
    for k in (1, 3, 5):
        for live in (batch.mask, rows.live):
            size = 4096 * NX * NY * n_t
            table = device_site_table(torch.where(live, site, size), size)
            before = subm_conv_rows_plan.launches
            got = subm_conv_rows_plan(site, live, table, k, n_t)
            assert subm_conv_rows_plan.launches == before + 1
            assert torch.equal(got, subm_conv_rows_plan_plain(site, live, table, k, n_t)), k
        assert torch.equal(rows.plan(k), got)


@pytest.mark.cuda
def test_subm_route_matches_the_dense_conv_at_4096_events(cuda):
    """SCNet3D.json's SubMConv3d 2→8 over a 4096-event grid on the card: the
    row route (K1, K4 over the device plan) against cuDNN's dense conv of
    the same module, the forward within K1's tolerance above and the
    weight and bias gradients, as K4's, within 1e-5 of the sum of their
    terms' magnitudes."""
    import dataclasses

    from waveformml_tpu_torch.ops.row_conv import subm_conv_rows, subm_conv_rows_wgrad
    from waveformml_tpu_torch.ops.sparse import bucket_size, pad_sparse
    from waveformml_tpu_torch.ops.sparse_conv import SubMConv3d, batch_to_grid_3d

    n_t = 16
    block = labelled_block_3d(np.random.default_rng(23), 4096, n_t)
    arrays = pad_sparse(block.coords, block.feats, bucket_size(block.coords.shape[0]))
    batch = SparseBatch(*(torch.from_numpy(a).cuda() for a in arrays), 4096)
    grid = batch_to_grid_3d(batch, n_t)
    gen = torch.Generator(device="cuda").manual_seed(24)
    conv = SubMConv3d(2, 8, 3, device="cuda")
    with torch.no_grad():
        conv.conv.weight.normal_(generator=gen)
        conv.conv.bias.normal_(generator=gen)
    g = torch.randn((4096, 8, NX, NY, n_t), device="cuda", generator=gen)

    def run(features, rows, grad):
        conv.zero_grad(set_to_none=True)
        out = conv(dataclasses.replace(grid, features=features, rows=rows)).features
        (out * grad).sum().backward()
        return out.detach(), conv.conv.weight.grad, conv.conv.bias.grad

    k1, k4 = subm_conv_rows.launches, subm_conv_rows_wgrad.launches
    got = run(grid.features, grid.rows, g)
    assert subm_conv_rows.launches > k1 and subm_conv_rows_wgrad.launches > k4
    want = run(grid.features, None, g)
    scale = run(grid.features.abs(), None, g.abs())
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    for a, b, s in zip(got[1:], want[1:], scale[1:]):
        assert bool(((a - b).abs() <= 1e-5 * s + 1e-30).all())


@pytest.mark.cuda
def test_scnet3d_training_step_makes_no_host_sync(cuda):
    """A training step of SCNet3D.json on the route (the device plan, K1,
    K4) asks the host to wait for nothing: ``set_sync_debug_mode("error")``
    raises at any synchronising call."""
    from waveformml_tpu_torch.ops.row_conv import subm_conv_rows_wgrad

    cfg, task, _, db = _shipped_on_card()
    trainer = Trainer(cfg, task, "cuda", callbacks=[], max_epochs=0)
    trainer.training_step(db)       # builds the libraries and cuDNN's plans
    torch.cuda.synchronize()
    k4 = subm_conv_rows_wgrad.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss, _ = trainer.training_step(db)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert subm_conv_rows_wgrad.launches > k4
    assert bool(torch.isfinite(loss))


@pytest.mark.cuda
def test_scnet3d_inference_model_captures_the_route(cuda):
    """``InferenceModel`` serving SCNet3D.json captures its forward, the
    device plan and K1 inside the graph, and its replays equal the eager
    forward."""
    cfg, task, block, db = _shipped_on_card(1000)
    model = InferenceModel(cfg, task.model.state_dict(), device="cuda")
    first = model.fetch(model.dispatch(block.coords, block.feats))
    again = model.fetch(model.dispatch(block.coords, block.feats))
    launches = model.replay_launches()
    assert len(model.graphs) == 1 and launches["subm_conv_rows"] >= 2
    # one plan a forward, as one K1 grid (the taps design)
    assert launches["subm_conv_rows_plan"] == launches["subm_conv_rows"]
    with torch.no_grad():
        want = task.apply_model(db)[:1000].cpu().numpy()
    np.testing.assert_array_equal(first, again)
    np.testing.assert_allclose(first, want, rtol=1e-5, atol=1e-6)
