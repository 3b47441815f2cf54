"""``SubMConv3d``'s row route: a 3D grid built from a batch carries its rows
(``GridRows``), and a SubM conv over it computes over the occupied sites
with ``SubMConvRows`` (K1 and K4; here their plain versions) on a K³-tap
plan built on the device (``subm_conv_rows_plan``), not the dense conv.

Held here: the device plan against ``host_neighbor_plan``; the route
against the dense route (the same module on the same grid without its rows)
at every site, forward and the weight, bias and input gradients, with rows
at the grid's edges, two rows at one site, padding rows and an event with
no rows; which grids take which route, as the counters ``grid.subm_rows``
and ``grid.subm_dense`` of a traced forward say; and SCNet3D.json's net on
the route with its parameters' names and shapes as they were, and its
export, which holds the route's ops."""
import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from waveformml_tpu_torch.config import Config, load_config, to_dict
from waveformml_tpu_torch.datasets.synthetic import labelled_block_3d
from waveformml_tpu_torch.ops.row_conv import (SubMConvRows, device_site_table,
                                               host_neighbor_plan, subm_conv_rows_plan)
from waveformml_tpu_torch.ops.sparse import SparseBatch, flat_site_3d, pad_sparse
from waveformml_tpu_torch.ops.sparse_conv import (MaskedBatchNorm, SparseConv3d,
                                                  SparseInverseConv3d, SparseReLU, SubMConv2d,
                                                  SubMConv3d, batch_to_grid, batch_to_grid_3d)
from waveformml_tpu_torch.utils import tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX, NY = 14, 11
T = 5
N_EVENTS = 6


def _batch(seed: int = 0, n_t: int = T) -> SparseBatch:
    """Random (x, y, t, event) rows of ``N_EVENTS`` events, event 3 left
    empty, with rows at every edge of the grid (x 0 and 13, y 0 and 10, t
    0 and T-1), three sites of two rows, and padding rows (coords 0, mask
    off) at the end."""
    rng = np.random.default_rng(seed)
    n = 90
    events = rng.choice([0, 1, 2, 4, 5], n)
    coords = np.stack([rng.integers(0, NX, n), rng.integers(0, NY, n), rng.integers(0, n_t, n),
                       events], 1)
    edges = np.array([[0, 5, 2, 0], [NX - 1, 5, 2, 0], [6, 0, 1, 1], [6, NY - 1, 1, 1],
                      [3, 4, 0, 2], [3, 4, n_t - 1, 2], [0, 0, 0, 5],
                      [NX - 1, NY - 1, n_t - 1, 5], [1, 0, n_t - 1, 4]])
    coords = np.concatenate([coords, edges, coords[[4, 17, 40]]]).astype(np.int32)
    coords = coords[np.argsort(coords[:, 3], kind="stable")]
    feats = rng.normal(size=(coords.shape[0], 2)).astype(np.float32)
    c, f, mask = pad_sparse(coords, feats, coords.shape[0] + 13)
    return SparseBatch(torch.from_numpy(c), torch.from_numpy(f), torch.from_numpy(mask),
                       N_EVENTS)


@pytest.fixture
def traced():
    """A CPU ``torch.profiler`` session, so that the tracer counts; yields
    a function that reads the counters."""
    tracing.clear()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        yield lambda: tracing.records()["counters"]
    finally:
        prof.stop()
        tracing.clear()


# -- the plan ----------------------------------------------------------------------

@pytest.mark.parametrize("k,n_t", [(1, 4), (3, 5), (3, 16), (5, 7)])
def test_device_plan_matches_host_plan(k, n_t):
    """The [N, K³] plan built on the device from the rows' flat sites
    equals ``host_neighbor_plan``'s, over the batch's mask (two rows at one
    site both convolve and name the last of them) and over the grid's live
    rows (each site's last row; the other rows get no taps)."""
    batch = _batch(k + n_t, n_t)
    coords, mask = batch.coords.numpy(), batch.mask.numpy()
    site = flat_site_3d(batch, n_t)
    table = device_site_table(site, N_EVENTS * NX * NY * n_t)
    got = subm_conv_rows_plan(site, batch.mask, table, k, n_t)
    assert got.dtype == torch.int32 and got.shape == (coords.shape[0], k ** 3)
    np.testing.assert_array_equal(got.numpy(), host_neighbor_plan(coords, mask, N_EVENTS, k,
                                                                  n_t))
    rows = batch_to_grid_3d(batch, n_t).rows
    live = rows.live.numpy()
    np.testing.assert_array_equal(rows.plan(k).numpy(),
                                  host_neighbor_plan(coords, live, N_EVENTS, k, n_t))
    assert rows.plan(k) is rows.plan(k)


def test_live_rows_are_one_a_site():
    """``live``: the last masked row of each occupied site, none of the
    padding; the occupancy is their sites."""
    batch = _batch(1)
    grid = batch_to_grid_3d(batch, T)
    c, mask = batch.coords.numpy(), batch.mask.numpy()
    want = np.zeros_like(mask)
    last = {}
    for r in range(c.shape[0]):
        if mask[r]:
            last[tuple(c[r])] = r
    want[list(last.values())] = True
    np.testing.assert_array_equal(grid.rows.live.numpy(), want)
    assert mask.sum() - want.sum() >= 3      # three sites of two rows at least
    occ = np.zeros((N_EVENTS, NX, NY, T), bool)
    for x, y, t, e in last:
        occ[e, x, y, t] = True
    np.testing.assert_array_equal(grid.occupancy.numpy(), occ)
    assert not occ[3].any()


# -- the route against the dense conv ----------------------------------------------

def _conv_both_ways(conv, grid, grad_input: bool):
    """The module over ``grid`` on the row route and on the dense route
    (its rows dropped): each side's output features and the gradients of
    Σ out·g for the weight, the bias and (``grad_input``) the input."""
    g = torch.randn((grid.features.shape[0], conv.conv.weight.shape[0])
                    + tuple(grid.features.shape[2:]), generator=torch.Generator().manual_seed(5))
    results = []
    for rows in (grid.rows, None):
        mod = copy.deepcopy(conv)
        x = grid.features.detach().clone().requires_grad_(grad_input)
        out = mod(dataclasses.replace(grid, features=x, rows=rows)).features
        (out * g).sum().backward()
        results.append((out.detach(), mod.conv.weight.grad,
                        mod.conv.bias.grad if mod.conv.bias is not None else None,
                        x.grad))
    return results


@pytest.mark.parametrize("k,cin,cout,use_bias,grad_input",
                         [(3, 2, 8, True, False), (3, 8, 5, True, True),
                          (3, 3, 4, False, True), (5, 2, 3, True, True),
                          (1, 4, 2, True, True)])
def test_route_matches_the_dense_conv(k, cin, cout, use_bias, grad_input, traced,
                                      monkeypatch):
    apply = SubMConvRows.apply

    def contiguous_operands(*args):
        # what K1 and K4 take on the card
        assert all(a.is_contiguous() for a in args if isinstance(a, torch.Tensor))
        return apply(*args)

    monkeypatch.setattr(SubMConvRows, "apply", contiguous_operands)
    batch = _batch(k * 10 + cin)
    feats = torch.randn(batch.feats.shape[0], cin, generator=torch.Generator().manual_seed(cin))
    grid = batch_to_grid_3d(batch, T, feats)
    conv = SubMConv3d(cin, cout, k, use_bias=use_bias,
                      generator=torch.Generator().manual_seed(k + cout))
    if use_bias:
        with torch.no_grad():
            conv.conv.bias.normal_(generator=torch.Generator().manual_seed(3))
    (out, dw, db, dx), (out_d, dw_d, db_d, dx_d) = _conv_both_ways(conv, grid, grad_input)
    assert traced() == {"grid.subm_rows": 1, "grid.subm_dense": 1}
    assert out.shape == out_d.shape == (N_EVENTS, cout, NX, NY, T)
    # the same channels-last layout as the dense route's output
    assert out.stride() == out_d.stride()
    torch.testing.assert_close(out, out_d, rtol=1e-5, atol=1e-6)
    assert float(out[~grid.occupancy[:, None].expand_as(out)].abs().max()) == 0.0
    assert float(out[3].abs().max()) == 0.0
    # the rows at one site: the site's sum convolves once
    torch.testing.assert_close(dw, dw_d, rtol=1e-5, atol=1e-5)
    if use_bias:
        torch.testing.assert_close(db, db_d, rtol=1e-5, atol=1e-5)
    else:
        assert db is None and db_d is None
    if grad_input:
        torch.testing.assert_close(dx, dx_d, rtol=1e-5, atol=1e-6)
    else:
        assert dx is None and dx_d is None


def test_a_stack_shares_one_plan(traced):
    """SubM → BatchNorm → ReLU → SubM keeps the rows (``with_features``):
    both convs take the route over one plan, built once, and the stack
    matches the dense one."""
    batch = _batch(2)
    gen = torch.Generator().manual_seed(7)
    stack = torch.nn.Sequential(SubMConv3d(2, 6, 3, generator=gen), MaskedBatchNorm(6),
                                SparseReLU(), SubMConv3d(6, 4, 3, generator=gen))
    grid = batch_to_grid_3d(batch, T)
    got = grid
    for layer in stack:
        got = layer(got)
    assert got.rows is grid.rows and list(grid.rows.plans) == [3]
    want = dataclasses.replace(grid, rows=None)
    for layer in stack:
        want = layer(want)
    assert traced() == {"grid.subm_rows": 2, "grid.subm_dense": 2}
    torch.testing.assert_close(got.features, want.features, rtol=1e-5, atol=1e-6)


# -- which grids take the dense route -----------------------------------------------

def test_grids_without_rows_take_the_dense_route(traced):
    """A grid after a regular or an inverse sparse conv (their occupancy is
    not the rows'), a 2D grid and a bf16 grid run the dense conv."""
    batch = _batch(3)
    gen = torch.Generator().manual_seed(9)
    grid = batch_to_grid_3d(batch, T)
    down = SparseConv3d(2, 2, 3, 1, 1, indice_key="k", generator=gen)(grid)
    assert down.rows is None
    SubMConv3d(2, 3, 3, generator=gen)(down)
    assert traced() == {"grid.subm_dense": 1}
    up = SparseInverseConv3d(2, 2, 3, indice_key="k", generator=gen)(down)
    assert up.rows is None
    SubMConv3d(2, 3, 3, generator=gen)(up)
    assert traced() == {"grid.subm_dense": 2}
    coords2d = batch.coords[:, [0, 1, 3]].clamp(max=NY - 1)
    flat = batch_to_grid(SparseBatch(coords2d, batch.feats, batch.mask, N_EVENTS))
    assert flat.rows is None
    SubMConv2d(2, 3, 3, generator=gen)(flat)
    assert traced() == {"grid.subm_dense": 3}
    half = batch_to_grid_3d(batch, T, batch.feats.to(torch.bfloat16))
    assert half.rows is not None
    out = SubMConv3d(2, 3, 3, generator=gen)(half)
    assert out.features.dtype == torch.bfloat16 and out.rows is half.rows
    assert traced() == {"grid.subm_dense": 4}
    SubMConv3d(2, 3, 3, dilation=2, generator=gen)(grid)
    assert traced() == {"grid.subm_dense": 5}
    SubMConv3d(2, 3, 3, generator=gen)(grid)
    assert traced() == {"grid.subm_dense": 5, "grid.subm_rows": 1}


# -- SCNet3D.json ------------------------------------------------------------------

def _scnet3d(n_t: int = 4):
    """SCNet3D.json at ``n_t`` samples on the CPU from seeded weights (its
    head's width follows), and a prepared batch of 24 labelled 3D events:
    (config, task, block, device batch)."""
    from waveformml_tpu_torch.engineering.tasks import LitPSD

    d = to_dict(load_config(os.path.join(ROOT, "config", "examples", "SCNet3D.json")))
    d["system_config"]["n_samples"] = n_t
    alg = d["net_config"]["algorithm"]
    alg[alg.index("nn.Linear") + 1] = [8 * NX * NY * n_t, 32]
    cfg = Config(d)
    torch.manual_seed(0)
    task = LitPSD(cfg, device="cpu")
    block = labelled_block_3d(np.random.default_rng(4), 24, n_t)
    db = task.to_device(task.prepare_block(block, task.row_bucket(block),
                                           task.event_bucket(block)))
    return cfg, task, block, db


def test_scnet3d_takes_the_route_with_its_parameters_as_they_were(traced):
    """SCNet3D.json (T = 4): its one SubM conv takes the route in the
    forward; its weight keeps its name and [8, 2, 3, 3, 3] shape, autograd
    reaching it through the tap layout; no plan is asked of the host; the
    logits and every gradient equal the dense route's."""
    _, task, _, db = _scnet3d()
    assert task.model.plan_requirements() == set()
    weight = task.model.state_dict()["sparse_model.layers_0.conv.weight"]
    assert tuple(weight.shape) == (8, 2, 3, 3, 3)

    def run(route: bool):
        t = copy.deepcopy(task)
        conv = t.model.sparse_model.layers_0
        if not route:
            forward = conv.forward
            conv.forward = lambda g, gen=None: forward(dataclasses.replace(g, rows=None), gen)
        out = t.model_outputs(db, train=True)
        out.square().sum().backward()
        return out.detach(), {k: p.grad for k, p in t.model.named_parameters()}

    out, grads = run(True)
    assert traced() == {"grid.subm_rows": 1}
    out_d, grads_d = run(False)
    assert traced() == {"grid.subm_rows": 1, "grid.subm_dense": 1}
    torch.testing.assert_close(out, out_d, rtol=1e-5, atol=1e-6)
    assert sorted(grads) == sorted(grads_d)
    largest = max(float(v.abs().max()) for v in grads_d.values())
    for k in grads:
        if k == "sparse_model.layers_0.conv.bias":
            # a conv bias before a BatchNorm: its gradient is rounding on
            # both routes, far below a trained one
            assert max(float(grads[k].abs().max()), float(grads_d[k].abs().max())) \
                <= 1e-5 * largest
            continue
        scale = float(grads_d[k].abs().max())
        torch.testing.assert_close(grads[k], grads_d[k], rtol=1e-4, atol=1e-5 * scale,
                                   msg=lambda m, k=k: f"{k}: {m}")


def test_scnet3d_export_holds_the_route(tmp_path):
    """``Trainer.export_model`` of SCNet3D.json (T = 4): the program's one
    custom-op node is the plan kernel's (off the card ``SubMConvRows`` runs
    K1's plain version, which the graph holds as its aten ops; on the card
    K1's node joins it), and the reloaded program gives the eager
    forward's outputs."""
    from waveformml_tpu_torch.engineering.trainer import Trainer, load_exported

    cfg, task, block, db = _scnet3d()
    trainer = Trainer(cfg, task, "cpu", callbacks=[], max_epochs=0)
    path = trainer.export_model(str(tmp_path / "model.pt2"), block)
    program = torch.export.load(path)
    ops = sorted(str(n.target) for n in program.graph.nodes
                 if n.op == "call_function" and str(n.target).startswith("waveformml."))
    assert ops == ["waveformml.subm_conv_rows_plan.default"], ops
    batch = trainer.device_batch(block)[0]
    with torch.no_grad():
        want = task.apply_model(batch)
    torch.testing.assert_close(load_exported(path, "cpu")(batch), want, rtol=1e-6, atol=1e-6)
