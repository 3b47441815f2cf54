"""The port's host edge construction and graph device ops against the JAX
package: ``knn_graph`` and ``window_edges`` (the port's C++ build and its
numpy plain versions) against the JAX package's C++ build on integer grid
positions with events of 20-40 rows, where equal distances are the rule:
equal edge lists, in order (the lower row index first among equal
distances, as ``std::partial_sort`` over ``(distance, j)`` orders them); a
failed C++ build raises ``KernelError``; ``pad_edges`` and
``cartesian_edge_attr`` (local and global), on the host and on the
device; the segment ops, ``edge_softmax``, ``_sym_norm``,
``add_self_loops`` and the pools, with empty nodes and masked edges,
against the JAX functions (float32, rtol 1e-6, atol 1e-6)."""
import numpy as np
import pytest
import torch

from waveformml_tpu_torch.ops import graph, native

RTOL, ATOL = 1e-6, 1e-6


def _grid_events(seed, n_events=6, lo=20, hi=41, grid=(14, 11)):
    """Integer detector cells, events of lo..hi-1 rows (sorted by event)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lo, hi, n_events)
    batch = np.repeat(np.arange(n_events), sizes).astype(np.int64)
    pos = np.stack([rng.integers(0, grid[0], batch.size),
                    rng.integers(0, grid[1], batch.size)], 1).astype(np.int64)
    return pos, batch


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k,loop", [(1, True), (4, False), (6, False), (12, True)])
def test_knn_graph_matches_the_jax_build_with_ties(seed, k, loop):
    from waveformml_tpu.ops import graph as jgraph

    assert jgraph._get_lib() is not None, "the JAX package's C++ build did not load"
    pos, batch = _grid_events(seed)
    want = jgraph.knn_graph(pos.astype(np.float64), k, batch, loop=loop)
    got = graph.knn_graph(pos.astype(np.float64), k, batch, loop=loop)
    plain = graph.knn_graph_numpy(pos, k, batch, loop=loop)
    assert got.dtype == plain.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)
    # ties are really there: row 0 sees rows of its event at equal distances
    row = ((pos[batch == 0] - pos[0]) ** 2).sum(-1)
    assert np.unique(row).size < row.size


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("max_dist,self_loops", [(1, True), (1, False), (2, True)])
def test_window_edges_match_the_jax_build(seed, max_dist, self_loops):
    from waveformml_tpu.ops import graph as jgraph

    pos, batch = _grid_events(seed + 10)
    want = jgraph.window_edges(pos, batch, max_dist=max_dist, self_loops=self_loops)
    got = graph.window_edges(pos, batch, max_dist=max_dist, self_loops=self_loops)
    plain = graph.window_edges_numpy(pos, batch, max_dist=max_dist, self_loops=self_loops)
    assert want.shape[1] > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plain, want)


def test_empty_and_small_inputs():
    empty = np.zeros((0, 2), np.int64)
    for fn in (graph.window_edges, graph.window_edges_numpy):
        assert fn(empty, np.zeros(0, np.int64)).shape == (2, 0)
    for fn in (graph.knn_graph, graph.knn_graph_numpy):
        assert fn(empty.astype(float), 3, np.zeros(0, np.int64)).shape == (2, 0)
        # k beyond the event's peers: fewer edges; a lone row none
        edges = fn(np.array([[0.0, 0.0], [1.0, 0.0], [5.0, 5.0]]), 6, np.array([0, 0, 1]))
        np.testing.assert_array_equal(edges, [[1, 0], [0, 1]])


def test_failed_build_raises(tmp_path, monkeypatch):
    """No g++, or a source that does not compile: ``KernelError``, and no
    other version runs in its place."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    pos, batch = _grid_events(0, n_events=2)
    with pytest.raises(native.KernelError, match="g.. not found"):
        graph.window_edges(pos, batch)
    monkeypatch.undo()
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "window_edges.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CSRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIBS", {})
    with pytest.raises(native.KernelError, match="g\\+\\+ exited"):
        graph.knn_graph(pos.astype(float), 4, batch)
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_library_builds_into_the_ports_build_dir():
    graph.library()
    path = native.host_library_path("window_edges")
    assert path.exists() and path.parent == native.BUILD_DIR
    assert "waveformml_tpu_torch" in str(path) and "_native" not in str(path)


def test_pad_edges_matches_jax():
    from waveformml_tpu.ops.graph import pad_edges as jpad

    edges = np.array([[0, 1, 2], [1, 0, 1]])
    attr = np.arange(6, dtype=np.float32).reshape(3, 2)
    for got, want in zip(graph.pad_edges(edges, 8, attr), jpad(edges, 8, attr)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    e, m = graph.pad_edges(edges, 4)
    assert e.shape == (2, 4) and m.tolist() == [True, True, True, False]
    with pytest.raises(ValueError):
        graph.pad_edges(edges, 2)


@pytest.mark.parametrize("local,norm,max_value", [(False, True, None), (False, True, 3.0),
                                                  (False, False, None), (True, True, None)])
def test_cartesian_edge_attr_matches_jax(local, norm, max_value):
    """On the host (``ops.graph``) and on the device (``_cartesian`` of
    ``models.graph_net``, over padded slots as the JAX model runs it)."""
    import jax.numpy as jnp

    from waveformml_tpu.models.graph_net import _cartesian as jcart
    from waveformml_tpu.ops.graph import cartesian_edge_attr as jattr
    from waveformml_tpu_torch.models.graph_net import _cartesian

    pos, batch = _grid_events(3, n_events=3)
    edges = graph.knn_graph(pos.astype(float), 4, batch)
    want = jattr(pos.astype(np.float64), edges, local=local, norm=norm, max_value=max_value)
    got = graph.cartesian_edge_attr(pos.astype(np.float64), edges, local=local, norm=norm,
                                    max_value=max_value)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    padded, _ = graph.pad_edges(edges, edges.shape[1] + 7)
    posf = pos.astype(np.float32)
    want = np.asarray(jcart(jnp.asarray(posf), jnp.asarray(padded), local=local, norm=norm,
                            max_value=max_value))
    got = _cartesian(torch.from_numpy(posf), torch.from_numpy(padded), local=local, norm=norm,
                     max_value=max_value).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _segment_case(seed, width=(3,)):
    """Messages to 9 nodes, nodes 4 and 7 without an incoming edge, a
    quarter of the edges masked (padding), node 8 reached by masked edges
    only."""
    rng = np.random.default_rng(seed)
    targets = rng.choice([0, 1, 2, 3, 5, 6], 40).astype(np.int64)
    targets[-4:] = 8
    mask = rng.random(40) > 0.25
    mask[-4:] = False
    msg = rng.normal(size=(40,) + width).astype(np.float32)
    return msg, targets, mask


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean", "segment_max", "edge_softmax",
                                "global_max_pool", "global_mean_pool"])
@pytest.mark.parametrize("masked", [True, False])
def test_segment_ops_match_jax(op, masked):
    import jax.numpy as jnp

    from waveformml_tpu.models import graph_layers as jl
    from waveformml_tpu_torch.models import graph_layers as tl

    msg, targets, mask = _segment_case(7)
    want = np.asarray(getattr(jl, op)(jnp.asarray(msg), jnp.asarray(targets), 9,
                                      jnp.asarray(mask) if masked else None))
    got = getattr(tl, op)(torch.from_numpy(msg), torch.from_numpy(targets), 9,
                          torch.from_numpy(mask) if masked else None).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if op in ("segment_sum", "segment_mean", "segment_max", "global_max_pool"):
        # the empty nodes (and under the mask the masked-only node) get 0
        empty = [4, 7, 8] if masked else [4, 7]
        assert not got[empty].any()


def test_segment_ops_take_int32_targets_and_keep_gradients():
    import jax
    import jax.numpy as jnp

    from waveformml_tpu.models import graph_layers as jl
    from waveformml_tpu_torch.models import graph_layers as tl

    msg, targets, mask = _segment_case(8, width=(2,))
    weights = np.random.default_rng(9).normal(size=(9, 2)).astype(np.float32)

    def jloss(m):
        return sum((f(m, jnp.asarray(targets, jnp.int32), 9, jnp.asarray(mask))
                    * weights).sum() for f in (jl.segment_sum, jl.segment_mean, jl.segment_max))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(msg)))
    m = torch.from_numpy(msg).requires_grad_(True)
    t32 = torch.from_numpy(targets).to(torch.int32)
    loss = sum((f(m, t32, 9, torch.from_numpy(mask)) * torch.from_numpy(weights)).sum()
               for f in (tl.segment_sum, tl.segment_mean, tl.segment_max))
    loss.backward()
    np.testing.assert_allclose(m.grad.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weighted", [True, False])
def test_sym_norm_and_self_loops_match_jax(weighted):
    import jax.numpy as jnp

    from waveformml_tpu.models import graph_layers as jl
    from waveformml_tpu_torch.models import graph_layers as tl

    rng = np.random.default_rng(4)
    edges = np.stack([rng.integers(0, 7, 30), rng.integers(0, 7, 30)]).astype(np.int64)
    edges[:, :3] = [[2, 5, 6], [2, 5, 6]]          # the input's own loops
    mask = rng.random(30) > 0.2
    w = rng.random(30).astype(np.float32) if weighted else None
    je, jm, jw = jl.add_self_loops(jnp.asarray(edges), jnp.asarray(mask), 8,
                                   None if w is None else jnp.asarray(w))
    te, tm, tw = tl.add_self_loops(torch.from_numpy(edges), torch.from_numpy(mask), 8,
                                   None if w is None else torch.from_numpy(w))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (tw is None) == (jw is None)
    if w is not None:
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw))
    # one live loop per node, the input's own masked
    live = te.numpy()[:, tm.numpy()]
    assert sorted(live[0][live[0] == live[1]].tolist()) == list(range(8))
    want = np.asarray(jl._sym_norm(je, jm, 8, jw))
    got = tl._sym_norm(te, tm, 8, tw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
