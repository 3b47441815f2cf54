"""The port's graph convs against the JAX package's: each of the 18 convs
of ``GRAPH_CONV_BY_INDEX`` and ``GINEConv``, built by ``_make_conv`` as
the nets build them, from the same flax weights (every leaf redrawn,
carried by ``convert.py``), on a graph whose padding edges are masked and
carry junk: the forward (rtol 1e-5, atol 1e-6) and the gradients of a
weighted sum of it with respect to the features and every parameter
(rtol 1e-4, atol 1e-5); and the golden values of
tests/test_graph_layers_golden.py (the numpy oracles of the PyG formulas
on its fixed 4-node graph, with the parameters that test pins) as
expected numbers, atol 1e-5 as there."""
import numpy as np
import pytest
import torch

from waveformml_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from waveformml_tpu_torch.models import graph_layers as tl
from waveformml_tpu_torch.models.graph_net import _make_conv

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
N_NODES, F_IN, F_OUT = 12, 6, 4
CASES = list(range(18)) + ["GINE"]


def _flat(variables):
    import jax
    from flax.traverse_util import flatten_dict

    return {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(variables),
                                                        sep="/").items()}


def _tree(flat):
    import jax.numpy as jnp
    from flax.traverse_util import unflatten_dict

    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})


def _graph(seed):
    """A ring over N_NODES with both directions, a few chords, and four
    masked padding edges with junk attributes."""
    rng = np.random.default_rng(seed)
    i = np.arange(N_NODES)
    live = np.concatenate([np.stack([i, (i + 1) % N_NODES]), np.stack([(i + 1) % N_NODES, i]),
                           np.array([[0, 3, 7], [5, 9, 2]])], axis=1)
    junk = np.array([[0, 0, 4, 11], [0, 6, 9, 1]])
    edges = np.concatenate([live, junk], axis=1).astype(np.int64)
    mask = np.r_[np.ones(live.shape[1], bool), np.zeros(junk.shape[1], bool)]
    attr = rng.random((edges.shape[1], 2)).astype(np.float32)
    attr[~mask] = 99.0
    x = rng.normal(size=(N_NODES, F_IN)).astype(np.float32)
    return x, edges, mask, attr


def _convs(case):
    """(the JAX conv, the port's conv) of a case."""
    from waveformml_tpu.models import graph_layers as jl
    from waveformml_tpu.models import graph_net as jn

    if case == "GINE":
        return (jl.GINEConv(jn._GraphMLP((F_IN, F_OUT)), edge_dim=2),
                tl.GINEConv(tl._GraphMLP((F_IN, F_OUT)), F_IN, edge_dim=2))
    return (jn._make_conv(case, F_IN, F_OUT, {}, kernel=3),
            _make_conv(case, F_IN, F_OUT, {}, kernel=3, edge_dim=2))


@pytest.fixture(scope="module", params=CASES)
def conv_case(request):
    import jax
    import jax.numpy as jnp

    case = request.param
    x, edges, mask, attr = _graph(5)
    jconv, tconv = _convs(case)
    args = (jnp.asarray(x), jnp.asarray(edges), jnp.asarray(mask))
    v = jconv.init(jax.random.PRNGKey(0), *args, edge_attr=jnp.asarray(attr))
    rng = np.random.default_rng(6)
    flat = {k: rng.uniform(-1, 1, a.shape).astype(np.float32) for k, a in _flat(v).items()}
    state = flax_to_state_dict(flat)
    assert sorted(state) == sorted(tconv.state_dict()), (sorted(state),
                                                        sorted(tconv.state_dict()))
    tconv.load_state_dict(state)
    return dict(case=case, jconv=jconv, tconv=tconv, flat=flat, x=x, edges=edges, mask=mask,
                attr=attr)


def test_conv_forward_matches_jax(conv_case):
    import jax.numpy as jnp

    c = conv_case
    want = np.asarray(c["jconv"].apply(_tree(c["flat"]), jnp.asarray(c["x"]),
                                       jnp.asarray(c["edges"]), jnp.asarray(c["mask"]),
                                       edge_attr=jnp.asarray(c["attr"])))
    with torch.no_grad():
        got = c["tconv"](torch.from_numpy(c["x"]), torch.from_numpy(c["edges"]),
                         torch.from_numpy(c["mask"]), torch.from_numpy(c["attr"])).numpy()
    assert got.shape == want.shape and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the masked padding edges, junk attributes and all, change nothing
    live = c["mask"]
    with torch.no_grad():
        alone = c["tconv"](torch.from_numpy(c["x"]), torch.from_numpy(c["edges"][:, live]),
                           torch.from_numpy(live[live]),
                           torch.from_numpy(c["attr"][live])).numpy()
    np.testing.assert_allclose(alone, got, rtol=RTOL, atol=ATOL)


def test_conv_gradients_match_jax(conv_case):
    """d/d(features, parameters) of sum(out · R), R fixed."""
    import jax
    import jax.numpy as jnp

    c = conv_case
    r = np.random.default_rng(7).normal(size=(N_NODES, F_OUT)).astype(np.float32)

    def loss(params, x):
        out = c["jconv"].apply({"params": params}, x, jnp.asarray(c["edges"]),
                               jnp.asarray(c["mask"]), edge_attr=jnp.asarray(c["attr"]))
        return (out * r).sum()

    params = _tree(c["flat"])["params"]
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(c["x"]))
    x = torch.from_numpy(c["x"]).requires_grad_(True)
    conv = c["tconv"]
    conv.zero_grad()
    out = conv(x, torch.from_numpy(c["edges"]), torch.from_numpy(c["mask"]),
               torch.from_numpy(c["attr"]))
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    got = state_dict_to_flax({k: p.grad for k, p in conv.named_parameters()})
    want = _flat({"params": gp})
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)


# -- the golden values ---------------------------------------------------------------------

#: each golden test's oracle output on its fixed graph (float64, rounded to
#: 1e-8), as tests/test_graph_layers_golden.py computes it
GOLDEN = {
    "arma": [[0.0, 1.26863688], [0.0, 0.0], [0.0, 0.0], [0.0, 2.33298719]],
    "clustergcn": [[-1.23961168, -2.80358676], [-1.31569896, -0.67898857],
                   [-1.77704673, -0.29174782], [-2.29964451, 0.03794748]],
    "edgeconv": [[-1.90060627, -1.41438317], [0.06025296, -2.22674394],
                 [0.67540717, 3.58271074], [-3.91246247, -1.52125049]],
    "feast": [[-1.41927385, 0.5131421], [-0.69775949, 0.2189942],
              [-0.53854406, -0.05944068], [0.30185657, -0.91267339]],
    "film": [[4.08462763, 0.0], [2.12496996, 4.86867332], [1.55793762, 1.04400456],
             [1.39947045, 0.38041627]],
    "gat": [[-1.95202708, -0.03577226], [-1.52142131, 0.27358067],
            [-1.14268994, 0.71373767], [-0.28299347, 1.39402306]],
    "gatv2": [[-1.92411995, -0.88428962], [-1.3279599, -0.49017757],
              [-1.77405417, -0.6373713], [-0.80940878, 0.01164681]],
    "gcn": [[-0.97137752, -1.74444625], [-1.43592723, -0.79346119],
            [-1.62572084, -1.1256623], [-1.76289602, 0.15167333]],
    "gen": [[-1.63782239, 1.31365526], [-1.095209, 0.83375371], [-0.74722111, -0.53142363],
            [-0.92037761, 0.67691123]],
    "gin": [[-1.37129505, -4.48227406], [-2.68459278, -1.7022364],
            [-4.17780372, -2.03718941], [-3.53665067, 0.57323191]],
    "gine": [[2.49754203, 1.74680003], [2.08686326, 1.09060553], [2.23441879, -0.20416314],
             [0.69235226, -0.49296214]],
    "gmm": [[-1.4717983, -0.59929669], [-1.52894056, 1.73572958], [0.50701594, -2.33985829],
            [-0.24097419, 0.31104317]],
    "graphconv": [[1.1210883, -1.54774665], [-0.68601022, 1.12602873],
                  [-2.94950194, -1.25651429], [1.21984169, -2.27222206]],
    "le": [[-3.89276958, -1.17561185], [0.43793124, -0.6430831], [-2.09187698, 2.03819466],
           [-1.37244606, -2.72856402]],
    "sage": [[1.17689204, -1.63070703], [-0.95981169, 0.28343755],
             [-2.93861628, -2.42922544], [-1.93827701, 1.66316652]],
    "sgconv": [[-1.14006223, -1.19628485], [-1.32203427, -1.30156131],
               [-1.60507692, -1.0732434], [-1.5650164, -0.32235656]],
    "supergat_inference": [[-1.95202708, -0.03577226], [-1.52142131, 0.27358067],
                           [-1.14268994, 0.71373767], [-0.28299347, 1.39402306]],
    "tag": [[0.06969525, -2.46303194], [-0.56874722, -1.02842024], [-0.1756096, 1.60636162],
            [-2.51525182, -1.30134474]],
    "transformer": [[-0.40724468, -1.67400485], [-0.28991261, -2.01686819],
                    [-0.61568579, -0.18530225], [1.864483, -3.42921495]],
}


class _Lin(torch.nn.Module):
    """The golden tests' net: one Dense ``d``."""

    def __init__(self, nin, nout):
        super().__init__()
        self.d = torch.nn.Linear(nin, nout)

    def forward(self, z):
        return self.d(z)


def _golden_layers(name):
    """(the JAX layer as the golden test builds it, the port's, whether it
    takes the edge attributes)."""
    import flax.linen as fnn

    from waveformml_tpu.models import graph_layers as jl

    class _JLin(fnn.Module):
        feat: int

        @fnn.compact
        def __call__(self, z, train=False):
            return fnn.Dense(self.feat, name="d")(z)

    fi, fo = 3, 2
    table = {
        "gcn": (jl.GCNConv(fi, fo), tl.GCNConv(fi, fo), False),
        "sage": (jl.SAGEConv(fi, fo), tl.SAGEConv(fi, fo), False),
        "gat": (jl.GATConv(fi, fo), tl.GATConv(fi, fo), False),
        "gmm": (jl.GMMConv(fi, fo, dim=2, kernel_size=3), tl.GMMConv(fi, fo, dim=2,
                                                                      kernel_size=3), True),
        "gen": (jl.GENConv(fi, fo), tl.GENConv(fi, fo, edge_dim=2), True),
        "edgeconv": (jl.EdgeConv(net=_JLin(fo)), tl.EdgeConv(_Lin(2 * fi, fo)), False),
        "sgconv": (jl.SGConv(fi, fo, K=2), tl.SGConv(fi, fo, K=2), False),
        "graphconv": (jl.GraphConv(fi, fo), tl.GraphConv(fi, fo), True),
        "gatv2": (jl.GATv2Conv(fi, fo), tl.GATv2Conv(fi, fo), False),
        "transformer": (jl.TransformerConv(fi, fo, edge_dim=2),
                        tl.TransformerConv(fi, fo, edge_dim=2), True),
        "tag": (jl.TAGConv(fi, fo, K=2), tl.TAGConv(fi, fo, K=2), False),
        "gin": (jl.GINConv(net=_JLin(fo), eps=0.3), tl.GINConv(_Lin(fi, fo), eps=0.3), False),
        "gine": (jl.GINEConv(net=_JLin(fo), edge_dim=2, eps=0.1),
                 tl.GINEConv(_Lin(fi, fo), fi, edge_dim=2, eps=0.1), True),
        "arma": (jl.ARMAConv(fi, fo, num_layers=1), tl.ARMAConv(fi, fo, num_layers=1), False),
        "film": (jl.FiLMConv(fi, fo), tl.FiLMConv(fi, fo), False),
        "feast": (jl.FeaStConv(fi, fo, heads=2), tl.FeaStConv(fi, fo, heads=2), False),
        "le": (jl.LEConv(fi, fo), tl.LEConv(fi, fo), True),
        "clustergcn": (jl.ClusterGCNConv(fi, fo, diag_lambda=0.7),
                       tl.ClusterGCNConv(fi, fo, diag_lambda=0.7), False),
        "supergat_inference": (jl.SuperGATConv(fi, fo), tl.SuperGATConv(fi, fo), False),
    }
    return table[name]


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_conv_golden_values(name):
    import jax
    import jax.numpy as jnp

    from test_graph_layers_golden import EDGE_ATTR, EDGES, X, _pin, _with_junk

    jconv, tconv, uses_attr = _golden_layers(name)
    e, mask, attr = _with_junk(EDGES, EDGE_ATTR if uses_attr else None)
    kw = {"edge_attr": jnp.asarray(attr)} if uses_attr else {}
    v = _pin(jconv.init(jax.random.PRNGKey(0), jnp.asarray(X), jnp.asarray(e),
                        jnp.asarray(mask), **kw))
    flat = _flat(v)
    # the golden nets' Dense "d" is not a conv's name: [in, out] → [out, in]
    state = flax_to_state_dict({k: (a.T if k.endswith("/d/kernel") else a)
                                for k, a in flat.items()})
    tconv.load_state_dict(state)
    with torch.no_grad():
        got = tconv(torch.from_numpy(X), torch.from_numpy(e.astype(np.int64)),
                    torch.from_numpy(mask),
                    torch.from_numpy(attr) if uses_attr else None).numpy()
    np.testing.assert_allclose(got, np.asarray(GOLDEN[name]), rtol=0, atol=1e-5)


def test_conv_table_and_helpers_match_jax():
    from waveformml_tpu.models import graph_layers as jl

    assert [c.__name__ for c in tl.GRAPH_CONV_BY_INDEX] == [
        c.__name__ for c in jl.GRAPH_CONV_BY_INDEX]
    for i in range(18):
        assert tl.class_needs_nn(i) == jl.class_needs_nn(i)
        assert tl.needs_edge_attr(i) == jl.needs_edge_attr(i)
        for layer in (0, 1):
            for gp in (None, {"heads": 3}):
                assert tl.nn_input_modifier(i, layer, gp) == jl.nn_input_modifier(i, layer, gp)
