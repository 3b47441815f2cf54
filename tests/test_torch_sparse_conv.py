"""The port's dense-grid ops (waveformml_tpu_torch/ops/sparse_conv.py and
the grid helpers of ops/sparse.py, ops/row_conv.py) against the JAX
package's, on the same seeded batches and weights (converted by
``convert.py``): features within 1e-5 in float32, occupancies exact. The
batches put rows on the grid's edges and corners, and two rows of one event
at one site."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from waveformml_tpu.ops import sparse as jsparse
from waveformml_tpu.ops import sparse_conv as jsc
from waveformml_tpu.ops.row_conv import rows_to_dense as jax_rows_to_dense
from waveformml_tpu_torch.convert import flax_to_state_dict
from waveformml_tpu_torch.ops import sparse as sparse_ops
from waveformml_tpu_torch.ops import sparse_conv as sc
from waveformml_tpu_torch.ops.row_conv import rows_to_dense
from waveformml_tpu_torch.ops.sparse import SparseBatch
from waveformml_tpu_torch.registry import retrieve_class

NX, NY = 14, 11
ATOL = 1e-5
N_EVENTS, N_ROWS, C = 6, 64, 5


def _batch(seed, n_events=N_EVENTS, n_rows=N_ROWS, c=C):
    """Rows at the four corners and along the edges of event 0, two rows at
    one site in event 1, random sites elsewhere, the last event empty, and
    padding rows."""
    rng = np.random.default_rng(seed)
    corners = [[0, 0, 0], [NX - 1, 0, 0], [0, NY - 1, 0], [NX - 1, NY - 1, 0],
               [NX - 1, 5, 0], [7, NY - 1, 0]]
    dup = [[3, 4, 1], [3, 4, 1], [3, 5, 1]]
    rest = [[int(s % NX), int(s // NX), e] for e in range(2, n_events - 1)
            for s in rng.choice(NX * NY, size=8, replace=False)]
    coords = np.zeros((n_rows, 3), np.int32)
    real = np.asarray(corners + dup + rest, np.int32)
    coords[:len(real)] = real
    mask = np.zeros(n_rows, bool)
    mask[:len(real)] = True
    feats = rng.normal(size=(n_rows, c)).astype(np.float32)
    feats[~mask] = rng.normal(size=((~mask).sum(), c))     # padding must not leak
    return coords, feats, mask


def _jax_batch(coords, feats, mask, n_events=N_EVENTS):
    return jsparse.SparseBatch(jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(mask),
                               n_events)


def _port_batch(coords, feats, mask, n_events=N_EVENTS):
    return SparseBatch(torch.from_numpy(coords), torch.from_numpy(feats),
                       torch.from_numpy(mask), n_events)


def _grids(seed, c=C):
    """The same batch as a JAX grid ([B, NX, NY, C]) and a port grid."""
    coords, feats, mask = _batch(seed, c=c)
    jg = jsc.SparseGrid(jsparse.scatter_to_dense(_jax_batch(coords, feats, mask)),
                        jsparse.occupancy_mask(_jax_batch(coords, feats, mask)))
    pg = sc.batch_to_grid(_port_batch(coords, feats, mask))
    return jg, pg


def _close(port_grid_features, jax_nhwc):
    np.testing.assert_allclose(port_grid_features.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jax_nhwc), rtol=0, atol=ATOL)


def _load(module, variables):
    flat = {k: np.asarray(v) for k, v in flatten_dict(jax.device_get(variables),
                                                        sep="/").items()}
    module.load_state_dict(flax_to_state_dict(flat))
    return module


def _init(jmodule, jg, seed=0, **kw):
    """flax init, with the biases and BatchNorm statistics redrawn."""
    variables = jmodule.init(jax.random.PRNGKey(seed), jg, **kw)
    rng = np.random.default_rng(seed)
    flat = flatten_dict(jax.device_get(variables), sep="/")
    for k, v in flat.items():
        if k.endswith("/bias") or k.endswith("/mean"):
            flat[k] = jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.3)
        elif k.endswith("/var"):
            flat[k] = jnp.asarray(rng.uniform(0.5, 2.0, size=v.shape).astype(np.float32))
    from flax.traverse_util import unflatten_dict
    return unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


# -- helpers of ops/sparse.py and ops/row_conv.py ----------------------------------

def test_scatter_occupancy_gather_match_jax():
    coords, feats, mask = _batch(1)
    jb, pb = _jax_batch(coords, feats, mask), _port_batch(coords, feats, mask)
    dense = sparse_ops.scatter_to_dense(pb)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jsparse.scatter_to_dense(jb)),
                               rtol=0, atol=ATOL)
    # two rows at one site are summed
    np.testing.assert_allclose(dense[1, 3, 4].numpy(), feats[6] + feats[7], atol=ATOL)
    occ = sparse_ops.occupancy_mask(pb)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jsparse.occupancy_mask(jb)))
    assert occ[0, NX - 1, NY - 1] and not occ[N_EVENTS - 1].any()
    back = sparse_ops.gather_from_dense(dense, pb)
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(jsparse.gather_from_dense(
                                   jsparse.scatter_to_dense(jb), jb)), rtol=0, atol=ATOL)
    # both duplicate rows read their sum back; padding rows read zeros
    np.testing.assert_allclose(back[6].numpy(), back[7].numpy())
    assert not back[~torch.from_numpy(mask)].any()


def test_rows_to_dense_matches_jax():
    coords, feats, mask = _batch(2)
    got = rows_to_dense(torch.from_numpy(feats), _port_batch(coords, feats, mask))
    want = jax_rows_to_dense(jnp.asarray(feats), _jax_batch(coords, feats, mask))
    assert got.shape == (N_EVENTS, C, NX, NY)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_swap_sparse_from_dense_matches_jax():
    rng = np.random.default_rng(3)
    coords = np.asarray([[1, 2, 7], [3, 4, 7], [0, 0, 9], [13, 10, 12]], np.int32)
    dense = rng.normal(size=(3, NX, NY)).astype(np.float32)
    got, want = np.zeros(4, np.float32), np.zeros(4, np.float32)
    sparse_ops.swap_sparse_from_dense(got, dense, coords)
    jsparse.swap_sparse_from_dense(want, dense, coords)
    np.testing.assert_array_equal(got, want)


# -- the grid convs -----------------------------------------------------------------

def test_subm_conv_matches_jax_and_keeps_the_occupancy():
    jg, pg = _grids(4)
    jm = jsc.SubMConv2d(C, 7, 3, indice_key="s0")
    variables = _init(jm, jg)
    want = jm.apply(variables, jg)
    got = _load(sc.SubMConv2d(C, 7, 3, indice_key="s0"), variables)(pg)
    _close(got.features, want.features)
    np.testing.assert_array_equal(got.occupancy.numpy(), np.asarray(want.occupancy))
    np.testing.assert_array_equal(got.indice_occ["s0"].numpy(), pg.occupancy.numpy())
    assert got.indice_geom["s0"] == ((3, 3), (1, 1), (1, 1), (1, 1))
    # exact SubM: nothing lands off the occupancy
    assert not (got.features * ~got.occupancy[:, None]).any()


@pytest.mark.parametrize("stride", [1, 2])
def test_sparse_conv_dilates_the_occupancy_like_jax(stride):
    jg, pg = _grids(5)
    jm = jsc.SparseConv2d(C, 4, 3, stride, 1, 1, indice_key="c0")
    variables = _init(jm, jg)
    want = jm.apply(variables, jg)
    got = _load(sc.SparseConv2d(C, 4, 3, stride, 1, 1, indice_key="c0"), variables)(pg)
    np.testing.assert_array_equal(got.occupancy.numpy(), np.asarray(want.occupancy))
    _close(got.features, want.features)
    occ = sc.dilate_occupancy(pg.occupancy, 3, stride, 1, 1)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(
        jsc.dilate_occupancy(jg.occupancy, 3, stride, 1, 1)))
    if stride == 1:
        # the dilated occupancy covers the input's
        assert bool((occ | ~pg.occupancy).all())
        assert int(occ.sum()) > int(pg.occupancy.sum())


@pytest.mark.parametrize("k,s,p", [(3, 2, 1), (2, 2, 0), (3, 3, 0), (3, 2, 2)])
def test_inverse_conv_restores_the_paired_occupancy_like_jax(k, s, p):
    """A strided pairing whose floor cut leaves a tail (14 or 11 not
    reached by the transposed conv's span): the inverse conv restores the
    saved size and occupancy, and its tail rows match the JAX package's."""
    jg, pg = _grids(6)
    jf = jsc.SparseConv2d(C, 4, k, s, p, 1, indice_key="ind")
    ji = jsc.SparseInverseConv2d(4, 3, k, indice_key="ind")
    vf = _init(jf, jg)
    mid = jf.apply(vf, jg)
    vi = _init(ji, mid, seed=1)
    want = ji.apply(vi, mid)
    pf = _load(sc.SparseConv2d(C, 4, k, s, p, 1, indice_key="ind"), vf)
    pi = _load(sc.SparseInverseConv2d(4, 3, k, indice_key="ind"), vi)
    pmid = pf(pg)
    got = pi(pmid)
    o = pmid.features.shape[2:]
    tails = [t - ((oi - 1) * s + (k - 1) - 2 * p + 1) for t, oi in zip((NX, NY), o)]
    assert any(t > 0 for t in tails), tails
    assert got.features.shape == (N_EVENTS, 3, NX, NY)
    np.testing.assert_array_equal(got.occupancy.numpy(), np.asarray(want.occupancy))
    _close(got.features, want.features)


def test_inverse_conv_needs_its_key():
    _, pg = _grids(7)
    with pytest.raises(ValueError, match="indice_key 'nope' not found"):
        sc.SparseInverseConv2d(C, 2, 3, indice_key="nope")(pg)


@pytest.mark.parametrize("train", [True, False])
def test_masked_batchnorm_matches_jax_over_the_occupancy(train):
    """Statistics over the occupied sites only (empty sites and padding
    rows ignored), float32, unbiased running variance."""
    jg, pg = _grids(8)
    jm = jsc.MaskedBatchNorm(C)
    variables = _init(jm, jg)
    pm = _load(sc.MaskedBatchNorm(C), variables).train(train)
    got = pm(pg)
    if train:
        want, updates = jm.apply(variables, jg, train=True, mutable=["batch_stats"])
        np.testing.assert_allclose(pm.running_mean.numpy(),
                                   np.asarray(updates["batch_stats"]["mean"]), atol=ATOL)
        np.testing.assert_allclose(pm.running_var.numpy(),
                                   np.asarray(updates["batch_stats"]["var"]), atol=ATOL)
    else:
        want = jm.apply(variables, jg, train=False)
    _close(got.features, want.features)
    assert not (got.features * ~pg.occupancy[:, None]).any()


def test_relu_activation_and_to_dense_match_jax():
    jg, pg = _grids(9)
    _close(sc.SparseReLU()(pg).features, jsc.SparseReLU().apply({}, jg).features)
    got = sc.SparseActivation(torch.sigmoid)(pg).features
    want = jsc.SparseActivation(jax.nn.sigmoid).apply({}, jg).features
    _close(got, want)
    assert not (got * ~pg.occupancy[:, None]).any()          # re-masked
    dense = sc.ToDense()(pg)
    jdense = jsc.ToDense().apply({}, jg)
    # the JAX package's [B, C, NX, NY] order, element for element and in a flatten
    assert dense.shape == tuple(jdense.shape) == (N_EVENTS, C, NX, NY)
    np.testing.assert_allclose(dense.reshape(N_EVENTS, -1).numpy(),
                               np.asarray(jdense).reshape(N_EVENTS, -1), rtol=0, atol=ATOL)


def test_sequential_chain_matches_jax():
    """SubM → BN → ReLU → strided conv → inverse conv through
    SparseSequential, whose layers are named as flax names them."""
    jg, pg = _grids(10)

    def layers(m):
        return [m.SubMConv2d(C, 6, 3, indice_key="a"), m.MaskedBatchNorm(6), m.SparseReLU(),
                m.SparseConv2d(6, 4, 3, 2, 1, 1, indice_key="b"),
                m.SparseInverseConv2d(4, 3, 3, indice_key="b")]

    jm = jsc.SparseSequential(layers(jsc))
    variables = _init(jm, jg)
    pm = _load(sc.SparseSequential(layers(sc)), variables).eval()
    _close(pm(pg).features, jm.apply(variables, jg).features)


def test_dropout_eval_mode_is_the_identity():
    _, pg = _grids(11)
    layer = sc.SparseDropout(0.5).eval()
    assert torch.equal(layer(pg).features, pg.features)


def test_dropout_train_mode_keeps_zeros_and_scales_survivors():
    _, pg = _grids(12)
    layer = sc.SparseDropout(0.25).train()
    gen = torch.Generator().manual_seed(0)
    out = layer(pg, gen).features
    x = pg.features
    assert not out[x == 0].any()                              # zeros stay zero
    kept = (out != 0) & (x != 0)
    np.testing.assert_allclose(out[kept].numpy(), (x[kept] / 0.75).numpy(), rtol=1e-6)
    dropped = ((out == 0) & (x != 0)).sum().item() / (x != 0).sum().item()
    assert 0.15 < dropped < 0.35
    # the same generator state gives the same mask
    again = layer(pg, torch.Generator().manual_seed(0)).features
    assert torch.equal(out, again)
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        layer(pg)


def test_registry_names_resolve_to_the_grid_ops():
    for name, cls in (("spconv.SubMConv2d", sc.SubMConv2d),
                      ("spconv.SparseConv2d", sc.SparseConv2d),
                      ("SparseInverseConv2d", sc.SparseInverseConv2d),
                      ("sparseconvnet.SparseToDense", sc.ToDense),
                      ("spconv.SparseSequential", sc.SparseSequential)):
        assert retrieve_class(name) is cls


class _PrecisionLog(torch.utils._python_dispatch.TorchDispatchMode):
    """Records cuDNN's conv precision at every convolution the ops run."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.startswith("convolution"):
            self.seen.append((func.__name__, _conv_precision()))
        return func(*args, **(kwargs or {}))


def _conv_precision():
    conv = getattr(torch.backends.cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        return conv.fp32_precision
    return "tf32" if torch.backends.cudnn.allow_tf32 else "ieee"


def _set_tf32(on: bool):
    conv = getattr(torch.backends.cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        conv.fp32_precision = "tf32" if on else "ieee"
    else:
        torch.backends.cudnn.allow_tf32 = on


def test_convs_switch_tf32_off_forward_and_backward():
    """With the process's flag on TF32, every conv of a forward and a
    backward runs with cuDNN in full float32, and the flag is back after."""
    _, pg = _grids(13)
    layer = sc.SparseConv2d(C, 3, 3, 1, 1, 1)
    before = _conv_precision()
    _set_tf32(True)
    try:
        log = _PrecisionLog()
        with log:
            layer(pg).features.sum().backward()
        names = {n for n, _ in log.seen}
        assert names == {"convolution.default", "convolution_backward.default"}, names
        assert {p for _, p in log.seen} == {"ieee"}, log.seen
        assert _conv_precision() == "tf32"
    finally:
        _set_tf32(before == "tf32")
