"""The port's host-side batch helpers equal the JAX package's elementwise:
bucket sizes, padding, neighbour plans, the site layout, event renumbering
and the conv stack schedule."""
import numpy as np
import pytest

from waveformml_tpu.models.sparse_blocks import SparseConv2DForEZ as JaxForEZ
from waveformml_tpu.ops import row_conv as jrc
from waveformml_tpu.ops import site_head as jsh
from waveformml_tpu.ops import sparse as jsp
from waveformml_tpu_torch.models.sparse_blocks import SparseConv2DForEZ
from waveformml_tpu_torch.ops import row_conv, site_head, sparse

NX, NY = 14, 11


def _batch(rng, n_events, max_mult=5, pad_to=None):
    """Random events with distinct in-range sites, padded to a bucket."""
    rows = []
    for e in range(n_events):
        for s in rng.choice(NX * NY, size=int(rng.integers(1, max_mult + 1)),
                            replace=False):
            rows.append([s // NY, s % NY, e])
    coords = np.asarray(rows, np.int32)
    feats = rng.normal(size=(coords.shape[0], 6)).astype(np.float32)
    n_rows = pad_to or jsp.bucket_size(coords.shape[0])
    return jsp.pad_sparse(coords, feats, n_rows)


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 1000, 12288, 12289, 65536,
                               65537, 200000])
def test_bucket_size_matches(n):
    assert sparse.bucket_size(n) == jsp.bucket_size(n)
    ev = (16, 32, 64, 128)
    assert sparse.bucket_size(n, ev) == jsp.bucket_size(n, ev)


@pytest.mark.parametrize("label_shape", [None, (), (3,)])
def test_pad_sparse_matches(rng, label_shape):
    n = 37
    coords = rng.integers(0, 10, size=(n, 3)).astype(np.int32)
    feats = rng.normal(size=(n, 5)).astype(np.float32)
    args = (coords, feats, 64)
    if label_shape is not None:
        args += (rng.normal(size=(n,) + label_shape).astype(np.float32), -1.0)
    got, want = sparse.pad_sparse(*args), jsp.pad_sparse(*args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("n_events", [1, 9, 40])
def test_host_neighbor_plan_matches(rng, k, n_events):
    coords, _, mask = _batch(rng, n_events)
    n_ev_bucket = jsp.bucket_size(n_events, (16, 32, 64))
    got = row_conv.host_neighbor_plan(coords, mask, n_ev_bucket, k)
    want = jrc.host_neighbor_plan(coords, mask, n_ev_bucket, k)
    assert got.dtype == np.int32 and got.shape == (coords.shape[0], k * k)
    np.testing.assert_array_equal(got, want)
    assert (got[~mask] == -1).all()


def test_host_neighbor_plan_rejects_even_k(rng):
    coords, _, mask = _batch(rng, 4)
    with pytest.raises(ValueError, match="odd"):
        row_conv.host_neighbor_plan(coords, mask, 16, 2)


@pytest.mark.parametrize("n_events,min_cap", [(1, 8), (30, 8), (200, 8), (30, 64)])
def test_host_site_layout_matches(rng, n_events, min_cap):
    coords, _, mask = _batch(rng, n_events)
    got = site_head.host_site_layout(coords, mask, min_cap=min_cap)
    want = jsh.host_site_layout(coords, mask, min_cap=min_cap)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])
    cap = got["site_take"].shape[1]
    assert cap >= min_cap and cap & (cap - 1) == 0


def test_consecutive_event_index_matches(rng):
    ev = np.sort(rng.choice(1000, size=50)) * 3
    np.testing.assert_array_equal(sparse.consecutive_event_index(ev),
                                  jsp.consecutive_event_index(ev))
    assert sparse.consecutive_event_index(np.zeros(0)).size == 0


@pytest.mark.parametrize("kwargs", [
    dict(in_planes=130, out_planes=8, kernel_size=3, n_conv=2, n_point=1,
         conv_position=1, version=2),
    dict(in_planes=130, out_planes=8, kernel_size=5, n_conv=2, n_point=2,
         conv_position=2, version=1),
    dict(in_planes=64, out_planes=4, kernel_size=5, n_conv=3, n_point=1,
         conv_position=1, version=3, n_expand=1),
])
def test_schedule_matches(kwargs):
    assert SparseConv2DForEZ.schedule(**kwargs) == JaxForEZ.schedule(**kwargs)
