"""Kernel K2's plain version against the JAX ``site_grouped_matmul`` (fp32,
with empty slots, padding rows, zero-padded capacity and extra empty
groups, with and without the bias that ``FoldedSiteLinear`` adds after it,
and on hand-made layouts: duplicate sites, stitched groups, events past
``n_events``, a ragged MAX), at SubMPSD.json's head and SubMPSD_w128.json's,
the wrapper's CPU dispatch, and the kernel against its plain version on the
card."""
import numpy as np
import pytest
import torch

from waveformml_tpu_torch.datasets.synthetic import SITE_LAYOUT_FEATURES, site_layout_case
from waveformml_tpu_torch.ops.site_head import (host_site_layout, output_stride,
                                                site_grouped_matmul,
                                                site_grouped_matmul_plain, tile_slots)

NX, NY = 14, 11
S = NX * NY

# one layout per feature, then all of them at once, at SubMPSD.json's head
# (C, F) = (8, 50) and at SubMPSD_w128.json's (128, 199)
LAYOUTS = [pytest.param((name,), id=name) for name in SITE_LAYOUT_FEATURES]
LAYOUTS.append(pytest.param(SITE_LAYOUT_FEATURES, id="all"))
WIDE = (128, 199)
LAYOUTS_AT = [pytest.param(*p.values, 8, 50, id=p.id) for p in LAYOUTS] + [
    pytest.param(*p.values, *WIDE, id=f"{p.id}-128-199") for p in LAYOUTS]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel K2 runs only on the card")
    return torch.device("cuda")


def _case(rng, n_events, c, f, pad_rows=13, pad_slots=0, extra_groups=0):
    rows = []
    for e in range(n_events):
        for s in rng.choice(S, size=int(rng.integers(1, 5)), replace=False):
            rows.append([s // NY, s % NY, e])
    coords = np.asarray(rows, np.int32)
    n = coords.shape[0]
    c_pad = np.zeros((n + pad_rows, 3), np.int32)
    c_pad[:n] = coords
    mask = np.zeros(n + pad_rows, bool)
    mask[:n] = True
    lay = host_site_layout(c_pad, mask)
    lay = {k: (np.pad(v, ((0, extra_groups), (0, pad_slots))) if v.ndim == 2
               else np.pad(v, (0, extra_groups))) for k, v in lay.items()}
    feats = rng.normal(size=(n + pad_rows, c)).astype(np.float32)
    feats[n:] = 0
    k3 = (rng.normal(size=(c, S, f)) / np.sqrt(c * S)).astype(np.float32)
    # one more event than the coords use: its output row stays zero
    return feats, k3, lay["site_take"], lay["site_ev"], lay["site_s"], n_events + 1


def _jax_site_matmul(rows, k3, take, ev, site, n_events, bias=None):
    """The JAX ``site_grouped_matmul``, plus the bias as ``FoldedSiteLinear``
    adds it, as numpy."""
    import jax.numpy as jnp

    from waveformml_tpu.ops.site_head import site_grouped_matmul as jax_site_matmul

    out = jax_site_matmul(*(jnp.asarray(a) for a in (rows, k3, take, ev, site)), n_events)
    return np.asarray(out if bias is None else out + jnp.asarray(bias))


def _check_layout(features, take, ev, site, n_events):
    """The layout has what its features name, and what every hand-made
    layout has."""
    filled = take > 0
    assert (~filled & (ev > 0)).any() and (filled & (ev == 0)).any()
    assert (filled[:, 1:] & ~filled[:, :-1]).any()      # a gap before a filled slot
    if "duplicate_sites" in features:
        assert any(np.unique(e[e > 0]).size < (e > 0).sum() for e in ev * filled)
    if "stitched_groups" in features:
        assert site.size > S and np.unique(site).size < site.size
        assert ((site < 1) | (site > S)).any()
    if "events_past_end" in features:
        assert (filled & (ev > n_events)).any()
    if "ragged_max" in features:
        assert take.shape[1] == 600 and not filled[:, :300].any()


@pytest.mark.parametrize("n_events,c,f,pad_slots,extra_groups,with_bias", [
    pytest.param(40, 8, 50, 0, 0, False, id="40-8-50-0-0"),
    pytest.param(40, 8, 50, 16, 0, False, id="40-8-50-16-0"),
    pytest.param(40, 8, 50, 0, 7, False, id="40-8-50-0-7"),
    pytest.param(300, 3, 5, 0, 0, False, id="300-3-5-0-0"),
    pytest.param(40, 8, 50, 0, 0, True, id="40-8-50-0-0-bias"),
    pytest.param(40, 8, 50, 16, 7, True, id="40-8-50-16-7-bias"),
    pytest.param(300, 3, 5, 0, 0, True, id="300-3-5-0-0-bias"),
    pytest.param(60, 8, 200, 0, 0, True, id="60-8-200-0-0-bias"),
    pytest.param(40, 128, 199, 0, 0, False, id="40-128-199-0-0"),
    pytest.param(40, 128, 199, 16, 7, True, id="40-128-199-16-7-bias"),
])
def test_plain_matches_jax(rng, n_events, c, f, pad_slots, extra_groups, with_bias):
    rows, k3, take, ev, site, n_ev = _case(rng, n_events, c, f,
                                           pad_slots=pad_slots,
                                           extra_groups=extra_groups)
    assert (take == 0).any()
    bias = rng.normal(size=(f,)).astype(np.float32) if with_bias else None
    want = _jax_site_matmul(rows, k3, take, ev, site, n_ev, bias)
    got = site_grouped_matmul_plain(*(torch.from_numpy(a) for a in
                                      (rows, k3, take, ev, site)), n_ev,
                                    None if bias is None else torch.from_numpy(bias)).numpy()
    assert got.shape == (n_ev, f) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the extra event has no slot: its row is the bias alone
    np.testing.assert_array_equal(got[-1], 0 if bias is None else bias)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("features,c,f", LAYOUTS_AT)
def test_plain_matches_jax_on_hand_made_layouts(rng, features, c, f, with_bias):
    rows, k3, take, ev, site, bias = site_layout_case(rng, features, 120, c, f)
    _check_layout(features, take, ev, site, 120)
    bias = bias if with_bias else None
    want = _jax_site_matmul(rows, k3, take, ev, site, 120, bias)
    got = site_grouped_matmul_plain(*(torch.from_numpy(a) for a in
                                      (rows, k3, take, ev, site)), 120,
                                    None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_plain_adds_two_rows_of_one_event_at_one_site(rng):
    """Two slots of one group name one event: both products land in its row."""
    rows = rng.normal(size=(9, 4)).astype(np.float32)
    k3 = rng.normal(size=(4, S, 6)).astype(np.float32)
    take = np.zeros((S, 8), np.int32)
    ev = np.zeros((S, 8), np.int32)
    site = np.arange(1, S + 1, dtype=np.int32)
    take[5, :2], ev[5, :2] = (3, 7), (2, 2)
    take[9, 4], ev[9, 4] = 1, 2
    got = site_grouped_matmul_plain(*(torch.from_numpy(a) for a in
                                      (rows, k3, take, ev, site)), 10).numpy()
    want = (rows[2] + rows[6]) @ k3[:, 5, :] + rows[0] @ k3[:, 9, :]
    np.testing.assert_allclose(got[1], want, rtol=1e-5, atol=1e-6)
    assert (np.delete(got, 1, axis=0) == 0).all()
    np.testing.assert_allclose(got, _jax_site_matmul(rows, k3, take, ev, site, 10),
                               rtol=1e-5, atol=1e-5)


def test_plain_drops_events_past_n_events(rng):
    rows, k3, take, ev, site, n_ev = _case(rng, 20, 4, 6)
    args = [torch.from_numpy(a) for a in (rows, k3, take, ev, site)]
    full = site_grouped_matmul_plain(*args, n_ev)
    cut = site_grouped_matmul_plain(*args, 5)
    want = _jax_site_matmul(rows, k3, take, ev, site, 5)
    np.testing.assert_allclose(cut.numpy(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cut, full[:5], rtol=0, atol=0)


def test_wrapper_uses_plain_on_cpu(rng):
    args = [torch.from_numpy(a) for a in _case(rng, 10, 4, 6)[:5]]
    bias = torch.from_numpy(rng.normal(size=(6,)).astype(np.float32))
    before = site_grouped_matmul.launches
    got = site_grouped_matmul(*args, 11)
    torch.testing.assert_close(got, site_grouped_matmul_plain(*args, 11),
                               rtol=0, atol=0)
    got = site_grouped_matmul(*args, 11, bias)
    torch.testing.assert_close(got, site_grouped_matmul_plain(*args, 11, bias),
                               rtol=0, atol=0)
    assert site_grouped_matmul.launches == before
    with pytest.raises(ValueError, match="shape"):
        site_grouped_matmul(args[0], args[1], args[2], args[3][:, :2], args[4], 11)
    with pytest.raises(ValueError, match="bias"):
        site_grouped_matmul(*args, 11, bias[:5])


def test_output_stride_aligns_rows():
    assert [output_stride(f) for f in (1, 4, 5, 50, 200)] == [4, 4, 8, 52, 200]


# (events, C, F, features): the serving head on the specialised path, at 64
# events (most groups empty: blocks that only wait for the bias grid) and at
# 4096, three widths on the tiled path (SubMPSD_w128.json's head among them),
# and a hand-made layout with all its features at both heads
CARD_CASES = [
    pytest.param(64, 8, 50, None, id="serving-64-8-50"),
    pytest.param(4096, 8, 50, None, id="serving-8-50"),
    pytest.param(4096, 3, 5, None, id="generic-3-5"),
    pytest.param(4096, 8, 200, None, id="generic-8-200"),
    pytest.param(4096, *WIDE, None, id="wide-128-199"),
    pytest.param(4096, 8, 50, SITE_LAYOUT_FEATURES, id="hand-made-8-50"),
    pytest.param(4096, *WIDE, SITE_LAYOUT_FEATURES, id="hand-made-128-199"),
]


def _live_tiles(take, ev, n_events, tile):
    """(tiles with a live slot, all tiles) of a [G, MAX] layout in tiles of
    ``tile`` slots."""
    g, m = take.shape
    live = (take > 0) & (ev > 0) & (ev <= n_events)
    tiles = -(-m // tile)
    live = np.pad(live, ((0, 0), (0, tiles * tile - m))).reshape(g, tiles, tile)
    return int(live.any(-1).sum()), g * tiles


@pytest.mark.cuda
@pytest.mark.parametrize("n_events,c,f,features", CARD_CASES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_kernel_matches_plain_on_card(cuda, n_events, c, f, features, with_bias):
    rng = np.random.default_rng(12345)
    torch.backends.cuda.matmul.allow_tf32 = False
    if features is None:
        *arrays, n_ev = _case(rng, n_events, c, f)
        bias = rng.normal(size=(f,)).astype(np.float32)
    else:
        n_ev = n_events
        *arrays, bias = site_layout_case(rng, features, n_ev, c, f)
        # the ragged MAX leaves whole tiles empty: the kernel skips them
        live, tiles = _live_tiles(arrays[2], arrays[3], n_ev, tile_slots())
        assert live < tiles, (live, tiles)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    b = torch.from_numpy(bias).to(cuda) if with_bias else None
    want = site_grouped_matmul_plain(*args, n_ev, b)
    before = site_grouped_matmul.launches
    got = site_grouped_matmul(*args, n_ev, b)
    torch.cuda.synchronize()
    # the bias grid and the products' grid
    assert site_grouped_matmul.launches == before + 2
    # rows padded to 16 bytes: the result is a view of them
    assert got.shape == (n_ev, f) and got.stride() == (output_stride(f), 1)
    # the fp32 atomics add an event's few rows and the bias in a varying order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("ldo,offset", [pytest.param(50, 0, id="stride-50"),
                                        pytest.param(52, 1, id="misaligned")])
def test_kernel_refuses_rows_not_16_byte_aligned(cuda, ldo, offset):
    """The float4 adds need 16-byte-aligned output rows: the launch function
    refuses any other stride or base, and launches nothing."""
    from waveformml_tpu_torch.ops import native, site_head

    rng = np.random.default_rng(7)
    arrays = [torch.from_numpy(a).to(cuda) for a in _case(rng, 64, 8, 50)[:5]]
    rows, k3, take, ev, site = arrays
    out = torch.zeros(65 * ldo + offset, device=cuda)
    lib = native.load("site_head", site_head._FUNCTIONS)
    err = lib.site_grouped_matmul_fwd(
        rows.data_ptr(), k3.data_ptr(), None, take.data_ptr(), ev.data_ptr(),
        site.data_ptr(), out.data_ptr() + 4 * offset, take.shape[0], take.shape[1], 8,
        S, 50, ldo, 65, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert lib.wf_cuda_error_string(err).decode() == "invalid argument"
    assert bool((out == 0).all())
