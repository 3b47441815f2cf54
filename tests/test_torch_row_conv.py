"""Kernel K1's plain version against the JAX ``subm_conv_rows`` (fp32, with
absent taps and padding rows, and on adversarial plans: full 3×3 clusters,
duplicate sites, single-site events, a row count that is not a multiple of
the kernel's tile, narrow and wide channel counts), the wrapper's CPU
dispatch and checks, and the kernel against its plain version on the card
on the same inputs.

The 27-tap design of K1 and K4 (``row_design``): on the CPU, the plain
27-tap forward, d_feats, d_kernel and d_bias against the JAX
``subm_conv_rows`` and ``jax.vjp`` of its custom VJP at the design's widths
(rtol 1e-4, atol 1e-5) and the dispatch rule; on the card (``cuda``
marker), both kernels against their plain versions at those widths,
bitwise equal over two runs, on an all-masked bucket, without rows, with
duplicate sites, one shape on each side of the rule, and K4's grid
geometry as its launcher sizes it on the card."""
import numpy as np
import pytest
import torch

from waveformml_tpu_torch.datasets.synthetic import conv_case as synthetic_conv_case
from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.ops import native, row_conv
from waveformml_tpu_torch.ops.row_conv import (TAP_KK, host_neighbor_plan, k1_grids,
                                               row_design, subm_conv_rows,
                                               subm_conv_rows_bwd_plain, subm_conv_rows_plain,
                                               subm_conv_rows_wgrad, subm_conv_rows_wgrad_plain,
                                               take_row_taps, transposed_kernel)
from waveformml_tpu_torch.ops.sparse import pad_sparse

# (plan kind, k, cin, cout, n_events, n_rows): the serving layers' widths on
# clustered events, then the adversarial plans
CASES = [
    pytest.param("clustered", 3, 130, 104, 12, None, id="3-130-104"),
    pytest.param("clustered", 3, 104, 56, 12, None, id="3-104-56"),
    pytest.param("clustered", 1, 56, 8, 12, None, id="1-56-8"),
    pytest.param("clustered", 3, 5, 3, 12, None, id="3-5-3"),
    pytest.param("dense_cluster", 3, 130, 104, 12, None, id="dense_cluster"),
    pytest.param("duplicate_sites", 3, 104, 56, 12, None, id="duplicate_sites"),
    pytest.param("isolated_sites", 3, 130, 104, 12, None, id="isolated_sites"),
    pytest.param("clustered", 3, 130, 104, 40, 3 * 64 + 37, id="ragged_n"),
    pytest.param("clustered", 3, 56, 200, 12, None, id="cout_200"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel K1 runs only on the card")
    return torch.device("cuda")


def conv_case(rng, kind, n_events, k, cin, cout, n_rows=None):
    """(feats, plan, kernel, bias, mask), numpy, of a synthetic conv case."""
    coords, feats, kernel, bias, mask = synthetic_conv_case(rng, kind, n_events, k,
                                                            cin, cout, n_rows)
    return feats, host_neighbor_plan(coords, mask, n_events, k), kernel, bias, mask


def _check_plan(kind, k, plan, mask):
    """The plan has what its case is named for."""
    assert (plan == -1).any()
    if kind == "isolated_sites":
        assert (np.delete(plan, k * k // 2, axis=1) == -1).all()
    else:
        assert k == 1 or ((plan >= 0).sum(1) > 1).any()
    if kind == "dense_cluster":
        assert ((plan >= 0).sum(1) == 9).any()
    if kind == "duplicate_sites":
        rows = np.arange(plan.shape[0])
        centre = plan[:, k * k // 2]
        assert ((centre >= 0) & (centre != rows) & mask).any()


@pytest.mark.parametrize("kind,k,cin,cout,n_events,n_rows", CASES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_matches_jax(rng, kind, k, cin, cout, n_events, n_rows, with_bias):
    import jax.numpy as jnp

    from waveformml_tpu.ops.row_conv import subm_conv_rows as jax_subm_conv_rows

    feats, plan, kernel, bias, mask = conv_case(rng, kind, n_events, k, cin, cout,
                                                n_rows)
    _check_plan(kind, k, plan, mask)
    if n_rows is not None:
        assert plan.shape[0] == n_rows and n_rows % 64 != 0
    b = bias if with_bias else None
    want = np.asarray(jax_subm_conv_rows(
        jnp.asarray(feats), jnp.asarray(plan), jnp.asarray(kernel),
        None if b is None else jnp.asarray(b), jnp.asarray(mask)))
    got = subm_conv_rows_plain(torch.from_numpy(feats), torch.from_numpy(plan),
                               torch.from_numpy(kernel),
                               None if b is None else torch.from_numpy(b),
                               torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[~mask] == 0).all()


def test_wrapper_uses_plain_on_cpu(rng):
    feats, plan, kernel, bias, mask = (torch.from_numpy(a) for a in
                                       conv_case(rng, "clustered", 6, 3, 7, 4))
    before = subm_conv_rows.launches
    got = subm_conv_rows(feats, plan, kernel, bias, mask)
    torch.testing.assert_close(got, subm_conv_rows_plain(feats, plan, kernel,
                                                         bias, mask),
                               rtol=0, atol=0)
    assert subm_conv_rows.launches == before
    with pytest.raises(ValueError, match="shape"):
        subm_conv_rows(feats, plan[:, :4], kernel, bias, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,k,cin,cout,n_events,n_rows", CASES)
def test_kernel_matches_plain_on_card(cuda, kind, k, cin, cout, n_events, n_rows):
    rng = np.random.default_rng(12345)
    torch.backends.cuda.matmul.allow_tf32 = False
    if kind == "clustered" and n_rows is None:
        n_events = 300                 # several row tiles
    args = [torch.from_numpy(a).to(cuda)
            for a in conv_case(rng, kind, n_events, k, cin, cout, n_rows)]
    want = subm_conv_rows_plain(*args)
    before = subm_conv_rows.launches
    take_row_taps()
    got = subm_conv_rows(*args)
    computed = take_row_taps()
    # one grid for the centre tap, one for the other taps
    assert subm_conv_rows.launches == before + (1 if k == 1 else 2)
    _, plan, _, _, mask = args
    assert computed >= int(((plan >= 0) & mask[:, None]).sum())
    # the plain version is an fp32 GEMM; the kernel's 3-pass TF32 split drops
    # only small·small terms (~2^-22 relative) and sums in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# -- the 27-tap design -------------------------------------------------------------

#: (Cin, Cout) at the taps design's widths: 1 and 16 its edges, SCNet3D's
#: 2→8 and its d_feats' 8→8, an odd pair
TAP_WIDTHS = [pytest.param(ci, co, id=f"{ci}-{co}")
              for ci, co in ((1, 1), (2, 8), (3, 5), (8, 8), (16, 16))]
#: the 27-tap tolerance of tests/test_torch_scnet3d.py's gradient check
TAP_RTOL, TAP_ATOL = 1e-4, 1e-5


def tap_coords(rng, n_events, n_t):
    """(x, y, t, event) rows of 3D events as ``rows_3d`` orders them: 1-5
    segments near one spot an event, each a run of 1 to n_t consecutive
    samples, so that the dt = ±1 taps are present for most rows and the
    other taps for some."""
    rows = []
    for e in range(n_events):
        x0, y0 = int(rng.integers(0, NX)), int(rng.integers(0, NY))
        for _ in range(int(rng.integers(1, 6))):
            x = int(np.clip(x0 + rng.integers(-1, 2), 0, NX - 1))
            y = int(np.clip(y0 + rng.integers(-1, 2), 0, NY - 1))
            t0 = int(rng.integers(0, n_t))
            rows += [[x, y, t, e] for t in range(t0, min(n_t, t0 + int(rng.integers(1, 5))))]
    coords = np.unique(np.asarray(rows, np.int32), axis=0)
    return coords[np.lexsort((coords[:, 2], coords[:, 1], coords[:, 0], coords[:, 3]))]


def tap_case(seed, cin, cout, n_t=4, n_events=24, pad=37, duplicates=False):
    """feats, plan [N, 27], kernel [27, cin, cout], bias, mask and a
    cotangent g, numpy, over ``tap_coords`` events at ``n_t`` samples
    padded by ``pad`` rows; ``duplicates``: a quarter of the rows repeated,
    so that the plan's centre tap of a first copy names the other."""
    rng = np.random.default_rng(seed)
    coords = tap_coords(rng, n_events, n_t)
    if duplicates:
        coords = np.repeat(coords, 1 + (rng.random(coords.shape[0]) < 0.25), axis=0)
    coords, _, mask = pad_sparse(coords, np.zeros((coords.shape[0], 1), np.float32),
                                 coords.shape[0] + pad)
    plan = host_neighbor_plan(coords, mask, n_events, 3, n_t)
    n = mask.shape[0]
    feats = rng.normal(size=(n, cin)).astype(np.float32)
    feats[~mask] = 0
    kernel = (rng.normal(size=(TAP_KK, cin, cout)) / np.sqrt(TAP_KK * cin)).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32)
    g = rng.normal(size=(n, cout)).astype(np.float32)
    return feats, plan, kernel, bias, mask, g


@pytest.mark.parametrize("cin,cout", TAP_WIDTHS)
@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_27_taps_matches_jax(cin, cout, with_bias):
    """K1's plain forward over a 27-tap plan (n_t = 4) against the JAX
    ``subm_conv_rows``; rtol 1e-4, atol 1e-5."""
    import jax.numpy as jnp

    from waveformml_tpu.ops.row_conv import subm_conv_rows as jax_subm_conv_rows

    feats, plan, kernel, bias, mask, _ = tap_case(cin * 100 + cout, cin, cout)
    present = (plan >= 0)[mask]
    assert present[:, [12, 14]].mean() > 0.3 and present.sum(1).max() > 6
    assert (plan == -1).any()
    b = bias if with_bias else None
    want = np.asarray(jax_subm_conv_rows(jnp.asarray(feats), jnp.asarray(plan),
                                         jnp.asarray(kernel),
                                         None if b is None else jnp.asarray(b),
                                         jnp.asarray(mask)))
    got = subm_conv_rows_plain(*(None if a is None else torch.from_numpy(a)
                                 for a in (feats, plan, kernel, b, mask))).numpy()
    np.testing.assert_allclose(got, want, rtol=TAP_RTOL, atol=TAP_ATOL)
    assert (got[~mask] == 0).all()


@pytest.mark.parametrize("cin,cout", TAP_WIDTHS)
def test_plain_27_taps_bwd_matches_jax_vjp(cin, cout):
    """d_feats (K1 over the reversed, transposed kernel), d_kernel and
    d_bias (K4) of the plain backward over a 27-tap plan (n_t = 4) against
    ``jax.vjp`` of the JAX custom VJP; rtol 1e-4, atol 1e-5."""
    import jax
    import jax.numpy as jnp

    from waveformml_tpu.ops.row_conv import subm_conv_rows as jax_subm_conv_rows

    feats, plan, kernel, bias, mask, g = tap_case(cin * 100 + cout + 1, cin, cout)
    _, vjp = jax.vjp(lambda x, w, b: jax_subm_conv_rows(x, jnp.asarray(plan), w, b,
                                                       jnp.asarray(mask)),
                     jnp.asarray(feats), jnp.asarray(kernel), jnp.asarray(bias))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    t = [torch.from_numpy(a) for a in (feats, plan, kernel, mask, g)]
    got = subm_conv_rows_bwd_plain(t[0], t[1], t[2], t[3], t[4])
    for name, a, b in zip(("d_feats", "d_kernel", "d_bias"), got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=TAP_RTOL, atol=TAP_ATOL, err_msg=name)


@pytest.mark.parametrize("kk,cin,cout,design", [
    (27, 2, 8, "taps"), (27, 8, 8, "taps"), (27, 16, 16, "taps"), (27, 1, 1, "taps"),
    (27, 0, 8, "taps"), (27, 17, 8, "tiles"), (27, 8, 17, "tiles"), (27, 130, 104, "tiles"),
    (9, 2, 8, "tiles"), (9, 130, 104, "tiles"), (1, 2, 8, "tiles"), (125, 2, 8, "tiles")])
def test_row_design_rule(kk, cin, cout, design):
    """The taps design takes the 3x3x3 window with Cin and Cout ≤ 16 and
    nothing else: every 9-tap and 1-tap conv stays on the tiles design.
    K1 launches one grid for the taps design and K² = 1, two otherwise."""
    assert row_design(kk, cin, cout) == design
    assert k1_grids(kk, cin, cout) == (1 if design == "taps" or kk == 1 else 2)


@pytest.mark.parametrize("cin,cout", TAP_WIDTHS)
@pytest.mark.parametrize("with_bias", [True, False])
def test_wrapper_uses_plain_on_cpu_at_27_taps(cin, cout, with_bias):
    """On CPU tensors the 27-tap shapes reach the plain versions too, at
    every width the taps design takes, with and without the bias."""
    feats, plan, kernel, bias, mask, g = (torch.from_numpy(a)
                                          for a in tap_case(5 + cin, cin, cout))
    b = bias if with_bias else None
    before = subm_conv_rows.launches, subm_conv_rows_wgrad.launches
    assert torch.equal(subm_conv_rows(feats, plan, kernel, b, mask),
                       subm_conv_rows_plain(feats, plan, kernel, b, mask))
    got = subm_conv_rows_wgrad(feats, plan, g, mask, with_bias)
    want = subm_conv_rows_wgrad_plain(feats, plan, g, mask, with_bias)
    assert torch.equal(got[0], want[0])
    assert (got[1] is None and want[1] is None) or torch.equal(got[1], want[1])
    assert (subm_conv_rows.launches, subm_conv_rows_wgrad.launches) == before


def _card(arrays):
    return [torch.from_numpy(a).cuda() for a in arrays]


def _within_terms(got, want, scale, tol=1e-5):
    """Each output within ``tol`` times the sum of its terms' magnitudes."""
    for a, b, s in zip(got, want, scale):
        excess = float(((a - b).abs() - tol * s).max())
        assert excess <= 0, f"off by {excess:.3g} beyond {tol}·Σ|terms|"


def _check_taps_on_card(feats, plan, kernel, bias, mask, g, with_bias=True):
    """K1 forward, K1 as d_feats and K4 against their plain versions, each
    bitwise equal over two runs, with the taps design's launch counts."""
    b = bias if with_bias else None
    kk, cin, cout = kernel.shape
    assert row_design(kk, cin, cout) == row_design(kk, cout, cin) == "taps"
    want = subm_conv_rows_plain(feats, plan, kernel, b, mask)
    g = g.masked_fill(~mask[:, None], 0).contiguous()
    w_t = transposed_kernel(kernel)
    d_want = subm_conv_rows_bwd_plain(feats, plan, kernel, mask, g)[0]
    wg_want = subm_conv_rows_wgrad_plain(feats, plan, g, mask, with_bias)
    scale = subm_conv_rows_wgrad_plain(feats.abs(), plan, g.abs(), mask, with_bias)
    k1, k4 = subm_conv_rows.launches, subm_conv_rows_wgrad.launches
    take_row_taps()
    outs = [subm_conv_rows(feats, plan, kernel, b, mask) for _ in range(2)]
    computed = take_row_taps()
    d_outs = [subm_conv_rows(g, plan, w_t, None, mask) for _ in range(2)]
    wgrads = [subm_conv_rows_wgrad(feats, plan, g, mask, with_bias) for _ in range(2)]
    torch.cuda.synchronize()
    n = mask.shape[0]
    assert subm_conv_rows.launches == k1 + (4 if n else 0)
    assert subm_conv_rows_wgrad.launches == k4 + (4 if n else 2)
    # the taps design computes the present row-taps of the rows whose mask is on
    assert computed == 2 * int(((plan >= 0) & mask[:, None]).sum())
    torch.testing.assert_close(outs[0], want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d_outs[0], d_want, rtol=1e-5, atol=1e-5)
    got = [t for t in wgrads[0] if t is not None]
    _within_terms(got, [t for t in wg_want if t is not None],
                  [t for t in scale if t is not None])
    assert torch.equal(outs[0], outs[1]) and torch.equal(d_outs[0], d_outs[1])
    for a, c in zip(got, [t for t in wgrads[1] if t is not None]):
        assert torch.equal(a, c)
    assert (wgrads[0][1] is None) == (not with_bias)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", TAP_WIDTHS)
@pytest.mark.parametrize("n_t", [4, 16])
@pytest.mark.parametrize("with_bias", [True, False])
def test_taps_design_on_card(cuda, cin, cout, n_t, with_bias):
    """K1 (forward and as d_feats) and K4 in the taps design against their
    plain versions: K1 rtol = atol = 1e-5, K4 within 1e-5 of its terms'
    magnitudes; both give the same bits twice."""
    case = tap_case(7 * cin + cout, cin, cout, n_t=n_t, n_events=300)
    _check_taps_on_card(*_card(case), with_bias=with_bias)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all-masked", "no-rows", "duplicate-sites"])
def test_taps_design_edge_cases_on_card(cuda, case):
    """A bucket whose rows are all padding (zero outputs), no row at all
    (K1 launches nothing, K4's sum grid writes zeros), and duplicate sites,
    whose first copies' centre tap names another row."""
    feats, plan, kernel, bias, mask, g = tap_case(11, 2, 8, n_t=16, n_events=200,
                                                  duplicates=case == "duplicate-sites")
    if case == "all-masked":
        mask[:] = False
    elif case == "no-rows":
        feats, plan, mask, g = feats[:0], plan[:0], mask[:0], g[:0]
    else:
        centre = plan[:, TAP_KK // 2]
        assert ((centre >= 0) & (centre != np.arange(plan.shape[0])) & mask).any()
    args = _card((feats, plan, kernel, bias, mask, g))
    _check_taps_on_card(*args)
    if case != "duplicate-sites":
        assert not subm_conv_rows(*args[:5]).any()
        assert not any(t.any() for t in subm_conv_rows_wgrad(args[0], args[1], args[5],
                                                             args[4]))


@pytest.mark.cuda
@pytest.mark.parametrize("kk,cin,cout", [(27, 16, 16), (27, 17, 8), (9, 2, 8)])
def test_both_designs_reached_on_card(cuda, kk, cin, cout):
    """One shape on each side of the rule: 16→16 at 27 taps runs the taps
    design (K1 one grid), 17→8 at 27 taps and 2→8 at 9 taps the tiles
    design (K1 two grids); each against its plain version. The taps design
    refuses a shape past its widths."""
    if kk == TAP_KK:
        feats, plan, kernel, bias, mask, g = _card(tap_case(13, cin, cout, n_t=16,
                                                            n_events=200))
    else:
        rng = np.random.default_rng(13)
        coords, f, kernel, bias, mask = synthetic_conv_case(rng, "clustered", 300, 3, cin, cout)
        plan = host_neighbor_plan(coords, mask, 300, 3)
        g = rng.normal(size=(f.shape[0], cout)).astype(np.float32)
        feats, plan, kernel, bias, mask, g = _card((f, plan, kernel, bias, mask, g))
    before = subm_conv_rows.launches
    got = subm_conv_rows(feats, plan, kernel, bias, mask)
    assert subm_conv_rows.launches - before == k1_grids(kk, cin, cout)
    assert k1_grids(kk, cin, cout) == (1 if row_design(kk, cin, cout) == "taps" else 2)
    torch.testing.assert_close(got, subm_conv_rows_plain(feats, plan, kernel, bias, mask),
                               rtol=1e-5, atol=1e-5)
    _within_terms(subm_conv_rows_wgrad(feats, plan, g, mask),
                  subm_conv_rows_wgrad_plain(feats, plan, g, mask),
                  subm_conv_rows_wgrad_plain(feats.abs(), plan, g.abs(), mask))
    if row_design(kk, cin, cout) == "tiles":
        # the taps launchers themselves, past the rule: they refuse the shape
        stream = torch.cuda.current_stream().cuda_stream
        k1 = native.load("row_conv", row_conv._FUNCTIONS)
        out = torch.empty((feats.shape[0], cout), device="cuda")
        assert k1.subm_conv_rows_taps_fwd(
            feats.data_ptr(), plan.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
            mask.data_ptr(), out.data_ptr(), feats.shape[0], cin, cout, kk, stream) != 0
        k4 = native.load("row_conv_wgrad", row_conv._WGRAD_FUNCTIONS)
        dw = torch.empty((kk, cin, cout), device="cuda")
        db = torch.empty(cout, device="cuda")
        assert k4.subm_conv_rows_wgrad_taps(
            feats.data_ptr(), plan.data_ptr(), g.data_ptr(), mask.data_ptr(), None,
            dw.data_ptr(), db.data_ptr(), feats.shape[0], cin, cout, kk, stream) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,cin,cout", [(1, 1, 1), (127, 2, 8), (128, 2, 8), (129, 2, 8),
                                        (5000, 3, 5), (97214, 2, 8), (97214, 8, 8),
                                        (97214, 16, 16), (10 ** 6, 2, 8), (300, 0, 1)])
def test_wgrad_taps_geometry_on_card(cuda, n, cin, cout):
    """K4's taps grid, as ``subm_conv_rows_wgrad_taps_scratch`` sizes it on
    this card, covers the rows with no empty block, in whole 128-row
    chunks, in one wave of two blocks an SM at most; its scratch is a
    partial a block and stays near 2^19 floats unless that would leave an
    SM idle."""
    import ctypes

    lib = native.load("row_conv_wgrad", row_conv._WGRAD_FUNCTIONS)
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count

    def scratch(rows_n):
        blocks, rows, floats = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
        assert lib.subm_conv_rows_wgrad_taps_scratch(
            rows_n, cin, cout, ctypes.byref(blocks), ctypes.byref(rows),
            ctypes.byref(floats)) == 0
        return blocks.value, rows.value, floats.value

    blocks, rows, floats = scratch(n)
    per = (TAP_KK * cin + 1) * cout
    assert rows % 128 == 0 and rows > 0
    assert (blocks - 1) * rows < n <= blocks * rows
    assert blocks <= 2 * sms and floats == blocks * per
    assert floats <= max(1 << 19, sms * per) or blocks == -(-n // 128)
    assert scratch(0) == (0, 0, 0)
