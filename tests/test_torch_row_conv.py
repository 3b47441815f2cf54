"""Kernel K1's plain version against the JAX ``subm_conv_rows`` (fp32, with
absent taps and padding rows, and on adversarial plans: full 3×3 clusters,
duplicate sites, single-site events, a row count that is not a multiple of
the kernel's tile, narrow and wide channel counts), the wrapper's CPU
dispatch and checks, and the kernel against its plain version on the card
on the same inputs."""
import numpy as np
import pytest
import torch

from waveformml_tpu_torch.datasets.synthetic import conv_case as synthetic_conv_case
from waveformml_tpu_torch.ops.row_conv import (host_neighbor_plan, subm_conv_rows,
                                               subm_conv_rows_plain, take_row_taps)

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
