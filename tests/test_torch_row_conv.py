"""Kernel K1's plain version against the JAX ``subm_conv_rows`` (fp32, with
absent taps and padding rows), the wrapper's CPU dispatch and checks, and
the kernel against its plain version on the card."""
import numpy as np
import pytest
import torch

from waveformml_tpu_torch.ops.row_conv import (host_neighbor_plan, subm_conv_rows,
                                               subm_conv_rows_plain)

NX, NY = 14, 11


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel K1 runs only on the card")
    return torch.device("cuda")


def _case(rng, n_events, k, cin, cout, n_rows=None):
    rows = []
    for e in range(n_events):
        # clustered sites so that many taps are present, some absent
        x0, y0 = int(rng.integers(0, NX)), int(rng.integers(0, NY))
        for _ in range(int(rng.integers(1, 6))):
            rows.append([int(np.clip(x0 + rng.integers(-2, 3), 0, NX - 1)),
                         int(np.clip(y0 + rng.integers(-2, 3), 0, NY - 1)), e])
    coords = np.unique(np.asarray(rows, np.int32), axis=0)
    coords = coords[np.argsort(coords[:, 2], kind="stable")]
    n = coords.shape[0]
    n_rows = n_rows or n + 11                    # padding rows at the end
    c = np.zeros((n_rows, 3), np.int32)
    c[:n] = coords
    mask = np.zeros(n_rows, bool)
    mask[:n] = True
    plan = host_neighbor_plan(c, mask, n_events, k)
    feats = rng.normal(size=(n_rows, cin)).astype(np.float32)
    feats[n:] = 0
    kernel = (rng.normal(size=(k * k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    return feats, plan, kernel, bias, mask


@pytest.mark.parametrize("k,cin,cout", [(3, 130, 104), (3, 104, 56), (1, 56, 8),
                                        (3, 5, 3)])
@pytest.mark.parametrize("with_bias", [True, False])
def test_plain_matches_jax(rng, k, cin, cout, with_bias):
    import jax.numpy as jnp

    from waveformml_tpu.ops.row_conv import subm_conv_rows as jax_subm_conv_rows

    feats, plan, kernel, bias, mask = _case(rng, 12, k, cin, cout)
    assert (plan == -1).any()
    assert k == 1 or ((plan >= 0).sum(1) > 1).any()
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
    feats, plan, kernel, bias, mask = (torch.from_numpy(a)
                                       for a in _case(rng, 6, 3, 7, 4))
    before = subm_conv_rows.launches
    got = subm_conv_rows(feats, plan, kernel, bias, mask)
    torch.testing.assert_close(got, subm_conv_rows_plain(feats, plan, kernel,
                                                         bias, mask),
                               rtol=0, atol=0)
    assert subm_conv_rows.launches == before
    with pytest.raises(ValueError, match="shape"):
        subm_conv_rows(feats, plan[:, :4], kernel, bias, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("k,cin,cout", [(3, 130, 104), (3, 104, 56), (1, 56, 8)])
def test_kernel_matches_plain_on_card(cuda, k, cin, cout):
    rng = np.random.default_rng(12345)
    torch.backends.cuda.matmul.allow_tf32 = False
    args = [torch.from_numpy(a).to(cuda) for a in _case(rng, 300, k, cin, cout)]
    want = subm_conv_rows_plain(*args)
    before = subm_conv_rows.launches
    got = subm_conv_rows(*args)
    torch.cuda.synchronize()
    assert subm_conv_rows.launches == before + 1
    # fp32 throughout; only the summation order over K²·Cin terms differs
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
