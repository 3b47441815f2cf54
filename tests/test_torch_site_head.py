"""Kernel K2's plain version against the JAX ``site_grouped_matmul`` (fp32,
with empty slots, padding rows, zero-padded capacity and extra empty
groups), the wrapper's CPU dispatch, and the kernel against its plain
version on the card."""
import numpy as np
import pytest
import torch

from waveformml_tpu_torch.ops.site_head import (host_site_layout,
                                                site_grouped_matmul,
                                                site_grouped_matmul_plain)

NX, NY = 14, 11
S = NX * NY


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


@pytest.mark.parametrize("n_events,c,f,pad_slots,extra_groups", [
    (40, 8, 50, 0, 0), (40, 8, 50, 16, 0), (40, 8, 50, 0, 7), (300, 3, 5, 0, 0)])
def test_plain_matches_jax(rng, n_events, c, f, pad_slots, extra_groups):
    import jax.numpy as jnp

    from waveformml_tpu.ops.site_head import site_grouped_matmul as jax_site_matmul

    rows, k3, take, ev, site, n_ev = _case(rng, n_events, c, f,
                                           pad_slots=pad_slots,
                                           extra_groups=extra_groups)
    assert (take == 0).any()
    want = np.asarray(jax_site_matmul(jnp.asarray(rows), jnp.asarray(k3),
                                      jnp.asarray(take), jnp.asarray(ev),
                                      jnp.asarray(site), n_ev))
    got = site_grouped_matmul_plain(*(torch.from_numpy(a) for a in
                                      (rows, k3, take, ev, site)), n_ev).numpy()
    assert got.shape == (n_ev, f) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[-1] == 0).all()


def test_plain_drops_events_past_n_events(rng):
    import jax.numpy as jnp

    from waveformml_tpu.ops.site_head import site_grouped_matmul as jax_site_matmul

    rows, k3, take, ev, site, n_ev = _case(rng, 20, 4, 6)
    args = [torch.from_numpy(a) for a in (rows, k3, take, ev, site)]
    full = site_grouped_matmul_plain(*args, n_ev)
    cut = site_grouped_matmul_plain(*args, 5)
    want = np.asarray(jax_site_matmul(*(jnp.asarray(a) for a in
                                        (rows, k3, take, ev, site)), 5))
    np.testing.assert_allclose(cut.numpy(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cut, full[:5], rtol=0, atol=0)


def test_wrapper_uses_plain_on_cpu(rng):
    args = [torch.from_numpy(a) for a in _case(rng, 10, 4, 6)[:5]]
    before = site_grouped_matmul.launches
    got = site_grouped_matmul(*args, 11)
    torch.testing.assert_close(got, site_grouped_matmul_plain(*args, 11),
                               rtol=0, atol=0)
    assert site_grouped_matmul.launches == before
    with pytest.raises(ValueError, match="shape"):
        site_grouped_matmul(args[0], args[1], args[2], args[3][:, :2], args[4], 11)


@pytest.mark.cuda
@pytest.mark.parametrize("n_events", [64, 4096])
def test_kernel_matches_plain_on_card(cuda, n_events):
    rng = np.random.default_rng(12345)
    torch.backends.cuda.matmul.allow_tf32 = False
    *arrays, n_ev = _case(rng, n_events, 8, 50)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    want = site_grouped_matmul_plain(*args, n_ev)
    before = site_grouped_matmul.launches
    got = site_grouped_matmul(*args, n_ev)
    torch.cuda.synchronize()
    assert site_grouped_matmul.launches == before + 1
    # the fp32 atomics add an event's few rows in a varying order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
