"""Kernel K3's plain version against the JAX ``waveform_features_jax`` and
the Pallas kernel ``waveform_features_pallas`` (run in interpret mode), on
pulse-shaped and adversarial rows, and the CUDA kernel against its plain
version on the card, on the same rows and on rows with a gap between them,
with total and psd held to a tolerance scaled by each row's condition
number (``features_close``)."""
import numpy as np
import pytest
import torch

from waveformml_tpu_torch.datasets.synthetic import adversarial_waveforms
from waveformml_tpu_torch.ops.waveform_features import (features_close,
                                                        launch_geometry,
                                                        waveform_features,
                                                        waveform_features_plain)

# the detector's sample counts (59, 65, 130, 150) and a power of two
S_VALUES = [65, 128, 150, 59, 130]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel K3 runs only on the card")
    return torch.device("cuda")


def _pulses(rng, n, s):
    t = np.arange(s, dtype=np.float64)
    out = []
    for _ in range(n):
        t0, amp, tail = rng.uniform(8, 40), rng.uniform(50, 400), rng.uniform(0.1, 0.4)
        dt = np.clip(t - t0, 0, None)
        shape = (1 - np.exp(-dt / 1.5)) * ((1 - tail) * np.exp(-dt / 3.0)
                                          + tail * np.exp(-dt / 25.0))
        out.append(amp * shape + rng.normal(0, 0.5, s).clip(0))
    return np.stack(out)


def _rows(rng, s, n_pulses=40, n_adv=56):
    return np.concatenate([_pulses(rng, n_pulses, s),
                           adversarial_waveforms(rng, n_adv, s)]).astype(np.float32)


def _plain(wfs):
    return [x.numpy() for x in waveform_features_plain(torch.from_numpy(wfs))]


@pytest.mark.parametrize("s", S_VALUES)
def test_plain_matches_jax(rng, s):
    from waveformml_tpu.ops.pallas_dsp import waveform_features_jax

    wfs = _rows(rng, s)
    want = [np.asarray(x) for x in waveform_features_jax(wfs)]
    for name, g, w in zip(("arrival", "psd", "total", "peak"), _plain(wfs), want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("s", S_VALUES)
def test_plain_matches_pallas_interpret(rng, s):
    from jax.experimental.pallas import tpu as pltpu

    from waveformml_tpu.ops.pallas_dsp import waveform_features_pallas

    wfs = _rows(rng, s, n_pulses=20, n_adv=24)   # n not a multiple of TILE_N
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(x) for x in waveform_features_pallas(wfs)]
    for name, g, w in zip(("arrival", "psd", "total", "peak"), _plain(wfs), want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)


def test_wrapper_uses_plain_on_cpu(rng):
    wfs = torch.from_numpy(_rows(rng, 65, 5, 8))
    before = waveform_features.launches
    for g, w in zip(waveform_features(wfs), waveform_features_plain(wfs)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert waveform_features.launches == before
    # odd shared-memory row strides; 128 rows a block while they fit
    assert launch_geometry(65) == (128, 65, 128 * 65 * 4)
    assert launch_geometry(150) == (128, 151, 128 * 151 * 4)
    rows, stride, smem = launch_geometry(1000)
    assert stride == 1001 and rows % 32 == 0 and rows < 128 and smem <= 232448


@pytest.mark.parametrize("s", S_VALUES)
def test_features_close_scales_psd_by_condition(rng, s):
    """Features whose sums are rounded once (float64, then fp32) pass
    against the fp32 plain version on every row, cancelling ones included;
    a psd moved by 1e-4 on a well-conditioned pulse row does not."""
    wfs = torch.from_numpy(_rows(rng, s))
    want = waveform_features_plain(wfs)
    once = [x.to(torch.float32) for x in waveform_features_plain(wfs.double())]
    features_close(once, want, wfs, 1e-5)
    moved = list(once)
    moved[1] = once[1].clone()
    moved[1][0] += 1e-4
    with pytest.raises(AssertionError, match="psd row 0"):
        features_close(moved, want, wfs, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("s", S_VALUES)
def test_kernel_matches_plain_on_card(cuda, s):
    rng = np.random.default_rng(12345)
    wfs = torch.from_numpy(_rows(rng, s, 300, 301)).to(cuda)  # ragged last block
    want = waveform_features_plain(wfs)
    before = waveform_features.launches
    got = waveform_features(wfs)
    torch.cuda.synchronize()
    assert waveform_features.launches == before + 1
    features_close(got, want, wfs, 1e-5)
    # rows 3 samples apart in memory: the kernel's general-stride staging
    gapped = torch.zeros(wfs.shape[0], s + 3, device=cuda)
    gapped[:, :s] = wfs
    strided = gapped[:, :s]
    assert strided.stride(0) > s
    features_close(waveform_features(strided), want, wfs, 1e-5)
