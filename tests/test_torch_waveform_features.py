"""Kernel K3's plain version against the JAX ``waveform_features_jax`` and
the Pallas kernel ``waveform_features_pallas`` (run in interpret mode), on
pulse-shaped and adversarial rows, and the Triton kernel against its plain
version on the card."""
import numpy as np
import pytest
import torch

from waveformml_tpu_torch.ops.waveform_features import (block_sizes,
                                                        waveform_features,
                                                        waveform_features_plain)

S_VALUES = [65, 128, 150]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: Triton kernel K3 runs only on the card")
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


def _adversarial(rng, n, s):
    """zeros, constant, delta spike, plateau, signed noise, sharp onset,
    tie comb and early onset, in turn."""
    t = np.arange(s, dtype=np.float64)
    out = []
    for i in range(n):
        kind = i % 8
        w = np.zeros(s)
        if kind == 1:
            w[:] = rng.uniform(0, 10)
        elif kind == 2:
            w[int(rng.integers(0, s))] = 100
        elif kind == 3:
            a = int(rng.integers(0, s - 6))
            w[a:a + 5] = 50.0
        elif kind == 4:
            w = rng.normal(0, 1, s)
        elif kind == 5:
            t0 = rng.uniform(1, s - 2)
            w = 100 * np.exp(-np.clip(t - t0, 0, None) / 5) * (t >= t0)
        elif kind == 6:
            w = np.resize([0.0, 30.0], s)
        elif kind == 7:
            dt = np.clip(t - 8, 0, None)
            w = rng.uniform(10, 300) * (1 - np.exp(-dt / 1.5)) * np.exp(-dt / 12)
        out.append(w)
    return np.stack(out)


def _rows(rng, s, n_pulses=40, n_adv=56):
    return np.concatenate([_pulses(rng, n_pulses, s),
                           _adversarial(rng, n_adv, s)]).astype(np.float32)


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
    assert block_sizes(65) == (16, 128) and block_sizes(150) == (8, 256)


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
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
