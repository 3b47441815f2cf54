"""Synthetic detector events for tests and the chip smoke run (numpy only;
counterpart of the generators in waveformml_tpu/datasets/synthetic.py).

Waveforms are exponential-tail scintillation pulses on the raw ADC scale
whose left/right amplitude ratio encodes z and whose tail fraction depends
on the particle kind (the PSD handle).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from waveformml_tpu_torch.detector import MAX_RANGE, NX, NY, Z_SCALE


def synth_waveform_pair(rng: np.random.Generator, n_samples: int, energy: float,
                        z: float, kind: int = 0) -> np.ndarray:
    """One PMT pair's waveform [2*n_samples] (left samples, then right),
    values in [0, MAX_RANGE]."""
    t = np.arange(n_samples, dtype=np.float32)
    t0 = 6.0 + rng.uniform(-1, 1)
    rise = np.clip((t - t0) / 1.5, 0, None)
    fast = np.exp(-np.clip(t - t0, 0, None) / 3.0)
    slow = np.exp(-np.clip(t - t0, 0, None) / 25.0)
    tail_frac = 0.12 + 0.25 * kind  # particle-dependent slow component
    shape = (1 - np.exp(-rise)) * ((1 - tail_frac) * fast + tail_frac * slow)
    zn = z / (Z_SCALE / 2)  # [-1, 1]
    amp_l = energy * np.exp(-zn * 0.8)
    amp_r = energy * np.exp(+zn * 0.8)
    scale = MAX_RANGE / 40.0
    wf_l = amp_l * scale * shape + rng.normal(0, 12, n_samples)
    wf_r = amp_r * scale * shape + rng.normal(0, 12, n_samples)
    return np.clip(np.concatenate([wf_l, wf_r]), 0, MAX_RANGE).astype(np.float32)


def make_events(rng: np.random.Generator, n_events: int, n_samples: int,
                kind: int = 0, max_mult: int = 4,
                start_event: int = 0) -> Dict[str, np.ndarray]:
    """Sparse events with 1..max_mult pulses each at distinct sites: coords
    [N, 3] (x, y, event), waveforms [N, 2·n_samples], per-pulse E and z."""
    coords, wfs, es, zs = [], [], [], []
    for e in range(n_events):
        mult = int(rng.integers(1, max_mult + 1))
        sites = rng.choice(NX * NY, size=mult, replace=False)
        for s in sites:
            x, y = int(s % NX), int(s // NX)
            energy = float(rng.uniform(0.5, 10.0))
            z = float(rng.uniform(-Z_SCALE / 2, Z_SCALE / 2))
            coords.append([x, y, start_event + e])
            wfs.append(synth_waveform_pair(rng, n_samples, energy, z, kind))
            es.append(energy)
            zs.append(z)
    return {
        "coords": np.asarray(coords, dtype=np.int32),
        "waveforms": np.stack(wfs),
        "E": np.asarray(es, dtype=np.float32),
        "z": np.asarray(zs, dtype=np.float32),
    }
