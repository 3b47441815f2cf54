"""The benchmark's traffic generator: vectorised numpy copies of the
synthetic detector events of ``waveformml_tpu_torch/datasets/synthetic.py``
(``make_events``, ``segment_block``, ``rows_3d``, ``labelled_block_3d``),
which draw event by event in Python.

Every chunk is drawn from ``--seed`` alone. A traffic mix (``traffic/<mix>.json``)
sets the events a chunk, the multiplicities and how many distinct chunks the
pool holds; the configuration's input form (``forms/<form>.py``, named by its
``input.form``) turns events into a chunk as its dataset gives it, with the
samples of a waveform that the configuration sets.

Where the synthetic module draws each event's multiplicity and particle kind
independently, every chunk here holds the same multiset of multiplicities
(and of kinds) in a seeded order, so that every seed asks for the same amount
of work: the shapes the program pads to do not move from seed to seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

# the detector's geometry and scales (waveformml_tpu_torch/detector.py)
NX, NY = 14, 11
MAX_RANGE = 2 ** 14 - 1
Z_SCALE = 1200.0


@dataclass
class Chunk:
    """One chunk as the program's dataset gives it: coords ``[N, 3]`` (x,
    y, event) or ``[N, 4]`` (x, y, t, event), features ``[N, F]`` float32,
    labels (``[B]`` event kinds or ``[N]`` row targets), and its event
    count."""

    coords: np.ndarray
    feats: np.ndarray
    labels: np.ndarray
    n_events: int


def multiplicities(rng: np.random.Generator, n_events: int, lo: int, hi: int) -> np.ndarray:
    """Pulses an event, in [lo, hi]: each value equally often, in a random
    order."""
    return rng.permutation(np.resize(np.arange(lo, hi + 1), n_events))


def particle_kinds(rng: np.random.Generator, n_events: int) -> np.ndarray:
    """0 or 1 an event: half of each, in a random order."""
    return rng.permutation(np.resize(np.arange(2), n_events))


def make_events(rng: np.random.Generator, mult: np.ndarray, n_samples: int,
                kinds: np.ndarray) -> Dict[str, np.ndarray]:
    """``make_events`` over many events at once: each event ``e`` has
    ``mult[e]`` pulses at distinct sites and particle kind ``kinds[e]``;
    coords ``[P, 3]`` (x, y, event), waveforms ``[P, 2·n_samples]`` on the
    ADC scale (left PMT's samples, then right's: an exponential-tail pulse
    whose left/right amplitude ratio encodes z and whose tail fraction the
    kind), per-pulse z."""
    n_events = mult.shape[0]
    n_sites = NX * NY
    # distinct sites an event: the first mult of a random permutation of the grid
    order = np.argsort(rng.random((n_events, n_sites)), axis=1)
    take = np.arange(n_sites)[None, :] < mult[:, None]
    sites = order[take]
    event = np.repeat(np.arange(n_events), mult)
    p = sites.shape[0]
    energy = rng.uniform(0.5, 10.0, p)
    z = rng.uniform(-Z_SCALE / 2, Z_SCALE / 2, p)
    t0 = 6.0 + rng.uniform(-1, 1, p)
    f32 = np.float32
    t = np.arange(n_samples, dtype=f32)[None, :]
    dt = np.clip(t - t0[:, None].astype(f32), 0, None)
    rise = dt / f32(1.5)
    tail = (0.12 + 0.25 * kinds[event]).astype(f32)[:, None]
    shape = (1 - np.exp(-rise)) * ((1 - tail) * np.exp(-dt / f32(3.0))
                                    + tail * np.exp(-dt / f32(25.0)))
    zn = (z / (Z_SCALE / 2)).astype(f32)[:, None]
    amp = (energy * (MAX_RANGE / 40.0)).astype(f32)[:, None]
    noise = rng.standard_normal((p, 2, n_samples), dtype=f32) * f32(12)
    left = amp * np.exp(-zn * f32(0.8)) * shape + noise[:, 0]
    right = amp * np.exp(zn * f32(0.8)) * shape + noise[:, 1]
    wf = np.clip(np.concatenate([left, right], axis=1), 0, MAX_RANGE)
    coords = np.stack([sites % NX, sites // NX, event], axis=1).astype(np.int32)
    return {"coords": coords, "waveforms": wf, "z": z.astype(np.float32)}


def rows_3d(coords: np.ndarray, waveforms: np.ndarray, n_samples: int,
            threshold: float = 30.0):
    """``rows_3d``: one row per pulse and time sample where either PMT
    clears ``threshold`` (the largest sample where none does), coords
    ``[N, 4]`` (x, y, t, event), the two PMTs' samples ``[N, 2]``, sorted by
    (event, x, y, t)."""
    wf = waveforms.reshape(-1, 2, n_samples)
    peak = wf.max(axis=1)                               # [P, S]
    keep = peak > threshold
    none = ~keep.any(axis=1)
    keep[np.flatnonzero(none), peak[none].argmax(axis=1)] = True
    p, t = np.nonzero(keep)
    c = np.stack([coords[p, 0], coords[p, 1], t, coords[p, 2]], axis=1).astype(np.int32)
    w = wf[p, :, t].astype(np.float32)
    order = np.lexsort((c[:, 2], c[:, 1], c[:, 0], c[:, 3]))
    return c[order], w[order]


def make_pool(seed: int, form: str, n_samples: int, traffic: Dict) -> List[Chunk]:
    """The mix's pool of distinct chunks for ``seed``: ``traffic["pool"]``
    chunks of ``traffic["events"]`` events, each made by the input form
    ``forms/<form>.py``."""
    from portbench.harness import load_module

    make_chunk = load_module("forms", form).make_chunk
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    return [make_chunk(rng, int(traffic["events"]), n_samples, traffic)
            for _ in range(int(traffic["pool"]))]
