"""Synthetic detector events for tests and the chip smoke run (numpy only;
counterpart of the generators in waveformml_tpu/datasets/synthetic.py).

Waveforms are exponential-tail scintillation pulses on the raw ADC scale
whose left/right amplitude ratio encodes z and whose tail fraction depends
on the particle kind (the PSD handle).
"""
from __future__ import annotations

from typing import Dict, Optional

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


def conv_case(rng: np.random.Generator, kind: str, n_events: int, k: int,
              cin: int, cout: int, n_rows: Optional[int] = None):
    """Inputs of a row-space SubM conv over sites that stress it, all numpy:
    coords [n_rows, 3] int32 (x, y, event; the neighbour plan is built from
    them), feats [n_rows, cin] (zero on padding rows), kernel [k², cin,
    cout], bias [cout] and the row mask, padding rows at the end.

    ``kind``: ``"clustered"`` (1-5 sites near one spot per event, so many
    taps present and some absent), ``"dense_cluster"`` (a full 3×3 block of
    sites per event, so a centre row has all 9 taps), ``"duplicate_sites"``
    (clustered, about a quarter of the rows repeated: the neighbour plan
    keeps the last row of a site, so the centre tap of the first copy names
    another row) or ``"isolated_sites"`` (one site per event, so every
    off-centre tap is absent). ``n_rows`` defaults to the rows + 11."""
    if kind not in ("clustered", "dense_cluster", "duplicate_sites", "isolated_sites"):
        raise ValueError(f"unknown conv case {kind!r}")
    rows = []
    for e in range(n_events):
        if kind == "dense_cluster":
            x0, y0 = int(rng.integers(0, NX - 2)), int(rng.integers(0, NY - 2))
            rows += [[x0 + dx, y0 + dy, e] for dx in range(3) for dy in range(3)]
            continue
        x0, y0 = int(rng.integers(0, NX)), int(rng.integers(0, NY))
        n_sites = 1 if kind == "isolated_sites" else int(rng.integers(1, 6))
        for _ in range(n_sites):
            rows.append([int(np.clip(x0 + rng.integers(-2, 3), 0, NX - 1)),
                         int(np.clip(y0 + rng.integers(-2, 3), 0, NY - 1)), e])
    coords = np.unique(np.asarray(rows, np.int32), axis=0)
    coords = coords[np.argsort(coords[:, 2], kind="stable")]
    if kind == "duplicate_sites":
        coords = np.repeat(coords, 1 + (rng.random(coords.shape[0]) < 0.25), axis=0)
    n = coords.shape[0]
    n_rows = n_rows or n + 11
    if n_rows < n:
        raise ValueError(f"{n} rows do not fit n_rows={n_rows}")
    c = np.zeros((n_rows, 3), np.int32)
    c[:n] = coords
    mask = np.zeros(n_rows, bool)
    mask[:n] = True
    feats = rng.normal(size=(n_rows, cin)).astype(np.float32)
    feats[n:] = 0
    kernel = (rng.normal(size=(k * k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    return c, feats, kernel, bias, mask


SITE_LAYOUT_FEATURES = ("duplicate_sites", "stitched_groups", "events_past_end",
                        "ragged_max")


def site_layout_case(rng: np.random.Generator, features, n_events: int, c: int, f: int):
    """Inputs of the site-grouped head on a slot layout made by hand to
    stress it, all numpy: rows [N, c] (11 zero padding rows at the end), k3
    [c, S, f], take1 and ev1 [G, MAX] int32 (1-based, 0 = empty), site1 [G]
    int32 (1-based) and bias [f].

    Every such layout has its filled slots at random places in their groups
    (not a prefix), rows in no event order, empty slots that name an event
    and filled slots that name none (both add nothing). ``features`` adds
    any of ``"duplicate_sites"`` (a third of the events have two rows at one
    site, so one group adds two slots into one event row),
    ``"stitched_groups"`` (G = 2·S + 7, as a stitched multi-host layout
    has: every site twice, and 7 groups whose site lies outside [1, S] and
    is clamped), ``"events_past_end"`` (a tenth of the filled slots name an
    event past ``n_events``: dropped) and ``"ragged_max"`` (MAX = 600, not a
    power of two, with each group's filled slots in its last 2·(largest
    group) ≤ 300 slots, so that the first 300 slots of every group, a whole
    tile of the CUDA kernel, are empty)."""
    unknown = set(features) - set(SITE_LAYOUT_FEATURES)
    if unknown:
        raise ValueError(f"unknown site layout features {sorted(unknown)}")
    s = NX * NY
    sites, events = [], []
    for e in range(n_events):
        at = rng.choice(s, size=int(rng.integers(1, 5)), replace=False)
        if "duplicate_sites" in features and rng.random() < 1 / 3:
            at = np.append(at, at[0])
        sites.append(at)
        events.append(np.full(at.shape, e))
    order = rng.permutation(sum(a.size for a in sites))
    sites = np.concatenate(sites)[order]
    events = np.concatenate(events)[order]
    n = sites.size
    if "events_past_end" in features:
        events = np.where(rng.random(n) < 0.1, n_events + rng.integers(0, 50, n), events)
    site1 = np.arange(1, s + 1)
    if "stitched_groups" in features:
        site1 = np.concatenate([site1, rng.permutation(site1),
                                [0, -3, s + 1, s + 9, 0, s + 2, 2 * s]])
    # each row goes to one of the groups of its site
    by_site = [np.flatnonzero(np.clip(site1 - 1, 0, s - 1) == k) for k in range(s)]
    group = np.asarray([rng.choice(by_site[k]) for k in sites])
    counts = np.bincount(group, minlength=site1.size)
    span = 2 * int(counts.max())
    max_slots = 600 if "ragged_max" in features else span
    if span > max_slots // 2 and "ragged_max" in features:
        raise ValueError(f"{n_events} events overflow the last half of MAX={max_slots}")
    take = np.zeros((site1.size, max_slots), np.int32)
    ev = np.zeros((site1.size, max_slots), np.int32)
    for g in np.flatnonzero(counts):
        rows_g = np.flatnonzero(group == g)
        slots = max_slots - span + rng.choice(span, size=rows_g.size, replace=False)
        take[g, slots] = rows_g + 1
        ev[g, slots] = events[rows_g] + 1
    filled = take > 0
    stray = ~filled & (rng.random(take.shape) < 0.05)
    ev[stray] = rng.integers(1, n_events + 1, size=int(stray.sum()))
    ev[filled & (rng.random(take.shape) < 0.03)] = 0
    rows = np.zeros((n + 11, c), np.float32)
    rows[:n] = rng.normal(size=(n, c))
    k3 = (rng.normal(size=(c, s, f)) / np.sqrt(c * s)).astype(np.float32)
    bias = rng.normal(size=(f,)).astype(np.float32)
    return rows, k3, take, ev, site1.astype(np.int32), bias


def adversarial_waveforms(rng: np.random.Generator, n: int, s: int) -> np.ndarray:
    """Rows [n, s] float64 that stress the waveform features: zeros,
    constant, delta spike, plateau, signed noise, sharp onset, tie comb and
    early onset, in turn."""
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
