"""Occupied sites and present taps of a chunk, counted from its rows with
numpy: the work the layers' sparse semantics ask for, whatever grid or
plan an implementation computes on."""
from __future__ import annotations

import itertools

import numpy as np

NX, NY = 14, 11


def site_keys(coords: np.ndarray, n_t: int = 0) -> np.ndarray:
    """The distinct occupied sites, as sorted keys ``(event·NX + x)·NY + y``
    (``·T + t`` for (x, y, t, event) rows)."""
    c = coords.astype(np.int64)
    key = (c[:, -1] * NX + c[:, 0]) * NY + c[:, 1]
    if n_t:
        key = key * n_t + c[:, 2]
    return np.unique(key)


def _split(keys: np.ndarray, n_t: int):
    t = None
    if n_t:
        t, keys = keys % n_t, keys // n_t
    return keys // (NX * NY), (keys // NY) % NX, keys % NY, t


def shifted(keys: np.ndarray, offset, n_t: int = 0):
    """``keys`` moved by ``offset`` and whether the moved site is on the grid."""
    e, x, y, t = _split(keys, n_t)
    x, y = x + offset[0], y + offset[1]
    ok = (x >= 0) & (x < NX) & (y >= 0) & (y < NY)
    key = (e * NX + x) * NY + y
    if n_t:
        t = t + offset[2]
        ok &= (t >= 0) & (t < n_t)
        key = key * n_t + t
    return key, ok


def contains(sorted_keys: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Whether each of ``keys`` is among the sorted, distinct ``sorted_keys``."""
    pos = np.searchsorted(sorted_keys, keys).clip(max=max(sorted_keys.shape[0] - 1, 0))
    return sorted_keys[pos] == keys


def offsets(k: int, ndim: int):
    r = range(-(k // 2), k // 2 + 1)
    return list(itertools.product(*[r] * ndim))


def present_taps(in_keys: np.ndarray, out_keys: np.ndarray, k: int, ndim: int,
                 n_t: int = 0) -> int:
    """Pairs of (output site, tap) whose input site is occupied, for a
    stride-1 window of k^ndim centred on each output site."""
    total = 0
    for off in offsets(k, ndim):
        key, ok = shifted(out_keys, off, n_t)
        total += int(contains(in_keys, key[ok]).sum())
    return total


def dilated(in_keys: np.ndarray, k: int, ndim: int, n_t: int = 0) -> np.ndarray:
    """The sites whose k^ndim window holds an occupied input site."""
    out = []
    for off in offsets(k, ndim):
        key, ok = shifted(in_keys, off, n_t)
        out.append(key[ok])
    return np.unique(np.concatenate(out))
