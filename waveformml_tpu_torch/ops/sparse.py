"""Padded sparse detector batches (counterpart of waveformml_tpu/ops/sparse.py).

A batch of events is ``[N, 3]`` int32 coords (x, y, event), ``[N, F]``
features and an ``[N]`` bool mask, padded to a bucketed ``N`` so that the
number of distinct shapes stays small. The host-side helpers are numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SparseBatch:
    """coords [N, 3] int32 (x, y, event; padding rows 0), feats [N, F],
    mask [N] bool (True for real rows), ``n_events`` the padded event count,
    and ``plans``: the host-built ``{"k3": [N, 9] int32, "k1": ...,
    "site_take": [S, MAX] int32, ...}`` the row convs and the head consume."""

    coords: torch.Tensor
    feats: torch.Tensor
    mask: torch.Tensor
    n_events: int
    plans: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def bucket_size(n: int, buckets: Tuple[int, ...] = (
        256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096, 6144, 8192, 12288,
        16384, 24576, 32768, 49152, 65536)) -> int:
    """Smallest bucket ≥ n; beyond the table, the next power of two. The
    table interleaves 3·2^k sizes between powers of two, so padding wastes
    at most 25% of the rows."""
    for b in buckets:
        if n <= b:
            return b
    return 1 << (int(n) - 1).bit_length()


def pad_sparse(coords: np.ndarray, feats: np.ndarray, n_rows: int,
               labels: Optional[np.ndarray] = None, label_pad: float = 0):
    """Pad ragged (coords, feats[, labels]) on the host to n_rows rows."""
    n = coords.shape[0]
    if n > n_rows:
        raise ValueError(f"batch has {n} rows > bucket {n_rows}")
    mask = np.zeros(n_rows, dtype=bool)
    mask[:n] = True
    c = np.zeros((n_rows, coords.shape[1]), dtype=np.int32)
    c[:n] = coords
    f = np.zeros((n_rows, feats.shape[1]), dtype=feats.dtype)
    f[:n] = feats
    if labels is None:
        return c, f, mask
    l = np.full((n_rows,) + labels.shape[1:], label_pad, dtype=labels.dtype)
    l[:n] = labels
    return c, f, mask, l


def consecutive_event_index(event_col: np.ndarray) -> np.ndarray:
    """Renumber an event-id column into consecutive 0..B-1 indices by
    change detection (ids need not be contiguous, only grouped)."""
    ev = np.asarray(event_col)
    if ev.size == 0:
        return ev.astype(np.int64)
    change = np.ones(ev.shape[0], dtype=np.int64)
    change[1:] = (ev[1:] != ev[:-1]).astype(np.int64)
    return np.cumsum(change) - 1
