"""Padded sparse detector batches (counterpart of waveformml_tpu/ops/sparse.py).

A batch of events is ``[N, 3]`` int32 coords (x, y, event), ``[N, F]``
features and an ``[N]`` bool mask, padded to a bucketed ``N`` so that the
number of distinct shapes stays small. The host-side helpers are numpy.
The dense-grid helpers (``scatter_to_dense``, ``occupancy_mask``,
``gather_from_dense``) move rows to and from the ``[B, NX, NY, F]``
detector grid on the device; the 3D nets' batches have ``[N, 4]`` coords
(x, y, t, event) and their ``*_3d`` helpers the ``[B, NX, NY, T, F]``
grid.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from waveformml_tpu_torch.detector import NX, NY


@dataclasses.dataclass(frozen=True)
class SparseBatch:
    """coords [N, 3] int32 (x, y, event; padding rows 0), or [N, 4] (x, y,
    t, event) for the 3D nets, the event always the last column; feats [N, F],
    mask [N] bool (True for real rows), ``n_events`` the padded event count,
    and ``plans``: the host-built ``{"k3": [N, 9] int32, "k1": ...,
    "site_take": [S, MAX] int32, ...}`` the row convs and the head consume;
    ``generator`` the random stream that dropout draws from in train mode
    (None in eval mode)."""

    coords: torch.Tensor
    feats: torch.Tensor
    mask: torch.Tensor
    n_events: int
    plans: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    generator: Optional[torch.Generator] = None

    @property
    def t(self) -> torch.Tensor:
        """The time-sample coordinate of a 3D batch."""
        if self.coords.shape[1] != 4:
            raise ValueError("t needs 4-column (x, y, t, event) coords")
        return self.coords[:, 2]


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


# -- the dense [B, NX, NY, F] grid of a batch -------------------------------------

def flat_site(batch: SparseBatch) -> torch.Tensor:
    """Each row's (event, x, y) index into a flat ``[B·NX·NY]`` grid, int64;
    padding rows, and rows outside the grid, get ``B·NX·NY``, one past its
    end, where the scatters below drop them."""
    c = batch.coords.long()
    size = batch.n_events * NX * NY
    idx = c[:, -1] * (NX * NY) + c[:, 0] * NY + c[:, 1]
    keep = batch.mask & (idx >= 0) & (idx < size)
    return torch.where(keep, idx, torch.full_like(idx, size))


def scatter_to_dense(batch: SparseBatch, feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The batch's features (or ``feats``, ``[N, F]``) on the dense grid,
    ``[B, NX, NY, F]``: two rows of one event at one site are summed,
    padding rows dropped."""
    f = batch.feats if feats is None else feats
    size = batch.n_events * NX * NY
    src = torch.where(batch.mask[:, None], f, torch.zeros((), dtype=f.dtype, device=f.device))
    flat = f.new_zeros(size + 1, f.shape[-1]).index_add(0, flat_site(batch), src)
    return flat[:size].view(batch.n_events, NX, NY, f.shape[-1])


def occupancy_mask(batch: SparseBatch) -> torch.Tensor:
    """``[B, NX, NY]`` bool, True at every site that holds a real row."""
    size = batch.n_events * NX * NY
    occ = torch.zeros(size + 1, dtype=torch.bool, device=batch.mask.device)
    occ.index_fill_(0, flat_site(batch), True)
    return occ[:size].view(batch.n_events, NX, NY)


def flat_site_3d(batch: SparseBatch, n_t: int) -> torch.Tensor:
    """Each row's (event, x, y, t) index into a flat ``[B·NX·NY·T]`` grid,
    int64; padding rows, and rows outside the grid, get ``B·NX·NY·T``."""
    c = batch.coords.long()
    size = batch.n_events * NX * NY * n_t
    idx = c[:, -1] * (NX * NY * n_t) + c[:, 0] * (NY * n_t) + c[:, 1] * n_t + c[:, 2]
    keep = batch.mask & (idx >= 0) & (idx < size)
    return torch.where(keep, idx, torch.full_like(idx, size))


def scatter_to_dense_3d(batch: SparseBatch, n_t: int,
                        feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A 3D batch's features (or ``feats``) on the ``[B, NX, NY, T, F]``
    grid (``spconv.SparseConvTensor`` of spatial size [14, 11, n_samples]),
    two rows at one site summed, padding rows dropped."""
    f = batch.feats if feats is None else feats
    size = batch.n_events * NX * NY * n_t
    src = torch.where(batch.mask[:, None], f, torch.zeros((), dtype=f.dtype, device=f.device))
    flat = f.new_zeros(size + 1, f.shape[-1]).index_add(0, flat_site_3d(batch, n_t), src)
    return flat[:size].view(batch.n_events, NX, NY, n_t, f.shape[-1])


def occupancy_mask_3d(batch: SparseBatch, n_t: int) -> torch.Tensor:
    """``[B, NX, NY, T]`` bool, True at every (x, y, t) site of a real row."""
    size = batch.n_events * NX * NY * n_t
    occ = torch.zeros(size + 1, dtype=torch.bool, device=batch.mask.device)
    occ.index_fill_(0, flat_site_3d(batch, n_t), True)
    return occ[:size].view(batch.n_events, NX, NY, n_t)


def gather_from_dense(dense: torch.Tensor, batch: SparseBatch) -> torch.Tensor:
    """The values of a dense ``[B, NX, NY, F]`` grid at the batch's rows,
    ``[N, F]``, zero at padding rows. Two rows at one site both read the
    site's value (after ``scatter_to_dense``, their sum)."""
    b, _, _, f = dense.shape
    size = b * NX * NY
    idx = torch.where(batch.mask, flat_site(batch).clamp(max=size - 1),
                      torch.zeros((), dtype=torch.long, device=dense.device))
    out = dense.reshape(size, f)[idx]
    return torch.where(batch.mask[:, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def swap_sparse_from_dense(sparse_out: np.ndarray, dense: np.ndarray,
                           coords: np.ndarray) -> None:
    """Write dense per-site values ``[B, NX, NY(, ...)]`` back into a column
    of rows in coordinate order, in place; the dense batch index is the
    count of distinct consecutive event ids, not the event number."""
    b = consecutive_event_index(coords[:, -1])
    sparse_out[:] = dense[b, coords[:, 0].astype(np.int64), coords[:, 1].astype(np.int64)]


def swap_sparse_from_event(sparse_out: np.ndarray, per_event: np.ndarray,
                           coords: np.ndarray) -> None:
    """Write per-event values ``[B(, ...)]`` onto every row of that event,
    in place, with the same consecutive renumbering of the event ids."""
    sparse_out[:] = per_event[consecutive_event_index(coords[:, -1])]


def normalize_waveforms(coords: np.ndarray, waveforms: np.ndarray,
                        gain_factors: np.ndarray) -> np.ndarray:
    """Raw int16 ADC waveform pairs ``[N, 2·S]`` (left samples, then right)
    → float32, each half times its PMT's factor of ``gain_factors``
    ``[NX, NY, 2]``; the event column of ``coords`` is renumbered in place
    to consecutive batch indices."""
    n, two_s = waveforms.shape
    s = two_s // 2
    x = coords[:, 0].astype(np.int64)
    y = coords[:, 1].astype(np.int64)
    out = np.empty((n, two_s), dtype=np.float32)
    out[:, :s] = waveforms[:, :s] * gain_factors[x, y, 0][:, None]
    out[:, s:] = waveforms[:, s:] * gain_factors[x, y, 1][:, None]
    coords[:, -1] = consecutive_event_index(coords[:, -1])
    return out
