"""Per-waveform DSP features: arrival, PSD, total and peak
(counterpart of waveformml_tpu/ops/pallas_dsp.py).

For each waveform row of ``[n, S]``:

* peak    -- the row maximum;
* arrival -- the fractional sample where the row first rises above
  0.5·peak, interpolated linearly from the sample before (``thresh/cur`` if
  that is sample 0, 0 if the row never crosses);
* psd     -- slow/(fast+slow), where fast integrates ``[a-3, a+11]`` and slow
  ``[a+11, a+50]`` with the linear-interpolation boundary weights of
  ``integrate_lininterp_range``;
* total   -- the row sum.

CUDA tensors run kernel K3, written in Triton; CPU tensors run
``waveform_features_plain``, a torch copy of ``_features_math``.
"""
from __future__ import annotations

import functools
import os
from typing import Tuple

import torch

from waveformml_tpu_torch.ops import native

PSD_WINDOW_LO = -3.0
PSD_DIVIDER = 11.0
PSD_WINDOW_HI = 50.0

#: waveform elements one Triton program holds (BLOCK_N · BLOCK_S): 16 per
#: thread of its 4 warps, so that the row tile and its temporaries stay in
#: registers (PERF.md compares it with 8192 on an H100)
ELEMENTS_PER_PROGRAM = 2048


def _window_weights(fi: torch.Tensor, r0: torch.Tensor, r1: torch.Tensor) -> torch.Tensor:
    """Per-sample weights [n, S] that integrate a row over the fractional
    range [r0, r1]: 1 inside [ceil(r0), floor(r1)], with quadratic
    corrections at the samples around both ends."""
    i0 = torch.ceil(r0)[:, None]
    d0 = i0 - r0[:, None]
    i1 = torch.floor(r1)[:, None]
    d1 = r1[:, None] - i1
    zero = torch.zeros((), dtype=fi.dtype, device=fi.device)
    w = ((fi >= i0) & (fi <= i1)).to(fi.dtype)
    w = w - torch.where(fi == i0, (1 - d0) ** 2 / 2, zero)
    w = w + torch.where(fi == i0 - 1, d0 ** 2 / 2, zero)
    w = w - torch.where(fi == i1, (1 - d1) ** 2 / 2, zero)
    w = w + torch.where(fi == i1 + 1, d1 ** 2 / 2, zero)
    return w


def waveform_features_plain(wfs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K3. wfs [n, S] float → four [n] tensors
    (arrival, psd, total, peak)."""
    n, s = wfs.shape
    idx = torch.arange(s, device=wfs.device).expand(n, s)
    zero = torch.zeros((), dtype=wfs.dtype, device=wfs.device)
    tiny = torch.full((), 1e-30, dtype=wfs.dtype, device=wfs.device)
    peak = wfs.max(dim=1).values
    thresh = 0.5 * peak
    big = s + 1
    first = torch.where(wfs > thresh[:, None], idx, big).min(dim=1).values
    cur = wfs.gather(1, first.clamp(0, s - 1)[:, None])[:, 0]
    prev = wfs.gather(1, (first - 1).clamp(0, s - 1)[:, None])[:, 0]
    diff = cur - prev
    frac_mid = (thresh - prev) / torch.where(diff == 0, tiny, diff)
    frac0 = torch.where(cur != 0, thresh / torch.where(cur == 0, tiny, cur), zero)
    arrival = torch.where(first < big,
                          torch.where(first == 0, frac0,
                                      first.to(wfs.dtype) + frac_mid),
                          zero)
    fi = idx.to(wfs.dtype)
    fast = (wfs * _window_weights(fi, arrival + PSD_WINDOW_LO,
                                  arrival + PSD_DIVIDER)).sum(dim=1)
    slow = (wfs * _window_weights(fi, arrival + PSD_DIVIDER,
                                  arrival + PSD_WINDOW_HI)).sum(dim=1)
    den = fast + slow
    psd = torch.where(den == 0, zero, slow / torch.where(den == 0, 1.0, den))
    return arrival, psd, wfs.sum(dim=1), peak


@functools.cache
def _triton_kernel():
    """Compile-on-first-use Triton kernel K3.

    Replaces waveformml_tpu/ops/pallas_dsp.py:waveform_features_pallas
    (the Pallas kernel ``_kernel``, TILE_N = 256 rows per grid step). Bound
    on the H100: bytes -- every sample is read once and feeds ~40 fp32
    operations of row reductions and selects, far below the card's
    FLOP/byte ridge, and nothing needs a matrix unit. Design: one program
    holds BLOCK_N whole rows in registers (BLOCK_S, the next power of two at
    or above S, with masked loads), so each sample is read from device
    memory exactly once and the four outputs are written once; the one-hot
    selects of the Pallas kernel stay, as row reductions.
    """
    # Triton's compile cache goes beside the CUDA libraries, in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(native.BUILD_DIR / "triton"))
    # `tl` is bound as a module global so that the kernel's globals resolve
    # it when Triton compiles the kernel on first launch
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def features_kernel(wf_ptr, arr_ptr, psd_ptr, tot_ptr, peak_ptr, n, s,
                        stride, lo, div, hi,
                        BLOCK_N: tl.constexpr, BLOCK_S: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
        cols = tl.arange(0, BLOCK_S)
        row_ok = rows < n
        col_ok = cols < s
        w = tl.load(wf_ptr + rows[:, None].to(tl.int64) * stride + cols[None, :],
                    mask=row_ok[:, None] & col_ok[None, :], other=0.0)
        idx = cols[None, :]
        fi = idx.to(tl.float32)

        peak = tl.max(tl.where(col_ok[None, :], w, float("-inf")), axis=1)
        thresh = 0.5 * peak
        big = s + 1
        above = (w > thresh[:, None]) & col_ok[None, :]
        first = tl.min(tl.where(above, idx, big), axis=1)
        first_c = tl.minimum(tl.maximum(first, 0), s - 1)
        prev_c = tl.minimum(tl.maximum(first - 1, 0), s - 1)
        cur = tl.sum(tl.where(idx == first_c[:, None], w, 0.0), axis=1)
        prev = tl.sum(tl.where(idx == prev_c[:, None], w, 0.0), axis=1)
        diff = cur - prev
        frac_mid = (thresh - prev) / tl.where(diff == 0, 1e-30, diff)
        frac0 = tl.where(cur != 0, thresh / tl.where(cur == 0, 1e-30, cur), 0.0)
        arrival = tl.where(first < big,
                           tl.where(first == 0, frac0,
                                    first.to(tl.float32) + frac_mid), 0.0)

        # fast window [a + lo, a + div]
        r0 = arrival + lo
        r1 = arrival + div
        i0 = tl.ceil(r0)
        d0 = i0 - r0
        i1 = tl.floor(r1)
        d1 = r1 - i1
        wt = ((fi >= i0[:, None]) & (fi <= i1[:, None])).to(tl.float32)
        wt = wt - tl.where(fi == i0[:, None], ((1 - d0) * (1 - d0) / 2)[:, None], 0.0)
        wt = wt + tl.where(fi == (i0 - 1)[:, None], (d0 * d0 / 2)[:, None], 0.0)
        wt = wt - tl.where(fi == i1[:, None], ((1 - d1) * (1 - d1) / 2)[:, None], 0.0)
        wt = wt + tl.where(fi == (i1 + 1)[:, None], (d1 * d1 / 2)[:, None], 0.0)
        fast = tl.sum(w * wt, axis=1)

        # slow window [a + div, a + hi]
        r0 = arrival + div
        r1 = arrival + hi
        i0 = tl.ceil(r0)
        d0 = i0 - r0
        i1 = tl.floor(r1)
        d1 = r1 - i1
        wt = ((fi >= i0[:, None]) & (fi <= i1[:, None])).to(tl.float32)
        wt = wt - tl.where(fi == i0[:, None], ((1 - d0) * (1 - d0) / 2)[:, None], 0.0)
        wt = wt + tl.where(fi == (i0 - 1)[:, None], (d0 * d0 / 2)[:, None], 0.0)
        wt = wt - tl.where(fi == i1[:, None], ((1 - d1) * (1 - d1) / 2)[:, None], 0.0)
        wt = wt + tl.where(fi == (i1 + 1)[:, None], (d1 * d1 / 2)[:, None], 0.0)
        slow = tl.sum(w * wt, axis=1)

        den = fast + slow
        psd = tl.where(den == 0, 0.0, slow / tl.where(den == 0, 1.0, den))
        tl.store(arr_ptr + rows, arrival, mask=row_ok)
        tl.store(psd_ptr + rows, psd, mask=row_ok)
        tl.store(tot_ptr + rows, tl.sum(w, axis=1), mask=row_ok)
        tl.store(peak_ptr + rows, peak, mask=row_ok)

    return features_kernel


def block_sizes(s: int) -> Tuple[int, int]:
    """(BLOCK_N, BLOCK_S) of K3 for rows of s samples."""
    block_s = max(16, 1 << (int(s) - 1).bit_length())
    return max(1, ELEMENTS_PER_PROGRAM // block_s), block_s


def waveform_features(wfs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(arrival, psd, total, peak), each [n], of waveform rows wfs [n, S].

    CUDA tensors (float32, contiguous rows) run Triton kernel K3; CPU
    tensors run ``waveform_features_plain``."""
    if wfs.dim() != 2 or wfs.shape[1] < 1:
        raise ValueError(f"expected wfs [n, S], got {tuple(wfs.shape)}")
    if not wfs.is_cuda:
        return waveform_features_plain(wfs)
    if wfs.dtype != torch.float32 or wfs.stride(1) != 1:
        raise TypeError("the Triton kernel takes float32 rows with unit stride")
    n, s = wfs.shape
    outs = tuple(torch.empty(n, dtype=torch.float32, device=wfs.device)
                 for _ in range(4))
    if n == 0:
        return outs
    block_n, block_s = block_sizes(s)
    _triton_kernel()[((n + block_n - 1) // block_n,)](
        wfs, *outs, n, s, wfs.stride(0), PSD_WINDOW_LO, PSD_DIVIDER, PSD_WINDOW_HI,
        BLOCK_N=block_n, BLOCK_S=block_s, num_warps=4)
    waveform_features.launches += 1
    return outs


waveform_features.launches = 0
