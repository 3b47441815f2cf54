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

They are the custom op ``waveformml::waveform_features``: kernel K3
(``csrc/waveform_features.cu``) for CUDA tensors, ``waveform_features_plain``
(a torch copy of ``_features_math``) for CPU tensors, the dispatcher
choosing by device.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from waveformml_tpu_torch.ops import native

PSD_WINDOW_LO = -3.0
PSD_DIVIDER = 11.0
PSD_WINDOW_HI = 50.0

#: waveform rows per block of K3, one thread each
ROWS_PER_BLOCK = 128
#: shared memory a block may use on the H100 (227 KB)
MAX_SHARED_BYTES = 232448


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


def _condition(terms: torch.Tensor) -> torch.Tensor:
    """Σ|t| / |Σt| over the rows of float64 terms [n, S]: 1 for an all-zero
    row, inf where the sum is exactly 0 and the terms are not."""
    mass = terms.abs().sum(dim=1)
    return torch.where(mass == 0, torch.ones_like(mass), mass / terms.sum(dim=1).abs())


def features_limits(want, wfs: torch.Tensor, tol: float) -> Tuple[torch.Tensor, ...]:
    """Each row's allowed |K3 - plain| for (arrival, psd, total, peak),
    float64 [n] each, given the plain version's outputs ``want`` over rows
    wfs: tol·(1 + |want|), times the row's condition number for total and
    psd (see ``features_close``)."""
    x = wfs.to(torch.float64)
    a = want[0].to(torch.float64)
    fi = torch.arange(x.shape[1], dtype=torch.float64, device=x.device).expand_as(x)
    windows = torch.cat([x * _window_weights(fi, a + PSD_WINDOW_LO, a + PSD_DIVIDER),
                         x * _window_weights(fi, a + PSD_DIVIDER, a + PSD_WINDOW_HI)], dim=1)
    kappa = (None, _condition(windows), _condition(x), None)
    units = [tol * (1 + w.to(torch.float64).abs()) for w in want]
    return tuple(u if k is None else u * k for u, k in zip(units, kappa))


def features_close(got, want, wfs: torch.Tensor, tol: float) -> Dict[str, float]:
    """Hold K3's outputs ``got`` against the plain version's ``want`` (both
    (arrival, psd, total, peak)) for rows wfs. Returns the largest |got -
    want| (``max_abs_err``), the largest psd difference in units of
    tol·(1 + |psd|) (``psd_excess``) and the κ of that row (``psd_kappa``);
    raises AssertionError where they differ by more than:

    * arrival, peak: tol·(1 + |want|);
    * total, psd: tol·(1 + |want|)·κ, κ the row's condition number (1 for a
      row of one sign). A sum of S terms taken in another order moves by up
      to ~S·2^-24 of Σ|terms|, so where a sum cancels (signed noise), two
      exact fp32 implementations differ by κ times more. For total κ =
      Σ|x|/|Σx|; for psd = slow/(fast + slow) it is Σ|w·x| over both
      windows / |fast + slow|, which bounds psd's move to that factor
      times (1 + |psd|)."""
    limits = features_limits(want, wfs, tol)
    out = {"max_abs_err": 0.0, "psd_excess": 0.0, "psd_kappa": 1.0}
    for name, g, w, limit in zip(("arrival", "psd", "total", "peak"), got, want, limits):
        d = (g.to(torch.float64) - w.to(torch.float64)).abs()
        unit = tol * (1 + w.to(torch.float64).abs())
        bad = ~(d <= limit)
        if bool(bad.any()):
            i = int(bad.nonzero()[0, 0])
            raise AssertionError(f"{name} row {i}: got {float(g[i])}, want {float(w[i])}, "
                                 f"limit {float(limit[i])} ({int(bad.sum())} rows out)")
        if d.numel():
            out["max_abs_err"] = max(out["max_abs_err"], float(d.max()))
            if name == "psd":
                i = int((d / unit).argmax())
                out["psd_excess"], out["psd_kappa"] = (float(d[i] / unit[i]),
                                                       float(limit[i] / unit[i]))
    return out


def launch_geometry(s: int) -> Tuple[int, int, int]:
    """(rows per block, shared-memory row stride in words, shared-memory
    bytes) of K3 for rows of s samples: S padded to an odd stride so that a
    warp's per-row reads hit distinct banks, and up to ROWS_PER_BLOCK rows,
    fewer where the tile would not fit a block's shared memory."""
    s = int(s)
    stride = s | 1
    rows = ROWS_PER_BLOCK
    while rows > 32 and rows * stride * 4 > MAX_SHARED_BYTES:
        rows -= 32
    if rows * stride * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"rows of {s} samples do not fit K3's shared-memory tile")
    return rows, stride, rows * stride * 4


_FUNCTIONS = {"waveform_features_fwd":
              [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
              + [ctypes.c_int] * 2 + [ctypes.c_void_p]}


def waveform_features_cuda(wfs: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA kernel of the op: K3's launch on rows that
    ``waveform_features`` has checked."""
    n, s = wfs.shape
    outs = tuple(torch.empty(n, dtype=torch.float32, device=wfs.device)
                 for _ in range(4))
    if n == 0:
        return outs
    rows, stride, _ = launch_geometry(s)
    lib = native.load("waveform_features", _FUNCTIONS)
    err = lib.waveform_features_fwd(
        wfs.data_ptr(), *(o.data_ptr() for o in outs), n, s, wfs.stride(0),
        rows, stride, torch.cuda.current_stream(wfs.device).cuda_stream)
    native.check_launch(lib, err, "waveform_features")
    native.count_launches(waveform_features, 1)
    return outs


def _waveform_features_fake(wfs):
    return tuple(wfs.new_empty(wfs.shape[0]) for _ in range(4))


waveform_features_op = native.define_op(
    "waveform_features", "(Tensor wfs) -> (Tensor, Tensor, Tensor, Tensor)",
    cpu=waveform_features_plain, cuda=waveform_features_cuda, fake=_waveform_features_fake)


def waveform_features(wfs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(arrival, psd, total, peak), each [n], of waveform rows wfs [n, S].

    Checks the rows, then calls the custom op ``waveformml::waveform_features``,
    which runs kernel K3 (``csrc/waveform_features.cu``, which replaces
    waveformml_tpu/ops/pallas_dsp.py:waveform_features_pallas) on CUDA
    tensors (float32, unit stride along a row, any row stride) and
    ``waveform_features_plain`` on CPU tensors."""
    if wfs.dim() != 2 or wfs.shape[1] < 1:
        raise ValueError(f"expected wfs [n, S], got {tuple(wfs.shape)}")
    if wfs.is_cuda and (wfs.dtype != torch.float32 or wfs.stride(1) != 1):
        raise TypeError("the CUDA kernel takes float32 rows with unit stride")
    return waveform_features_op(wfs)


waveform_features.launches = waveform_features.captured = 0
