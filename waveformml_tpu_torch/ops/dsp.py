"""DSP and statistics kernels: the numeric core of the evaluation/IO path
(the port's copy of waveformml_tpu/ops/dsp.py).

Vectorized numpy ports of the reference's numba kernels
(src/utils/SparseUtils.py, 1642 LoC; src/utils/WaveformUtils.py;
src/utils/NumbaFunctions.py). The numba JIT loops become array ops — same
results, no per-element Python. Host side only (the evaluators and the
analysis scripts).

Kernel → reference mapping (file:line in src/utils/SparseUtils.py unless noted):
  moment :13-68 · get_bin_index :139-154 · hist_add_1d/2d :157-173
  confusion_accumulate(_1d) :110-135 · metric_accumulate_1d :175-186
  metric_accumulate_2d :229-262 · calc_spread :340-376 · calc_time :379-389
  average_pulse :406-488 · weighted_average_quantities :491-529
  calc_arrival_from_peak :532-546 · calc_arrival :549-564 · calc_psd :567-576
  integrate_lininterp_range :578-596 · lin_interp(_inverse) :627-650
  find_peaks :662-720 · find_baseline :737-747 · average_median :750-767
  cull_peaks :930-938 · match_peaks :899-913 · excluded_inds :848-873
  align_wfs / find_peak / peak_interpolate: src/utils/WaveformUtils.py:5-105
"""
from __future__ import annotations

from math import ceil, floor, sqrt
from typing import List, Optional, Tuple

import numpy as np

from waveformml_tpu_torch.detector import MAX_RANGE


# ---------------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------------

def moment(data: np.ndarray, n: int, weights: Optional[np.ndarray] = None
           ) -> Tuple[float, float, float]:
    """(variance, skew, excess kurtosis) with the reference's conventions
    (ref :13-68): weighted first moment; central moments accumulated only over
    nonzero entries; sample-variance normalization."""
    data = np.asarray(data[:n], dtype=np.float64)
    if n <= 1:
        return 0.0, 0.0, 0.0
    if weights is not None:
        w = np.asarray(weights[:n], dtype=np.float64)
        wpos = np.where(w > 0, w, 0.0)
        weightsum = wpos.sum()
        ave = (data * wpos).sum() / weightsum if weightsum > 0 else data.sum() / n
    else:
        w = None
        weightsum = 0.0
        ave = data.sum() / n
    nz = data != 0
    s = data - ave
    if weightsum > 0.0 and w is not None:
        svar = float((s * s * w)[nz].sum())
        skew = float((s ** 3 * w)[nz].sum())
        curt = float((s ** 4 * w)[nz].sum())
        denom = weightsum
        svar = svar / (weightsum - 1) if weightsum > 1 else 0.0
    else:
        svar = float((s * s)[nz].sum())
        skew = float((s ** 3)[nz].sum())
        curt = float((s ** 4)[nz].sum())
        denom = n
        svar = svar / (n - 1) if n > 1 else 0.0
    if svar > 0:  # w can contain negatives (raw noise); sqrt needs svar > 0
        sdev = sqrt(svar)
        skew = skew / (denom * svar * sdev)
        curt = curt / (denom * svar * svar) - 3.0
    else:
        skew, curt = 0.0, 0.0
    return svar, skew, curt


def get_bin_index(val: np.ndarray, low: float, high: float, nbins: int) -> np.ndarray:
    """Vectorized bin index with underflow bin 0, data bins 1..nbins, overflow
    nbins+1 (ref :139-154: boundary values promote to the next bin)."""
    val = np.asarray(val, dtype=np.float64)
    bw = (high - low) / nbins
    # floor + 1 already reproduces the reference's strict `>` scan, including
    # its boundary promotion: a value exactly on bin edge k lands in bin k+1.
    # Non-finite values take a placeholder through the int cast (casting
    # nan/inf to int64 is UB + RuntimeWarning) and are routed explicitly below.
    finite = np.isfinite(val)
    safe = np.where(finite, val, low)
    idx = np.floor((safe - low) / bw).astype(np.int64) + 1
    idx = np.clip(idx, 1, nbins)
    idx = np.where(val < low, 0, idx)            # -inf < low: underflow
    idx = np.where(val >= high, nbins + 1, idx)  # +inf >= high: overflow
    # NaN fails every comparison in the reference's scalar scan (ref :139-154),
    # so bin_index stays 0 there — NaN counts land in the underflow bin
    idx = np.where(np.isnan(val), 0, idx)
    return idx


def hist_add_1d(values: np.ndarray, output: np.ndarray, xrange, nbins: int) -> None:
    """In-place 1D histogram with under/overflow slots (ref :157-163)."""
    idx = get_bin_index(values, xrange[0], xrange[1], nbins)
    np.add.at(output, idx, 1)


def hist_add_2d(vx: np.ndarray, vy: np.ndarray, output: np.ndarray,
                xrange, yrange, nbinsx: int, nbinsy: int) -> None:
    ix = get_bin_index(vx, xrange[0], xrange[1], nbinsx)
    iy = get_bin_index(vy, yrange[0], yrange[1], nbinsy)
    np.add.at(output, (ix, iy), 1)


def confusion_accumulate(prediction: np.ndarray, label: np.ndarray,
                         output: np.ndarray) -> None:
    """output[label, pred] += 1 (ref :110-113)."""
    np.add.at(output, (label.astype(np.int64), prediction.astype(np.int64)), 1)


def confusion_accumulate_1d(prediction, label, metric, output, xrange, nbins) -> None:
    """Energy-binned confusion: no underflow bin, overflow at nbins
    (ref :116-135)."""
    metric = np.asarray(metric, dtype=np.float64)
    bw = (xrange[1] - xrange[0]) / nbins
    keep = metric >= xrange[0]
    idx = np.floor((metric - xrange[0]) / bw).astype(np.int64)
    idx = np.clip(idx, 0, nbins - 1)
    idx = np.where(metric > xrange[1], nbins, idx)
    np.add.at(output, (idx[keep], label[keep].astype(np.int64),
                       prediction[keep].astype(np.int64)), 1)


def welford_accumulate_1d(results, parameter, mean, count, m2, xrange, nbins) -> None:
    """Binned running mean/M2 update, batch-merged (ref :175-186
    metric_accumulate_1d; sequential Welford ≡ batch merge)."""
    idx = get_bin_index(parameter, xrange[0], xrange[1], nbins)
    results = np.asarray(results, dtype=np.float64)
    nbins_tot = mean.shape[0]
    b_n = np.bincount(idx, minlength=nbins_tot).astype(np.float64)
    b_sum = np.bincount(idx, weights=results, minlength=nbins_tot)
    with np.errstate(invalid="ignore", divide="ignore"):
        b_mean = np.where(b_n > 0, b_sum / np.maximum(b_n, 1), 0.0)
    b_m2 = np.bincount(idx, weights=(results - b_mean[idx]) ** 2, minlength=nbins_tot)
    tot = count + b_n
    delta = b_mean - mean
    with np.errstate(invalid="ignore", divide="ignore"):
        new_mean = np.where(tot > 0, mean + delta * b_n / np.maximum(tot, 1), mean)
        new_m2 = m2 + b_m2 + delta * delta * count * b_n / np.maximum(tot, 1)
    mean[:] = new_mean
    m2[:] = np.where(tot > 0, new_m2, m2)
    count[:] = tot


def metric_accumulate_2d(results, metric, output, out_n, xrange, yrange,
                         nbinsx, nbinsy) -> None:
    """2D binned sums + counts (ref :229-262)."""
    ix = get_bin_index(metric[:, 0], xrange[0], xrange[1], nbinsx)
    iy = get_bin_index(metric[:, 1], yrange[0], yrange[1], nbinsy)
    np.add.at(output, (ix, iy), np.asarray(results, dtype=output.dtype))
    np.add.at(out_n, (ix, iy), 1)


def finalize_welford(count: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """M2 → sample std (ref :1624-1642 finalize/finalize2d)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        var = np.where(count > 1, m2 / np.maximum(count - 1, 1), 0.0)
    return np.sqrt(var)


def safe_divide(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise a/b with 0 where b == 0 (``utils.util.safe_divide``)."""
    from waveformml_tpu_torch.utils.util import safe_divide as _sd

    return _sd(a, b)


# ---------------------------------------------------------------------------------
# waveform DSP
# ---------------------------------------------------------------------------------

def calc_arrival(fdat: np.ndarray) -> float:
    """Fractional sample of the 0.5·peak rising-edge crossing (ref :549-564)."""
    fdat = np.asarray(fdat, dtype=np.float64)
    peak = fdat.max(initial=0.0)
    thresh = 0.5 * peak
    above = np.flatnonzero(fdat > thresh)
    if above.size == 0:
        return 0.0
    i = int(above[0])
    if i == 0:
        return thresh / fdat[0]
    return i + (thresh - fdat[i - 1]) / (fdat[i] - fdat[i - 1])


def calc_arrival_batch(wfs: np.ndarray) -> np.ndarray:
    """Vectorized calc_arrival over [N, S]."""
    wfs = np.asarray(wfs, dtype=np.float64)
    peak = wfs.max(axis=1)
    thresh = 0.5 * peak
    above = wfs > thresh[:, None]
    first = np.argmax(above, axis=1)
    has = above.any(axis=1)
    prev = wfs[np.arange(len(wfs)), np.maximum(first - 1, 0)]
    cur = wfs[np.arange(len(wfs)), first]
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = np.where(first == 0,
                        np.where(cur != 0, thresh / np.maximum(cur, 1e-30), 0.0),
                        (thresh - prev) / np.where(cur - prev == 0, 1e-30, cur - prev))
    return np.where(has, first + frac, 0.0)


def calc_arrival_from_peak(fdat: np.ndarray, peak_ind: int) -> float:
    """Walk back from a known peak to the 0.5·peak crossing (ref :532-546)."""
    fdat = np.asarray(fdat, dtype=np.float64)
    peak = fdat[peak_ind]
    thresh = 0.5 * peak
    if peak_ind == 0:
        return 0.5
    cur = peak_ind - 1
    while cur >= 0:
        if fdat[cur] < thresh:
            return cur + 1 + (thresh - fdat[cur]) / (fdat[cur + 1] - fdat[cur])
        if cur == 0:
            return thresh / fdat[cur]
        cur -= 1
    return 0.0


def sum_range(v: np.ndarray, r0: int, r1: int) -> float:
    """Inclusive clipped range sum (ref :599-616)."""
    r0 = max(0, r0)
    if r0 >= v.shape[0]:
        return 0.0
    r1 = min(v.shape[0] - 1, r1)
    if r0 > r1:
        return 0.0
    return float(np.sum(v[r0:r1 + 1]))


def integrate_lininterp_range(v: np.ndarray, r0: float, r1: float) -> float:
    """Trapezoid-corrected integral over a fractional sample range (ref :578-596)."""
    i0, i1 = ceil(r0), floor(r1)
    d0, d1 = i0 - r0, r1 - i1
    s = sum_range(v, i0, i1) if i0 <= i1 else 0.0
    n = v.shape[0]
    if 0 <= i0 < n:
        s -= (1 - d0) ** 2 / 2 * v[i0]
    if 1 <= i0 <= n:
        s += d0 ** 2 / 2 * v[i0 - 1]
    if 0 <= i1 < n:
        s -= (1 - d1) ** 2 / 2 * v[i1]
    if -1 <= i1 < n - 1:
        s += d1 ** 2 / 2 * v[i1 + 1]
    return float(s)


def calc_psd(fdat: np.ndarray, arrival_samp: float, psd_window_lo: float = -3,
             psd_window_hi: float = 50, psd_divider: float = 11,
             residual_adjust: float = 0.0) -> float:
    """Tail-fraction PSD: slow/(slow+fast) (ref :567-576)."""
    fast = integrate_lininterp_range(fdat, arrival_samp + psd_window_lo,
                                     arrival_samp + psd_divider) + \
        (psd_divider - psd_window_lo + 1) * residual_adjust
    slow = integrate_lininterp_range(fdat, arrival_samp + psd_divider,
                                     arrival_samp + psd_window_hi) + \
        (psd_window_hi - psd_divider + 1) * residual_adjust
    if slow + fast == 0:
        return 0.0
    return slow / (slow + fast)


def lin_interp(xy: np.ndarray, x: float) -> float:
    """Piecewise-linear y(x) over an (n,2) curve with flat extrapolation to
    the last point (ref :640-650)."""
    xs, ys = xy[:, 0], xy[:, 1]
    idx = np.searchsorted(xs, x, side="right")
    if idx == 0:
        return float(ys[0])
    if idx >= len(xs):
        return float(ys[-1])
    x0, x1, y0, y1 = xs[idx - 1], xs[idx], ys[idx - 1], ys[idx]
    return float(y0 + (x - x0) * (y1 - y0) / (x1 - x0))


def lin_interp_inverse(xy: np.ndarray, y: float) -> float:
    """First-crossing x(y) (ref :627-637)."""
    xs, ys = xy[:, 0], xy[:, 1]
    above = np.flatnonzero(ys > y)
    if above.size == 0:
        return float(xs[-1])
    i = int(above[0])
    if i == 0:
        return float(xs[0])
    return float(xs[i - 1] + (y - ys[i - 1]) * (xs[i] - xs[i - 1]) / (ys[i] - ys[i - 1]))


def calc_time(pulse: np.ndarray, nsamp: Optional[int] = None) -> float:
    """Energy-weighted mean time in samples (ref :379-389)."""
    p = np.asarray(pulse[:nsamp] if nsamp else pulse, dtype=np.float64)
    tot = p.sum()
    if tot == 0.0:
        return 0.0
    t = (p * (np.arange(p.shape[0]) + 0.5)).sum()
    return float(t / tot)


def find_max(v: np.ndarray) -> int:
    """Index of the first strictly-greater running max (ref :392-403)."""
    v = np.asarray(v)
    if v.size == 0 or v.max(initial=0) <= 0:
        return 0
    return int(np.argmax(v))


# ---------------------------------------------------------------------------------
# peak finding
# ---------------------------------------------------------------------------------

def find_peaks(v: np.ndarray, sep: int, max_peaks: int = 5
               ) -> Tuple[int, np.ndarray]:
    """Plateau-aware local-maxima finder with greedy value-ordered selection
    subject to a minimum separation (ref :662-720).

    Returns (global_max_pos, selected_positions[max_peaks] with -1 padding).
    """
    v = np.asarray(v, dtype=np.float64)
    maxloc = np.full(max_peaks, -1, dtype=np.int64)
    n = v.shape[0]
    if n < 2:
        return 0, maxloc
    d = np.diff(v)
    rises = np.flatnonzero(d > 0) + 1   # v[i] > v[i-1]
    falls = np.flatnonzero(d < 0) + 1   # v[i] < v[i-1]
    if rises.size == 0 or falls.size == 0:
        return 0, maxloc
    peaks: List[int] = []
    last_used_rise = -1
    ri = 0
    for f in falls:
        # last rise strictly before f that came after the previous recorded fall
        while ri < rises.size and rises[ri] < f:
            ri += 1
        cand = rises[ri - 1] if ri > 0 else -1
        if cand > last_used_rise and cand != -1:
            lmax = (cand + f - 1) // 2
            peaks.append(int(lmax))
            last_used_rise = f  # reset: need a new rise after this fall
            if len(peaks) >= 50:
                # parity: the reference's fixed 50-slot buffer stops scanning
                # after 50 rise/fall candidates (ref :663, :678) — a pulse
                # arriving after 50 noise maxima is dropped there too
                break
    if not peaks:
        return 0, maxloc
    locs = np.asarray(peaks, dtype=np.int64)
    vals = v[locs]
    order = np.argsort(-vals, kind="stable")
    locs = locs[order]
    global_maxpos = int(locs[0])
    maxloc[0] = global_maxpos
    k = 1
    for loc in locs[1:]:
        if k >= max_peaks:
            break
        if all(abs(int(loc) - int(m)) > sep * 2 for m in maxloc[:k]):
            maxloc[k] = loc
            k += 1
    return global_maxpos, maxloc


def cull_peaks(peaks: np.ndarray, wf: np.ndarray, max_loc: int) -> np.ndarray:
    """Keep peaks with amplitude > 30 ADC (normalized ×MAX_RANGE), or the
    global max above a smaller threshold (ref :930-938). Returns -1-padded.

    The global-max branch compares the NORMALIZED amplitude against 15
    exactly like the reference (`wf[p] > 15` on [0,1] data, ref :933) —
    unreachable in practice, reproduced verbatim for baseline parity."""
    out = np.full_like(peaks, -1)
    i = 0
    for p in peaks:
        if p == -1:
            break
        val = wf[p] * MAX_RANGE
        if val > 30 or (wf[p] > 15 and p == max_loc):
            out[i] = p
            i += 1
    return out


def strip_sentinel(v: np.ndarray, sentinel: int = -1) -> Optional[np.ndarray]:
    """Trim a -1-terminated list; None if empty (ref :653-660 remove_end_zeros)."""
    if v.size == 0 or v[0] == sentinel:
        return None
    idx = np.flatnonzero(v == sentinel)
    return v[: idx[0]] if idx.size else v


def match_peaks(small: np.ndarray, large: np.ndarray) -> np.ndarray:
    """Nearest-position match of each small peak into large (ref :899-913)."""
    return np.abs(small[:, None] - large[None, :]).argmin(axis=1).astype(np.int64)


def excluded_inds(inds: np.ndarray, size: int) -> np.ndarray:
    """Indices of `size` not present in inds (ref :848-873)."""
    mask = np.ones(size, dtype=bool)
    mask[inds] = False
    return np.flatnonzero(mask).astype(np.int64)


# ---------------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------------

def average_median(v: np.ndarray, centerfrac: float = 0.33) -> float:
    """Mean of the central `centerfrac` of the sorted values (ref :750-767)."""
    v = np.sort(np.asarray(v, dtype=np.float64))
    n = v.shape[0]
    if n == 0:
        return 0.0
    res = centerfrac * n
    ndiscard = n - 1 if res < 1 else n - int(centerfrac * n)
    istart = ndiscard // 2
    # parity: the reference keeps one extra element when ndiscard is odd
    # (iend = n - istart discards only 2*(ndiscard//2) values, ref :759-761)
    iend = n - istart
    return float(v[istart:iend].mean())


def find_baseline(data: np.ndarray, peakloc: int, lo: int, hi: int) -> float:
    """(ref :737-747)"""
    r0, r1 = peakloc + lo, peakloc + hi
    r0 = max(0, r0)
    r1 = min(data.shape[0], r1)
    if r1 - r0 < 10:
        r0, r1 = 0, min(10, data.shape[0])
    return average_median(data[r0:r1])


def get_residual(baseline: float) -> float:
    return round(baseline) - baseline


def calc_size(data: np.ndarray, peak_ind: int) -> float:
    """Window sum around a peak, [-3, +25] samples (ref :727-735).

    The residual term reproduces the reference VERBATIM, quirks included:
    its baseline is pinned to 0 (find_baseline call commented out upstream)
    so get_residual(0.0) == 0.0 and the term vanishes, and its n has the
    reference's sign error (start - stop + 1 == -27). Kept bit-identical
    for baseline parity; fix both together if the residual path is ever
    re-enabled."""
    start, stop = peak_ind - 3, peak_ind + 25
    n = start - stop + 1
    residual_adjust = get_residual(0.0)
    return sum_range(data, start, stop) + n * residual_adjust


# ---------------------------------------------------------------------------------
# waveform alignment (ref: src/utils/WaveformUtils.py)
# ---------------------------------------------------------------------------------

def find_peak(wf: np.ndarray) -> int:
    """First local max above 10% of global max (ref: WaveformUtils.py:30-41)."""
    wf = np.asarray(wf)
    gmax = wf.max(initial=0)
    if gmax <= 0:
        return 0
    thresh = 0.1 * gmax
    for i in range(1, wf.shape[0] - 1):
        if wf[i] > thresh and wf[i] >= wf[i - 1] and wf[i] > wf[i + 1]:
            return i
    return int(np.argmax(wf))


def align_wfs(wfs: np.ndarray, arrivals: np.ndarray, target: int = 10) -> np.ndarray:
    """Shift each waveform so its arrival sample lands at `target`
    (ref: WaveformUtils.py:5-26)."""
    out = np.zeros_like(wfs)
    n = wfs.shape[1]
    for i in range(wfs.shape[0]):
        shift = target - int(round(arrivals[i]))
        if shift >= 0:
            out[i, shift:] = wfs[i, : n - shift]
        else:
            out[i, : n + shift] = wfs[i, -shift:]
    return out


def peak_interpolate(wf: np.ndarray, peak_ind: int) -> float:
    """Parabolic sub-sample peak interpolation (ref: WaveformUtils.py:83-105)."""
    if peak_ind <= 0 or peak_ind >= wf.shape[0] - 1:
        return float(peak_ind)
    y0, y1, y2 = float(wf[peak_ind - 1]), float(wf[peak_ind]), float(wf[peak_ind + 1])
    denom = y0 - 2 * y1 + y2
    if denom == 0:
        return float(peak_ind)
    return peak_ind + 0.5 * (y0 - y2) / denom


# ---------------------------------------------------------------------------------
# event summarization (ref :406-529)
# ---------------------------------------------------------------------------------

def calc_spread(coords, pulses, nsamp, x, y, dt, E):
    """Energy-weighted spreads of position/time/energy within one event
    (ref :340-376)."""
    mult = coords.shape[0]
    if mult < 2:
        return 0.0, 0.0, 0.0, 0.0
    left = pulses[:, :nsamp].astype(np.float64)
    right = pulses[:, nsamp:2 * nsamp].astype(np.float64)
    t_idx = np.arange(nsamp) + 0.5
    totl = left.sum(axis=1)
    totr = right.sum(axis=1)
    timel = (left * t_idx).sum(axis=1)
    timer = (right * t_idx).sum(axis=1)
    tot = float((totl + totr).sum())
    dx = float((np.abs(coords[:, 0] - x) * (totl + totr)).sum())
    dy = float((np.abs(coords[:, 1] - y) * (totl + totr)).sum())
    ddt, dE = 0.0, 0.0
    for i in range(mult):
        if totl[i] > 0 and totr[i] > 0:
            ddt += abs((timer[i] / totr[i] - timel[i] / totl[i]) - dt) * (totl[i] + totr[i])
            dE += abs(E - (totl[i] + totr[i]))
        elif totl[i] > 0:
            ddt += abs(-timel[i] / totl[i] - dt) * totl[i]
            dE += abs(E - totl[i])
        elif totr[i] > 0:
            ddt += abs(timer[i] / totr[i] - dt) * totr[i]
            dE += abs(E - totr[i])
    if tot > 0:
        return dx / tot, dy / tot, ddt / tot, dE / mult
    return 0.0, 0.0, 0.0, 0.0


def average_pulse(coords: np.ndarray, pulses: np.ndarray, gains: np.ndarray,
                  times: np.ndarray, seg_status: np.ndarray, n_events: int):
    """Per-event summaries for the PSD evaluator (ref :406-488): gain-corrected
    summed pulses, energy-weighted coords, PSD l/r, dt, multiplicity, n_SE,
    spreads and moments.

    Returns dict with out_coords [B,2], out_pulses [B,2S], out_stats [6,B],
    multiplicity [B], psdl [B], psdr [B], n_SE [B].
    """
    n_samples = pulses.shape[1] // 2
    B = n_events
    out_coords = np.zeros((B, 2))
    out_pulses = np.zeros((B, 2 * n_samples))
    out_stats = np.zeros((6, B))
    multiplicity = np.zeros(B, dtype=np.int64)
    psdl = np.zeros(B)
    psdr = np.zeros(B)
    n_SE = np.zeros(B, dtype=np.int64)

    x = coords[:, 0].astype(np.int64)
    y = coords[:, 1].astype(np.int64)
    ev = coords[:, -1].astype(np.int64)
    corrected = pulses.astype(np.float64).copy()
    corrected[:, :n_samples] *= gains[x, y, 0][:, None]
    corrected[:, n_samples:] *= gains[x, y, 1][:, None]
    totl = corrected[:, :n_samples].sum(axis=1)
    totr = corrected[:, n_samples:].sum(axis=1)
    psd_l = np.array([calc_psd(corrected[i, :n_samples],
                               calc_arrival(corrected[i, :n_samples]))
                      for i in range(len(corrected))])
    psd_r = np.array([calc_psd(corrected[i, n_samples:],
                               calc_arrival(corrected[i, n_samples:]))
                      for i in range(len(corrected))])
    tl = np.array([calc_time(corrected[i, :n_samples]) for i in range(len(corrected))])
    tr = np.array([calc_time(corrected[i, n_samples:]) for i in range(len(corrected))])

    for b in range(B):
        sel = ev == b
        if not sel.any():
            continue
        i = np.flatnonzero(sel)
        m = i.size
        multiplicity[b] = m
        n_SE[b] = int((seg_status[x[i], y[i]] == 0.5).sum())
        tl_c, tr_c = totl[i].sum(), totr[i].sum()
        tot = totl[i] + totr[i]
        E_cur = float(tot.sum()) / m
        wsum = tl_c + tr_c
        oc = (coords[i, :2].astype(np.float64) * tot[:, None]).sum(axis=0)
        dt = float(((tr[i] - tl[i]) * tot).sum())
        if wsum > 0:
            oc /= wsum
            dt /= wsum
        pl = float((psd_l[i] * totl[i]).sum())
        pr = float((psd_r[i] * totr[i]).sum())
        psdl[b] = pl / tl_c if tl_c > 0 else pl
        psdr[b] = pr / tr_c if tr_c > 0 else pr
        out_coords[b] = oc
        out_pulses[b] = corrected[i].sum(axis=0)
        out_stats[0, b], out_stats[1, b], out_stats[2, b], out_stats[3, b] = \
            calc_spread(coords[i], corrected[i], n_samples, oc[0], oc[1], dt, E_cur)
        pulse = out_pulses[b, :n_samples] + out_pulses[b, n_samples:]
        out_stats[4, b], _, _ = moment(times, n_samples, weights=pulse)
        out_stats[5, b], _, _ = moment(pulse, n_samples)
    return {"coords": out_coords, "pulses": out_pulses, "stats": out_stats,
            "multiplicity": multiplicity, "psdl": psdl, "psdr": psdr, "n_SE": n_SE}


def weighted_average_quantities(coords: np.ndarray, quantities: np.ndarray,
                                n_events: int):
    """Energy-weighted per-event averages of phys features (ref :491-529).

    quantities: [F, N] with energy at row 0. Returns (out_coords [B,2],
    out_quantities [F,B], out_mult [B]).
    """
    F = quantities.shape[0]
    ev = coords[:, -1].astype(np.int64)
    out_q = np.zeros((F, n_events))
    out_c = np.zeros((n_events, 2))
    out_m = np.zeros(n_events, dtype=np.int64)
    e = quantities[0].astype(np.float64)
    # reference accumulates coords weighted by the RUNNING energy sum (quirk
    # preserved: coord * cumulative energy at that row)
    for b in range(n_events):
        sel = np.flatnonzero(ev == b)
        if sel.size == 0:
            continue
        run_e = np.cumsum(e[sel])
        ene = float(run_e[-1])
        oc = (coords[sel, :2].astype(np.float64) * run_e[:, None]).sum(axis=0)
        if ene > 0:
            out_c[b] = oc / ene
            for f in range(1, F):
                out_q[f, b] = float((quantities[f, sel] * e[sel]).sum()) / ene
            out_q[0, b] = ene
            out_m[b] = sel.size
    return out_c, out_q, out_m
