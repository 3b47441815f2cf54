"""Plotting utilities (the port's copy of waveformml_tpu/utils/plot.py,
after the reference's src/utils/PlotUtils.py).

Confusion matrices, 1D/2D histograms (+n-variants), ROC/PR curves, segment
matrices, average-waveform plots, scatter/multi-line. matplotlib (Agg
backend) is imported by each function that draws, so that the package
imports where matplotlib is missing; figures are returned for the logger to
serialize.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

MAIN_COLOR = "#1f77b4"


def _pyplot():
    """matplotlib's pyplot on the Agg backend (imported here, not when the
    module is imported: the package imports without matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_confusion_matrix(cm: np.ndarray, class_names: Optional[Sequence[str]] = None,
                          normalize: bool = True, title: str = "Confusion matrix"):
    """Confusion-matrix heatmap (ref: PlotUtils.py confusion plotting)."""
    plt = _pyplot()
    cm = np.asarray(cm, dtype=np.float64)
    n = cm.shape[0]
    names = list(class_names) if class_names else [str(i) for i in range(n)]
    if normalize:
        row = cm.sum(axis=1, keepdims=True)
        shown = np.divide(cm, row, out=np.zeros_like(cm), where=row != 0)
    else:
        shown = cm
    fig, ax = plt.subplots(figsize=(max(4, n), max(3.5, n * 0.9)))
    im = ax.imshow(shown, interpolation="nearest", cmap="Blues", vmin=0)
    fig.colorbar(im, ax=ax)
    ax.set(xticks=np.arange(n), yticks=np.arange(n),
           xticklabels=names, yticklabels=names,
           ylabel="True label", xlabel="Predicted label", title=title)
    plt.setp(ax.get_xticklabels(), rotation=45, ha="right")
    thresh = shown.max() / 2.0 if shown.size else 0.5
    for i in range(n):
        for j in range(n):
            ax.text(j, i, f"{shown[i, j]:.2f}",
                    ha="center", va="center",
                    color="white" if shown[i, j] > thresh else "black")
    fig.tight_layout()
    return fig


def plot_hist1d(edges: np.ndarray, values: np.ndarray, xlabel: str = "",
                ylabel: str = "", title: str = "", log: bool = False):
    plt = _pyplot()
    fig, ax = plt.subplots()
    centers = 0.5 * (edges[:-1] + edges[1:])
    ax.bar(centers, values, width=np.diff(edges), color=MAIN_COLOR, edgecolor="none")
    ax.set(xlabel=xlabel, ylabel=ylabel, title=title)
    if log:
        ax.set_yscale("log")
    fig.tight_layout()
    return fig


def plot_n_hist1d(edges: np.ndarray, value_sets: Sequence[np.ndarray],
                  labels: Sequence[str], xlabel: str = "", ylabel: str = "",
                  title: str = "", log: bool = False, norm: bool = False):
    plt = _pyplot()
    fig, ax = plt.subplots()
    centers = 0.5 * (edges[:-1] + edges[1:])
    for vals, lab in zip(value_sets, labels):
        v = np.asarray(vals, dtype=np.float64)
        if norm and v.sum():
            v = v / v.sum()
        ax.step(centers, v, where="mid", label=lab)
    ax.set(xlabel=xlabel, ylabel=ylabel, title=title)
    if log:
        ax.set_yscale("log")
    ax.legend()
    fig.tight_layout()
    return fig


def plot_hist2d(xedges: np.ndarray, yedges: np.ndarray, values: np.ndarray,
                xlabel: str = "", ylabel: str = "", title: str = "",
                log: bool = False, cmap: str = "viridis"):
    plt = _pyplot()
    from matplotlib.colors import LogNorm

    fig, ax = plt.subplots()
    norm = LogNorm() if log and values.max() > 0 else None
    pcm = ax.pcolormesh(xedges, yedges, np.asarray(values).T, cmap=cmap, norm=norm)
    fig.colorbar(pcm, ax=ax)
    ax.set(xlabel=xlabel, ylabel=ylabel, title=title)
    fig.tight_layout()
    return fig


def plot_n_hist2d(xedges, yedges, value_sets, titles, xlabel: str = "",
                  ylabel: str = "", suptitle: str = ""):
    plt = _pyplot()
    n = len(value_sets)
    ncols = min(3, n)
    nrows = -(-n // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(4 * ncols, 3.2 * nrows),
                             squeeze=False)
    for k, (vals, t) in enumerate(zip(value_sets, titles)):
        ax = axes[k // ncols][k % ncols]
        pcm = ax.pcolormesh(xedges, yedges, np.asarray(vals).T, cmap="viridis")
        fig.colorbar(pcm, ax=ax)
        ax.set(title=t, xlabel=xlabel, ylabel=ylabel)
    for k in range(n, nrows * ncols):
        axes[k // ncols][k % ncols].axis("off")
    if suptitle:
        fig.suptitle(suptitle)
    fig.tight_layout()
    return fig


def plot_segment_matrix(values: np.ndarray, title: str = "", label: str = "",
                        fmt: str = "{:.2f}"):
    """Per-segment (NX×NY) value heatmap (ref: StatsUtils segment rendering)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(np.asarray(values).T, origin="lower", cmap="viridis")
    fig.colorbar(im, ax=ax, label=label)
    ax.set(xlabel="x segment", ylabel="y segment", title=title)
    fig.tight_layout()
    return fig


def plot_roc_curve(fpr_per_class: Sequence[np.ndarray],
                   tpr_per_class: Sequence[np.ndarray],
                   class_names: Sequence[str], title: str = "ROC"):
    plt = _pyplot()
    fig, ax = plt.subplots()
    for fpr, tpr, name in zip(fpr_per_class, tpr_per_class, class_names):
        # np.trapezoid is numpy>=2 only; fall back on 1.x's np.trapz
        _trap = getattr(np, "trapezoid", None) or np.trapz
        auc = float(_trap(tpr, fpr)) if len(fpr) > 1 else 0.0
        ax.plot(fpr, tpr, label=f"{name} (AUC={abs(auc):.3f})")
    ax.plot([0, 1], [0, 1], "k--", lw=0.8)
    ax.set(xlabel="False positive rate", ylabel="True positive rate", title=title)
    ax.legend()
    fig.tight_layout()
    return fig


def plot_pr_curve(recall_per_class, precision_per_class, class_names,
                  title: str = "Precision-Recall"):
    plt = _pyplot()
    fig, ax = plt.subplots()
    for r, p, name in zip(recall_per_class, precision_per_class, class_names):
        ax.plot(r, p, label=name)
    ax.set(xlabel="Recall", ylabel="Precision", title=title)
    ax.legend()
    fig.tight_layout()
    return fig


def plot_waveforms(waveforms: Sequence[np.ndarray], labels: Sequence[str],
                   xlabel: str = "sample", ylabel: str = "amplitude",
                   title: str = "Average waveform", normalize: bool = False,
                   errors: Optional[Sequence[np.ndarray]] = None):
    """Waveform overlay (ref: PlotUtils.py plot_wfs): optional peak
    normalization and per-sample error bands."""
    plt = _pyplot()
    fig, ax = plt.subplots()
    for i, (wf, lab) in enumerate(zip(waveforms, labels)):
        wf = np.asarray(wf, dtype=np.float64)
        err = None if errors is None else np.asarray(errors[i], np.float64)
        if normalize:
            peak = np.abs(wf).max() or 1.0
            wf = wf / peak
            err = err / peak if err is not None else None
        xs = np.arange(len(wf))
        ax.plot(xs, wf, label=lab)
        if err is not None:
            ax.fill_between(xs, wf - err, wf + err, alpha=0.3)
    ax.set(xlabel=xlabel, ylabel=ylabel, title=title)
    ax.legend()
    fig.tight_layout()
    return fig


def plot_contour(X, Y, Z, xlabel: str = "", ylabel: str = "", title: str = "",
                 filled: bool = True, cmap: str = "viridis"):
    """Single contour plot of Z[x, y] on the (X, Y) grid
    (ref: PlotUtils.py:165-177 plot_contour; Z transposed so axis 0 is x)."""
    plt = _pyplot()
    fig, ax = plt.subplots()
    Zt = np.asarray(Z, dtype=np.float64).T
    if filled:
        cs = ax.contourf(X, Y, Zt, cmap=cmap)
        fig.colorbar(cs, ax=ax)
    else:
        cs = ax.contour(X, Y, Zt, cmap=cmap)
        ax.clabel(cs, inline=True)
    ax.set(xlabel=xlabel, ylabel=ylabel, title=title)
    fig.tight_layout()
    return fig


def plot_n_contour(X, Y, Zs: Sequence[np.ndarray], xlabel: str = "",
                   ylabel: str = "", titles: Sequence[str] = (),
                   suptitle: Optional[str] = None, cmap: str = "viridis"):
    """Grid of filled contour panels, ≤3 per row, outer labels only
    (ref: PlotUtils.py:120-162 plot_n_contour)."""
    plt = _pyplot()
    n = len(Zs)
    ncols = min(3, n)
    nrows = -(-n // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(3.9 * ncols, 4.0 * nrows),
                             squeeze=False)
    if suptitle:
        fig.suptitle(suptitle)
    for k, (z, t) in enumerate(zip(Zs, titles)):
        ax = axes[k // ncols][k % ncols]
        cs = ax.contourf(X, Y, np.asarray(z, dtype=np.float64).T, cmap=cmap)
        fig.colorbar(cs, ax=ax)
        ax.set_title(t)
        if k % ncols == 0:
            ax.set_ylabel(ylabel)
        if k // ncols == (n - 1) // ncols:
            ax.set_xlabel(xlabel)
        ax.label_outer()
    for k in range(n, nrows * ncols):
        axes[k // ncols][k % ncols].axis("off")
    return fig


def gen_animation(frames: Sequence, outfile: str, interval: int = 50):
    """Save an animated GIF/MP4 from a sequence of 2D arrays (rendered as
    imshow frames) or pre-built artists (ref: PlotUtils.py:668-676)."""
    plt = _pyplot()
    from matplotlib import animation

    fig = plt.figure()
    artists = []
    for fr in frames:
        if hasattr(fr, "get_figure"):          # already a matplotlib artist
            artists.append([fr])
        else:
            im = plt.imshow(np.asarray(fr, dtype=np.float64).T, origin="lower",
                            cmap="viridis", animated=True)
            artists.append([im])
    ani = animation.ArtistAnimation(fig, artists, interval=interval, blit=True,
                                    repeat_delay=1000)
    ani.save(outfile)
    plt.close(fig)
    return outfile


def plot_bar(x, y, xlabel: str = "", ylabel: str = "", title: str = ""):
    """Simple bar plot (ref: PlotUtils.py:180-185 plot_bar)."""
    plt = _pyplot()
    fig, ax = plt.subplots()
    ax.bar(x, y, color=MAIN_COLOR)
    ax.set(xlabel=xlabel, ylabel=ylabel, title=title)
    fig.tight_layout()
    return fig


def plot_scatter(x: np.ndarray, y: np.ndarray, xlabel: str = "", ylabel: str = "",
                 title: str = ""):
    plt = _pyplot()
    fig, ax = plt.subplots()
    ax.scatter(x, y, s=4, alpha=0.5, color=MAIN_COLOR)
    ax.set(xlabel=xlabel, ylabel=ylabel, title=title)
    fig.tight_layout()
    return fig


def plot_lines(x: np.ndarray, ys: Sequence[np.ndarray], labels: Sequence[str],
               xlabel: str = "", ylabel: str = "", title: str = ""):
    plt = _pyplot()
    fig, ax = plt.subplots()
    for y, lab in zip(ys, labels):
        ax.plot(x, y, label=lab)
    ax.set(xlabel=xlabel, ylabel=ylabel, title=title)
    ax.legend()
    fig.tight_layout()
    return fig
