"""Host-side graph construction (counterpart of waveformml_tpu/ops/graph.py):
window-neighbourhood edges and per-event kNN over detector positions, the
padding of edge lists to a static size, and Cartesian edge attributes.

``window_edges`` and ``knn_graph`` run the C++/OpenMP library
``csrc/window_edges.cpp`` (built by ``ops.native.load_host`` with g++ on
first use); a failed build raises ``ops.native.KernelError``.
``window_edges_numpy`` and ``knn_graph_numpy`` are their plain versions,
which the tests hold the library to. Both follow the library's order:
window edges are each row's self loop (optional), then its ``(i, j)``,
``(j, i)`` pairs in ascending j; kNN edges are ``(source=neighbour,
target=row)`` pairs, each row's neighbours nearest first, the lower row
index first among equal distances (``std::partial_sort`` over ``(distance,
j)`` pairs; numpy's stable sort in the plain version). Detector positions
are integer cells, so equal distances are the rule.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from waveformml_tpu_torch.ops import native

_LIBRARY = "window_edges"
_FUNCTIONS = {
    "window_edges_count": ("i64", ["i64", "i64", "ptr", "ptr", "ptr", "bool", "ptr"]),
    "window_edges_fill": ("void", ["i64", "i64", "ptr", "ptr", "ptr", "bool", "ptr", "ptr",
                                   "ptr"]),
    "knn_edges": ("i64", ["i64", "i64", "ptr", "ptr", "ptr", "bool", "ptr", "ptr"]),
}


def library():
    """The loaded C++ edge library (built on first use)."""
    return native.load_host(_LIBRARY, _FUNCTIONS)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def window_edges(coo: np.ndarray, batch: np.ndarray, max_dist: int = 1,
                 self_loops: bool = True) -> np.ndarray:
    """Edges between rows of one event within Chebyshev distance
    ``max_dist`` (the library's bound is strict, ``< max_dist + 1``).
    ``coo`` [N, 2] integer coords, ``batch`` [N] sorted event ids.
    Returns [2, E] int64."""
    x, y, b = _i64(coo[:, 0]), _i64(coo[:, 1]), _i64(batch)
    n = x.shape[0]
    if n == 0:
        return np.zeros((2, 0), dtype=np.int64)
    lib = library()
    counts = np.zeros(n, dtype=np.int64)
    total = lib.window_edges_count(max_dist + 1, n, x.ctypes.data, y.ctypes.data,
                                   b.ctypes.data, bool(self_loops), counts.ctypes.data)
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    edges = np.zeros((2, total), dtype=np.int64)
    lib.window_edges_fill(max_dist + 1, n, x.ctypes.data, y.ctypes.data, b.ctypes.data,
                          bool(self_loops), offsets.ctypes.data, edges[0].ctypes.data,
                          edges[1].ctypes.data)
    return edges


def _event_bounds(b: np.ndarray) -> np.ndarray:
    starts = np.flatnonzero(np.diff(b)) + 1
    return np.concatenate([[0], starts, [b.shape[0]]])


def window_edges_numpy(coo: np.ndarray, batch: np.ndarray, max_dist: int = 1,
                       self_loops: bool = True) -> np.ndarray:
    """The plain version of ``window_edges``, edge for edge in its order."""
    x, y, b = _i64(coo[:, 0]), _i64(coo[:, 1]), _i64(batch)
    bounds = _event_bounds(b)
    src, dst = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        for i in range(lo, hi):
            if self_loops:
                src.append(i)
                dst.append(i)
            j = np.arange(i + 1, hi)
            near = j[(np.abs(x[j] - x[i]) <= max_dist) & (np.abs(y[j] - y[i]) <= max_dist)]
            pairs = np.stack([np.full_like(near, i), near], 1)
            src += pairs.reshape(-1).tolist()
            dst += pairs[:, ::-1].reshape(-1).tolist()
    return np.array([src, dst], dtype=np.int64).reshape(2, -1)


def knn_graph(pos: np.ndarray, k: int, batch: np.ndarray, loop: bool = False) -> np.ndarray:
    """Each row's k nearest rows of its event by squared Euclidean
    distance (fewer where the event has fewer), as ``(source=neighbour,
    target=row)`` pairs. ``pos`` [N, 2], ``batch`` [N] sorted event ids.
    Returns [2, E] int64."""
    n = pos.shape[0]
    if n == 0:
        return np.zeros((2, 0), dtype=np.int64)
    px = np.ascontiguousarray(pos[:, 0], dtype=np.float64)
    py = np.ascontiguousarray(pos[:, 1], dtype=np.float64)
    b = _i64(batch)
    lib = library()
    edges = np.zeros((2, n * k), dtype=np.int64)
    total = lib.knn_edges(k, n, px.ctypes.data, py.ctypes.data, b.ctypes.data, bool(loop),
                          edges[0].ctypes.data, edges[1].ctypes.data)
    return np.ascontiguousarray(edges[:, :total])


def knn_graph_numpy(pos: np.ndarray, k: int, batch: np.ndarray,
                    loop: bool = False) -> np.ndarray:
    """The plain version of ``knn_graph``, edge for edge in its order: a
    stable sort of each row's distances, so that the lower row index wins
    among equal distances."""
    p = np.asarray(pos, dtype=np.float64)
    b = _i64(batch)
    bounds = _event_bounds(b)
    src, dst = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        q = p[lo:hi]
        d = ((q[:, None, 0] - q[None, :, 0]) ** 2 + (q[:, None, 1] - q[None, :, 1]) ** 2)
        if not loop:
            np.fill_diagonal(d, np.inf)
        kk = min(k, hi - lo - (0 if loop else 1))
        if kk <= 0:
            continue
        idx = np.argsort(d, axis=1, kind="stable")[:, :kk]
        src += (lo + idx).reshape(-1).tolist()
        dst += np.repeat(np.arange(lo, hi), kk).tolist()
    return np.array([src, dst], dtype=np.int64).reshape(2, -1)


def pad_edges(edges: np.ndarray, n_edges: int, edge_attr: Optional[np.ndarray] = None):
    """An edge list padded to ``n_edges`` columns with its validity mask:
    padded edges point 0 → 0 and are masked out of every aggregation.
    Returns (edges, mask) or, with ``edge_attr``, (edges, mask, attr)."""
    e = edges.shape[1]
    if e > n_edges:
        raise ValueError(f"{e} edges > bucket {n_edges}")
    out = np.zeros((2, n_edges), dtype=np.int64)
    out[:, :e] = edges
    mask = np.zeros(n_edges, dtype=bool)
    mask[:e] = True
    if edge_attr is None:
        return out, mask
    attr = np.zeros((n_edges,) + edge_attr.shape[1:], dtype=edge_attr.dtype)
    attr[:e] = edge_attr
    return out, mask, attr


def cartesian_edge_attr(pos: np.ndarray, edges: np.ndarray, local: bool = False,
                        norm: bool = True, max_value: Optional[float] = None) -> np.ndarray:
    """PyG's Cartesian / LocalCartesian edge attributes: target − source
    positions, normalised to [0, 1] by the largest |component| (over all
    edges, or ``max_value``; ``local``: over the target's incoming edges)."""
    rel = pos[edges[1]] - pos[edges[0]]
    if local:
        amax = np.abs(rel).max(axis=1) if rel.size else np.zeros(0)
        per_node = np.zeros(pos.shape[0])
        np.maximum.at(per_node, edges[1], amax)
        scale = np.maximum(per_node[edges[1]], 1e-9)[:, None]
        return rel / (2 * scale) + 0.5
    if norm:
        mv = max_value if max_value is not None else np.abs(rel).max(initial=1e-9)
        return rel / (2 * mv) + 0.5
    return rel
