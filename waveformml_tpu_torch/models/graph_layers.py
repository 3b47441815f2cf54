"""Message-passing graph convolutions over padded edge lists (counterpart
of waveformml_tpu/models/graph_layers.py).

The 18 convs the reference selects by index (``GRAPH_CONV_BY_INDEX``) and
``GINEConv``, each PyG layer's inference-time formula, over static shapes:
features ``x [N, F]``, ``edges [2, E]`` (source, target), ``edge_mask
[E]`` and optional ``edge_attr`` (``[E, D]``, or ``[E]`` edge weights).
Padded edges are masked out of every aggregation. The device ops under
them are PyTorch calls (``index_add``, ``scatter_reduce``, a stable sort);
no hand-written kernel runs here. Parameters keep flax's names (``lin``,
``lin_l``, ``att_src``, ``mu``, ...), so that ``convert.py`` carries them
path for path; a Dense is an ``nn.Linear`` (``[out, in]``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from waveformml_tpu_torch.models.blocks import LinearPlanes, lecun_normal_


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``mask [E]`` broadcast against ``like [E, ...]``."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def segment_sum(messages: torch.Tensor, targets: torch.Tensor, n_nodes: int,
                edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each node's sum of the messages of its incoming live edges."""
    if edge_mask is not None:
        messages = torch.where(_rows(edge_mask, messages), messages, 0)
    out = messages.new_zeros((n_nodes,) + messages.shape[1:])
    return out.index_add(0, targets, messages)


def segment_mean(messages, targets, n_nodes, edge_mask=None):
    """``segment_sum`` over the live in-degree (at least 1)."""
    s = segment_sum(messages, targets, n_nodes, edge_mask)
    ones = messages.new_ones((messages.shape[0], 1))
    cnt = segment_sum(ones, targets, n_nodes, edge_mask)
    return s / cnt.clamp(min=1)


def _segment_amax(messages, targets, n_nodes):
    """Each node's largest incoming message, -inf where it has none."""
    out = messages.new_full((n_nodes,) + messages.shape[1:], -math.inf)
    index = targets.long().reshape((-1,) + (1,) * (messages.dim() - 1)).expand_as(messages)
    return out.scatter_reduce(0, index, messages, "amax", include_self=False)


def segment_max(messages, targets, n_nodes, edge_mask=None):
    """Each node's largest message over its incoming live edges; a node
    without one (or whose largest is not finite) gets 0."""
    if edge_mask is not None:
        messages = torch.where(_rows(edge_mask, messages), messages, -math.inf)
    out = _segment_amax(messages, targets, n_nodes)
    return torch.where(torch.isfinite(out), out, 0)


def edge_softmax(logits: torch.Tensor, targets: torch.Tensor, n_nodes: int,
                 edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax of ``logits [E, H]`` over each target node's incoming live
    edges (masked edges get 0)."""
    if edge_mask is not None:
        logits = torch.where(_rows(edge_mask, logits), logits, -math.inf)
    maxes = _segment_amax(logits, targets, n_nodes)
    maxes = torch.where(torch.isfinite(maxes), maxes, 0)
    exp = torch.exp(logits - maxes[targets])
    if edge_mask is not None:
        exp = torch.where(_rows(edge_mask, exp), exp, 0)
    denom = exp.new_zeros((n_nodes,) + exp.shape[1:]).index_add(0, targets, exp)
    return exp / denom[targets].clamp(min=1e-16)


#: bytes of the ``[strip, candidates, features]`` differences that
#: ``feature_knn`` holds at once
KNN_CHUNK_BYTES = 64 << 20


def feature_knn(x: torch.Tensor, batch: torch.Tensor, node_mask: torch.Tensor, k: int,
                block: int = 1024):
    """The kNN graph rebuilt from features, each live row's k nearest live
    rows of its own event: ``(edges [2, N·k] int32 (source=neighbour,
    target=centre), edge_mask [N·k])``; a centre with fewer than k such
    rows gets its tail slots masked (their sources are not specified).

    As the JAX package computes it: squared distances as the sum of
    squared differences (not ‖a‖² + ‖b‖² − 2ab, whose cancellation moves
    near-ties), in float32, ordered by a stable sort over candidates in
    row order, so that the lower row index wins exact ties; centres in
    strips of ``block`` rows. The live rows of an event are consecutive (a
    prepared batch's are), so each centre's candidates are the rows from
    its event's first live row to its last, at most M (the largest such
    span): a strip holds ``[block, M, features]`` differences, summed over
    feature chunks of at most ``KNN_CHUNK_BYTES``, never ``[block, N]``.
    Finding the spans reads ``batch`` and ``node_mask`` on the host (one
    synchronisation a call). Raises ``ValueError`` where the live rows are
    not grouped by event in ascending order."""
    n = x.shape[0]
    dev = x.device
    xf = x.float()
    b_host = batch.detach().cpu().numpy().astype(np.int64)
    live = np.flatnonzero(node_mask.detach().cpu().numpy())
    b_live = b_host[live]
    if np.any(np.diff(b_live) < 0):
        raise ValueError("feature_knn needs the live rows grouped by event in ascending order")
    # each live row's event span [lo, lo + count) of rows
    lo = np.zeros(n, np.int64)
    count = np.zeros(n, np.int64)
    if live.size:
        first = np.searchsorted(b_live, b_live, "left")
        last = np.searchsorted(b_live, b_live, "right") - 1
        lo[live] = live[first]
        count[live] = live[last] - live[first] + 1
    m = max(1, int(count.max()) if n else 1)
    lo_d = torch.from_numpy(lo).to(dev)
    count_d = torch.from_numpy(count).to(dev)
    batch_l = batch.long()
    offsets = torch.arange(m, device=dev)
    kk = min(k, m)
    src = torch.zeros((n, k), dtype=torch.int64, device=dev)
    vals = torch.full((n, k), math.inf, dtype=torch.float32, device=dev)
    width = max(1, xf.shape[1])
    for s in range(0, n, max(1, int(block))):
        e = min(s + max(1, int(block)), n)
        rows = torch.arange(s, e, device=dev)
        cand = (lo_d[s:e, None] + offsets).clamp(max=n - 1)
        chunk = max(1, KNN_CHUNK_BYTES // (4 * (e - s) * m))
        d2 = xf.new_zeros((e - s, m))
        for f0 in range(0, width, chunk):
            diff = xf[s:e, None, f0:f0 + chunk] - xf[cand, f0:f0 + chunk]
            d2 = d2 + (diff ** 2).sum(-1)
        invalid = ((offsets >= count_d[s:e, None]) | ~node_mask[cand]
                   | ~node_mask[s:e, None] | (cand == rows[:, None])
                   | (batch_l[cand] != batch_l[s:e, None]))
        d2 = torch.where(invalid, math.inf, d2)
        order = torch.sort(d2, dim=1, stable=True).indices[:, :kk]
        vals[s:e, :kk] = torch.gather(d2, 1, order)
        src[s:e, :kk] = torch.gather(cand, 1, order)
    dst = torch.arange(n, device=dev).repeat_interleave(k)
    edges = torch.stack([src.reshape(-1), dst]).to(torch.int32)
    return edges, torch.isfinite(vals).reshape(-1)


def _sym_norm(edges, edge_mask, n_nodes, edge_weight=None):
    """D^-1/2 A D^-1/2 edge coefficients (GCN normalisation)."""
    w = (edge_weight if edge_weight is not None
         else torch.ones(edges.shape[1], dtype=torch.float32, device=edges.device))
    if edge_mask is not None:
        w = torch.where(edge_mask, w, 0)
    deg = w.new_zeros(n_nodes).index_add(0, edges[1], w)
    dinv = torch.rsqrt(deg.clamp(min=1e-12))
    return w * dinv[edges[0]] * dinv[edges[1]]


def add_self_loops(edges, edge_mask, n_nodes, edge_weight=None, fill_value: float = 1.0):
    """Exactly one live ``(i, i)`` edge per node: the input's own loops
    are masked, and n edges are always appended (weight ``fill_value``)."""
    loop_free = edges[0] != edges[1]
    edge_mask = loop_free if edge_mask is None else (edge_mask & loop_free)
    loops = torch.arange(n_nodes, dtype=edges.dtype, device=edges.device)
    edges = torch.cat([edges, torch.stack([loops, loops])], dim=1)
    edge_mask = torch.cat([edge_mask, torch.ones(n_nodes, dtype=torch.bool,
                                                 device=edge_mask.device)])
    if edge_weight is not None:
        edge_weight = torch.cat([edge_weight, edge_weight.new_full((n_nodes,), fill_value)])
    return edges, edge_mask, edge_weight


def _edge_weight(edge_attr):
    """Edge weights from ``edge_attr``: its first column, or itself where 1-D."""
    if edge_attr is None:
        return None
    return edge_attr[:, 0] if edge_attr.dim() == 2 else edge_attr


def _dense(nin: int, nout: int, bias: bool = True, generator=None, device=None) -> nn.Linear:
    """flax's ``nn.Dense``: lecun-normal kernel, zero bias."""
    layer = nn.Linear(nin, nout, bias=bias, device=device)
    lecun_normal_(layer.weight, nin, generator)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def _param(shape, init: str, generator=None, device=None) -> nn.Parameter:
    """A parameter of ``shape`` by flax's initializer ``init``: "zeros",
    "ones", "glorot_uniform" or "normal0.1"."""
    if init == "zeros":
        t = torch.zeros(shape, device=device)
    elif init == "ones":
        t = torch.ones(shape, device=device)
    elif init == "glorot_uniform":
        limit = math.sqrt(6.0 / (shape[0] + shape[1]))
        t = (torch.rand(shape, generator=generator) * 2 - 1).mul_(limit).to(device)
    else:
        t = (torch.randn(shape, generator=generator) * 0.1).to(device)
    return nn.Parameter(t)


class GCNConv(nn.Module):
    """(index 0) X' = D̂^-1/2 Â D̂^-1/2 X Θ + b, Â = A + I (self loops of
    weight 1 added by default); edge weights from ``edge_attr``."""

    def __init__(self, in_channels, out_channels, with_self_loops=True, generator=None,
                 device=None):
        super().__init__()
        self.with_self_loops = with_self_loops
        self.lin = _dense(in_channels, out_channels, False, generator, device)
        self.bias = _param((out_channels,), "zeros", device=device)

    def forward(self, x, edges, edge_mask, edge_attr=None):
        n = x.shape[0]
        h = self.lin(x)
        ew = _edge_weight(edge_attr)
        if ew is None:
            ew = x.new_ones(edges.shape[1])
        if self.with_self_loops:
            edges, edge_mask, ew = add_self_loops(edges, edge_mask, n, ew)
        coeff = _sym_norm(edges, edge_mask, n, ew)
        out = segment_sum(h[edges[0]] * coeff[:, None], edges[1], n, edge_mask)
        return out + self.bias


class SAGEConv(nn.Module):
    """(index 1) W_l · mean_agg(x_src) + b + W_r x (PyG: ``lin_l`` carries
    the bias, ``lin_r`` has none)."""

    def __init__(self, in_channels, out_channels, generator=None, device=None):
        super().__init__()
        self.lin_l = _dense(in_channels, out_channels, True, generator, device)
        self.lin_r = _dense(in_channels, out_channels, False, generator, device)

    def forward(self, x, edges, edge_mask, edge_attr=None):
        agg = segment_mean(x[edges[0]], edges[1], x.shape[0], edge_mask)
        return self.lin_l(agg) + self.lin_r(x)


class GraphConv(nn.Module):
    """(index 2) W_rel · sum_agg(e_w · x_src) + b + W_root x."""

    def __init__(self, in_channels, out_channels, generator=None, device=None):
        super().__init__()
        self.lin_rel = _dense(in_channels, out_channels, True, generator, device)
        self.lin_root = _dense(in_channels, out_channels, False, generator, device)

    def forward(self, x, edges, edge_mask, edge_attr=None):
        msg = x[edges[0]]
        ew = _edge_weight(edge_attr)
        if ew is not None:
            msg = msg * ew[:, None]
        agg = segment_sum(msg, edges[1], x.shape[0], edge_mask)
        return self.lin_rel(agg) + self.lin_root(x)


class GATConv(nn.Module):
    """(index 3) graph attention: self loops added by default,
    α_ij = softmax_j LeakyReLU(a_s·Θx_j + a_d·Θx_i) over j ∈ N(i) ∪ {i},
    x'_i = Σ_j α_ij Θx_j + b, the heads concatenated."""

    def __init__(self, in_channels, out_channels, heads=1, negative_slope=0.2,
                 with_self_loops=True, generator=None, device=None):
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        self.negative_slope = negative_slope
        self.with_self_loops = with_self_loops
        self.lin = _dense(in_channels, heads * out_channels, False, generator, device)
        self.att_src = _param((heads, out_channels), "glorot_uniform", generator, device)
        self.att_dst = _param((heads, out_channels), "glorot_uniform", generator, device)
        self.bias = _param((heads * out_channels,), "zeros", device=device)

    def forward(self, x, edges, edge_mask, edge_attr=None):
        n = x.shape[0]
        H, C = self.heads, self.out_channels
        h = self.lin(x).reshape(n, H, C)
        if self.with_self_loops:
            edges, edge_mask, _ = add_self_loops(edges, edge_mask, n)
        alpha = (h[edges[0]] * self.att_src).sum(-1) + (h[edges[1]] * self.att_dst).sum(-1)
        alpha = F.leaky_relu(alpha, self.negative_slope)
        alpha = edge_softmax(alpha, edges[1], n, edge_mask)
        out = segment_sum((h[edges[0]] * alpha[..., None]).reshape(-1, H * C), edges[1], n,
                          edge_mask)
        return out + self.bias


class GATv2Conv(nn.Module):
    """(index 4) GATv2: the attention after the nonlinearity; its linears
    carry biases; self loops added by default."""

    def __init__(self, in_channels, out_channels, heads=1, negative_slope=0.2,
                 with_self_loops=True, generator=None, device=None):
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        self.negative_slope = negative_slope
        self.with_self_loops = with_self_loops
        self.lin_l = _dense(in_channels, heads * out_channels, True, generator, device)
        self.lin_r = _dense(in_channels, heads * out_channels, True, generator, device)
        self.att = _param((heads, out_channels), "glorot_uniform", generator, device)
        self.bias = _param((heads * out_channels,), "zeros", device=device)

    def forward(self, x, edges, edge_mask, edge_attr=None):
        n = x.shape[0]
        H, C = self.heads, self.out_channels
        hl = self.lin_l(x).reshape(n, H, C)
        hr = self.lin_r(x).reshape(n, H, C)
        if self.with_self_loops:
            edges, edge_mask, _ = add_self_loops(edges, edge_mask, n)
        z = F.leaky_relu(hl[edges[0]] + hr[edges[1]], self.negative_slope)
        alpha = edge_softmax((z * self.att).sum(-1), edges[1], n, edge_mask)
        out = segment_sum((hl[edges[0]] * alpha[..., None]).reshape(-1, H * C), edges[1], n,
                          edge_mask)
        return out + self.bias


class TransformerConv(nn.Module):
    """(index 5) scaled dot-product attention over incoming edges, the
    edge features (``edge_dim`` wide, where given) added to keys and
    values, plus a skip linear."""

    def __init__(self, in_channels, out_channels, heads=1, edge_dim=None, generator=None,
                 device=None):
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        hc = heads * out_channels
        self.q = _dense(in_channels, hc, True, generator, device)
        self.k = _dense(in_channels, hc, True, generator, device)
        self.v = _dense(in_channels, hc, True, generator, device)
        self.edge = _dense(edge_dim, hc, True, generator, device) if edge_dim else None
        self.skip = _dense(in_channels, hc, True, generator, device)

    def forward(self, x, edges, edge_mask, edge_attr=None):
        n = x.shape[0]
        H, C = self.heads, self.out_channels
        q = self.q(x).reshape(n, H, C)
        ke = self.k(x).reshape(n, H, C)[edges[0]]
        ve = self.v(x).reshape(n, H, C)[edges[0]]
        if edge_attr is not None:
            if self.edge is None:
                raise ValueError("TransformerConv got edge_attr but has no edge_dim")
            e = self.edge(edge_attr).reshape(-1, H, C)
            ke, ve = ke + e, ve + e
        alpha = (q[edges[1]] * ke).sum(-1) / math.sqrt(C)
        alpha = edge_softmax(alpha, edges[1], n, edge_mask)
        out = segment_sum((ve * alpha[..., None]).reshape(-1, H * C), edges[1], n, edge_mask)
        return out + self.skip(x)


class TAGConv(nn.Module):
    """(index 6) Σ_{k=0..K} W_k (norm-A)^k x + b: K+1 bias-free linears,
    no self loops, one output bias; edge weights from ``edge_attr``."""

    def __init__(self, in_channels, out_channels, K=3, generator=None, device=None):
        super().__init__()
        self.K = K
        for k in range(K + 1):
            self.add_module(f"lin_{k}", _dense(in_channels, out_channels, False, generator,
                                               device))
        self.bias = _param((out_channels,), "zeros", device=device)

    def forward(self, x, edges, edge_mask, edge_attr=None):
        n = x.shape[0]
        coeff = _sym_norm(edges, edge_mask, n, _edge_weight(edge_attr))
        out = self.lin_0(x)
        h = x
        for k in range(1, self.K + 1):
            h = segment_sum(h[edges[0]] * coeff[:, None], edges[1], n, edge_mask)
            out = out + getattr(self, f"lin_{k}")(h)
        return out + self.bias


class _GraphMLP(nn.Module):
    """``LinearPlanes`` with ReLU after every layer, under flax's name of
    the JAX module's child (``LinearPlanes_0``): GIN's and EdgeConv's net."""

    def __init__(self, planes: Sequence[int], generator=None, device=None):
        super().__init__()
        self.LinearPlanes_0 = LinearPlanes(planes, activation=torch.relu,
                                           generator=generator, device=device)

    def forward(self, x):
        return self.LinearPlanes_0(x)


class _NetConv(nn.Module):
    """A conv around a net. Its net is its child ``net``, or, ``hoisted``,
    a module the caller registers elsewhere (flax keeps a net built in the
    caller's compact scope beside the conv: ``_GraphMLP_<i>``)."""

    def __init__(self, net: nn.Module, hoisted: bool = False):
        super().__init__()
        if hoisted:
            self.__dict__["_hoisted_net"] = net
        else:
            self.net = net

    def _net(self) -> nn.Module:
        net = self.__dict__.get("_hoisted_net")
        return self.net if net is None else net


class GINConv(_NetConv):
    """(index 7) net((1 + ε)x + sum_agg(x_src))."""

    def __init__(self, net, eps: float = 0.0, hoisted: bool = False):
        super().__init__(net, hoisted)
        self.eps = eps

    def forward(self, x, edges, edge_mask, edge_attr=None):
        agg = segment_sum(x[edges[0]], edges[1], x.shape[0], edge_mask)
        return self._net()((1 + self.eps) * x + agg)


class GINEConv(_NetConv):
    """GINE: relu(x_src + edge_proj(edge_attr)) summed, then as GIN."""

    def __init__(self, net, in_channels: int, edge_dim: Optional[int] = None,
                 eps: float = 0.0, hoisted: bool = False, generator=None, device=None):
        super().__init__(net, hoisted)
        self.eps = eps
        self.edge_proj = (_dense(edge_dim, in_channels, True, generator, device)
                          if edge_dim else None)

    def forward(self, x, edges, edge_mask, edge_attr=None):
        msg = x[edges[0]]
        if edge_attr is not None:
            msg = torch.relu(msg + self.edge_proj(edge_attr))
        agg = segment_sum(msg, edges[1], x.shape[0], edge_mask)
        return self._net()((1 + self.eps) * x + agg)


class ARMAConv(nn.Module):
    """(index 8) one ARMA stack: h ← relu(V_l · norm-A h + W_l x), for
    ``num_layers`` layers; edge weights from ``edge_attr``."""

    def __init__(self, in_channels, out_channels, num_layers=1, generator=None, device=None):
        super().__init__()
        self.num_layers = num_layers
        for layer in range(num_layers):
            nin = in_channels if layer == 0 else out_channels
            self.add_module(f"V_{layer}", _dense(nin, out_channels, True, generator, device))
            self.add_module(f"W_{layer}", _dense(in_channels, out_channels, True, generator,
                                                 device))

    def forward(self, x, edges, edge_mask, edge_attr=None):
        n = x.shape[0]
        coeff = _sym_norm(edges, edge_mask, n, _edge_weight(edge_attr))
        h = x
        for layer in range(self.num_layers):
            prop = segment_sum(h[edges[0]] * coeff[:, None], edges[1], n, edge_mask)
            h = torch.relu(getattr(self, f"V_{layer}")(prop) + getattr(self, f"W_{layer}")(x))
        return h


class SGConv(nn.Module):
    """(index 9) W (D̂^-1/2 Â D̂^-1/2)^K x + b, Â = A + I."""

    def __init__(self, in_channels, out_channels, K=1, with_self_loops=True, generator=None,
                 device=None):
        super().__init__()
        self.K = K
        self.with_self_loops = with_self_loops
        self.lin = _dense(in_channels, out_channels, True, generator, device)

    def forward(self, x, edges, edge_mask, edge_attr=None):
        n = x.shape[0]
        ew = _edge_weight(edge_attr)
        if ew is None:
            ew = x.new_ones(edges.shape[1])
        if self.with_self_loops:
            edges, edge_mask, ew = add_self_loops(edges, edge_mask, n, ew)
        coeff = _sym_norm(edges, edge_mask, n, ew)
        h = x
        for _ in range(self.K):
            h = segment_sum(h[edges[0]] * coeff[:, None], edges[1], n, edge_mask)
        return self.lin(h)


class GMMConv(nn.Module):
    """(index 10) Gaussian-mixture conv over pseudo-coordinates ``edge_attr
    [E, dim]``: x'_i = mean_j Σ_k w_k(e_ij) Θ_k x_j + W_root x_i + b,
    w_k(e) = exp(-½ Σ_d (e_d − μ_kd)² / σ_kd²)."""

    def __init__(self, in_channels, out_channels, dim=2, kernel_size=3, root_weight=True,
                 generator=None, device=None):
        super().__init__()
        self.dim, self.kernel_size, self.out_channels = dim, kernel_size, out_channels
        self.mu = _param((kernel_size, dim), "normal0.1", generator, device)
        self.sigma = _param((kernel_size, dim), "ones", device=device)
        self.g = _dense(in_channels, kernel_size * out_channels, False, generator, device)
        self.root = (_dense(in_channels, out_channels, False, generator, device)
                     if root_weight else None)
        self.bias = _param((out_channels,), "zeros", device=device)

    def forward(self, x, edges, edge_mask, edge_attr=None):
        n = x.shape[0]
        if edge_attr is None:
            edge_attr = x.new_zeros((edges.shape[1], self.dim))
        diff = edge_attr[:, None, :] - self.mu[None]
        w = torch.exp(-0.5 * ((diff / self.sigma.abs().clamp(min=1e-6)) ** 2).sum(-1))
        h = self.g(x).reshape(n, self.kernel_size, self.out_channels)
        msg = (h[edges[0]] * w[..., None]).sum(1)
        out = segment_mean(msg, edges[1], n, edge_mask)
        if self.root is not None:
            out = out + self.root(x)
        return out + self.bias


class FiLMConv(nn.Module):
    """(index 11) FiLM-modulated messages (one relation):
    x'_i = relu(γ_s ⊙ W_s x_i + β_s) + mean_j relu(γ_i ⊙ W x_j + β_i),
    (β, γ) = film(x_i), (β_s, γ_s) = film_skip(x_i)."""

    def __init__(self, in_channels, out_channels, generator=None, device=None):
        super().__init__()
        self.film = _dense(in_channels, 2 * out_channels, True, generator, device)
        self.lin = _dense(in_channels, out_channels, False, generator, device)
        self.film_skip = _dense(in_channels, 2 * out_channels, True, generator, device)
        self.lin_skip = _dense(in_channels, out_channels, False, generator, device)

    def forward(self, x, edges, edge_mask, edge_attr=None):
        n = x.shape[0]
        beta, gamma = self.film(x).chunk(2, dim=-1)
        msg = self.lin(x)
        mod = torch.relu(gamma[edges[1]] * msg[edges[0]] + beta[edges[1]])
        agg = segment_mean(mod, edges[1], n, edge_mask)
        beta_s, gamma_s = self.film_skip(x).chunk(2, dim=-1)
        return agg + torch.relu(gamma_s * self.lin_skip(x) + beta_s)


def edge_conv(net: nn.Module, x, edges, edge_mask):
    """max_j net([x_i ‖ x_j − x_i]) over the incoming live edges."""
    src, dst = edges[0], edges[1]
    z = torch.cat([x[dst], x[src] - x[dst]], dim=-1)
    return segment_max(net(z), dst, x.shape[0], edge_mask)


class EdgeConv(_NetConv):
    """(index 12) DGCNN's edge conv: ``edge_conv`` with its net."""

    def forward(self, x, edges, edge_mask, edge_attr=None):
        return edge_conv(self._net(), x, edges, edge_mask)


class FeaStConv(nn.Module):
    """(index 13) x'_i = mean_{j∈N(i)∪{i}} Σ_h q_h W_h x_j + b,
    q = softmax_h(u(x_j − x_i) + c); self loops added by default."""

    def __init__(self, in_channels, out_channels, heads=4, with_self_loops=True,
                 generator=None, device=None):
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        self.with_self_loops = with_self_loops
        self.u = _dense(in_channels, heads, True, generator, device)
        self.lin = _dense(in_channels, heads * out_channels, False, generator, device)
        self.bias = _param((out_channels,), "zeros", device=device)

    def forward(self, x, edges, edge_mask, edge_attr=None):
        n = x.shape[0]
        if self.with_self_loops:
            edges, edge_mask, _ = add_self_loops(edges, edge_mask, n)
        q = torch.softmax(self.u(x[edges[0]] - x[edges[1]]), dim=-1)
        h = self.lin(x).reshape(n, self.heads, self.out_channels)
        msg = (h[edges[0]] * q[..., None]).sum(1)
        return segment_mean(msg, edges[1], n, edge_mask) + self.bias


class LEConv(nn.Module):
    """(index 14) Σ_j e_w (W2 x_i − W3 x_j) + W1 x_i."""

    def __init__(self, in_channels, out_channels, generator=None, device=None):
        super().__init__()
        self.lin2 = _dense(in_channels, out_channels, True, generator, device)
        self.lin3 = _dense(in_channels, out_channels, True, generator, device)
        self.lin1 = _dense(in_channels, out_channels, True, generator, device)

    def forward(self, x, edges, edge_mask, edge_attr=None):
        h2, h3 = self.lin2(x), self.lin3(x)
        ew = _edge_weight(edge_attr)
        if ew is None:
            ew = x.new_ones(edges.shape[1])
        msg = ew[:, None] * (h2[edges[1]] - h3[edges[0]])
        return segment_sum(msg, edges[1], x.shape[0], edge_mask) + self.lin1(x)


class ClusterGCNConv(nn.Module):
    """(index 15) out_i = lin([Σ_{j∈N(i)} x_j + (1 + λ) x_i] / (deg_i + 1))."""

    def __init__(self, in_channels, out_channels, diag_lambda=0.0, generator=None,
                 device=None):
        super().__init__()
        self.diag_lambda = diag_lambda
        self.lin = _dense(in_channels, out_channels, True, generator, device)

    def forward(self, x, edges, edge_mask, edge_attr=None):
        n = x.shape[0]
        edges, edge_mask, _ = add_self_loops(edges, edge_mask, n)
        agg = segment_mean(x[edges[0]], edges[1], n, edge_mask)
        deg = segment_sum(x.new_ones((edges.shape[1], 1)), edges[1], n, edge_mask)
        return self.lin(agg + self.diag_lambda * x / deg.clamp(min=1))


class GENConv(nn.Module):
    """(index 16) softmax aggregation (t = ``beta``) of relu(h_j + e) + ε,
    then h + agg through a two-layer MLP; ``edge_proj`` (``edge_dim``
    wide) where the caller feeds edge features."""

    def __init__(self, in_channels, out_channels, beta=1.0, edge_dim=None, generator=None,
                 device=None):
        super().__init__()
        self.beta = beta
        self.lin_in = _dense(in_channels, out_channels, True, generator, device)
        self.edge_proj = (_dense(edge_dim, out_channels, True, generator, device)
                          if edge_dim else None)
        self.mlp1 = _dense(out_channels, 2 * out_channels, True, generator, device)
        self.mlp2 = _dense(2 * out_channels, out_channels, True, generator, device)

    def forward(self, x, edges, edge_mask, edge_attr=None):
        n = x.shape[0]
        h = self.lin_in(x)
        msg = h[edges[0]]
        if edge_attr is not None:
            if self.edge_proj is None:
                raise ValueError("GENConv got edge_attr but has no edge_dim")
            msg = msg + self.edge_proj(edge_attr)
        msg = torch.relu(msg) + 1e-7
        alpha = edge_softmax(msg * self.beta, edges[1], n, edge_mask)
        z = h + segment_sum(msg * alpha, edges[1], n, edge_mask)
        return self.mlp2(torch.relu(self.mlp1(z)))


class SuperGATConv(GATConv):
    """(index 17) SuperGAT: at inference its propagation is GATConv's."""


GRAPH_CONV_BY_INDEX = [
    GCNConv, SAGEConv, GraphConv, GATConv, GATv2Conv, TransformerConv,
    TAGConv, GINConv, ARMAConv, SGConv, GMMConv, FiLMConv, EdgeConv,
    FeaStConv, LEConv, ClusterGCNConv, GENConv, SuperGATConv,
]

def class_needs_nn(index: int) -> bool:
    """(ref: GraphNet.py:256-260)"""
    return index in (7, 12)


def needs_edge_attr(index: int) -> bool:
    """(ref: GraphNet.py:276-277)"""
    return index in (5, 10, 16)


def nn_input_modifier(index: int, num_layer: int, graph_params=None) -> int:
    """(ref: GraphNet.py:249-254)"""
    if index == 12:
        return 2
    if graph_params and "heads" in graph_params and num_layer > 0 and index == 17:
        return graph_params["heads"]
    return 1


def global_max_pool(x, batch, n_events: int, node_mask=None):
    return segment_max(x, batch, n_events, node_mask)


def global_mean_pool(x, batch, n_events: int, node_mask=None):
    return segment_mean(x, batch, n_events, node_mask)
