"""Graph network models over detector pulse graphs (counterpart of
waveformml_tpu/models/graph_net.py): ``GraphNet`` (a kNN graph, one of the
18 convs by index, masked BatchNorm, a per-event max pool and a
``LinearBlock`` head; ``IoniClassifierGraph.json``), ``GraphZ`` with
``GraphZNet`` and ``SingleEndedEZGraph`` (per-segment stacks over window
edges and the ``knn1`` self edges, scattered to the dense ``[B, C, NX,
NY]`` grid), ``PointNet``, ``Graph3DNet`` (fixed time windows of the
waveform as 3D points), and ``DynamicEdgeConv`` / ``DynamicGraphConv``
(the kNN graph rebuilt from features in the forward).

The edges are built on the host (``ops.graph``, C++) by the task's
``prepare_block`` and ship as padded edge lists (``edges_knn<k>``,
``edges_w<d>`` with their ``edge_mask_*``); each model says which in
``edge_requirements()``. The models take the prepared batch as a dict
(``is_graph``) and name their modules as flax names the JAX models'.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch
from torch import nn

from waveformml_tpu_torch.config import to_dict
from waveformml_tpu_torch.detector import NX, NY
from waveformml_tpu_torch.models.blocks import LinearBlock, LinearPlanes, MaskedArrayBatchNorm
from waveformml_tpu_torch.models.graph_layers import (GRAPH_CONV_BY_INDEX, GCNConv,
                                                      _GraphMLP, class_needs_nn,
                                                      edge_conv, feature_knn,
                                                      global_max_pool, needs_edge_attr,
                                                      nn_input_modifier, segment_max)
from waveformml_tpu_torch.registry import registry


def _options(cls, params: Dict) -> Dict:
    """The entries of ``params`` that ``cls`` takes as options (the JAX
    package keeps a module's dataclass fields), its channels excepted."""
    names = set(inspect.signature(cls).parameters) - {
        "in_channels", "in_planes", "out_channels", "out_planes", "generator", "device"}
    return {k: v for k, v in dict(params).items() if k in names}


def _make_conv(index: int, nin: int, nout: int, graph_params: Dict, kernel: int = 3,
               edge_dim: Optional[int] = None, hoisted_net: Optional[nn.Module] = None,
               generator=None, device=None) -> nn.Module:
    """Conv ``index`` from nin to nout channels with the options of
    ``graph_params`` it takes (ref: GraphNet.py:256-277): GIN and EdgeConv
    around a ``_GraphMLP`` (``hoisted_net`` where the caller registers it),
    GMMConv with ``dim`` 2 and ``kernel_size`` ``kernel`` unless given,
    TransformerConv with ``edge_dim`` 2 unless given, GENConv with an edge
    projection ``edge_dim`` wide where the caller feeds edge features."""
    cls = GRAPH_CONV_BY_INDEX[index]
    if class_needs_nn(index):
        # as in the JAX package, no option reaches GIN or EdgeConv
        if hoisted_net is not None:
            return cls(hoisted_net, hoisted=True)
        mod = nn_input_modifier(index, 0, graph_params)
        return cls(_GraphMLP((mod * nin, nout), generator, device))
    params = _options(cls, graph_params)
    if index == 10:
        params.setdefault("dim", 2)
        params.setdefault("kernel_size", kernel)
    elif index == 5:
        params.setdefault("edge_dim", 2)
    elif index == 16:
        params["edge_dim"] = edge_dim
    return cls(nin, nout, generator=generator, device=device, **params)


def _cartesian(pos, edges, local: bool = False, norm: bool = True,
               max_value: Optional[float] = None):
    """Cartesian edge attributes on the device, as the JAX model computes
    them: target − source positions over every edge slot (padded ones
    point 0 → 0, rel 0), normalised by the largest |component| over all of
    them; ``local``: by each target's largest over its incoming slots,
    masked or not."""
    rel = pos[edges[1]] - pos[edges[0]]
    if local:
        amax = rel.abs().amax(dim=1)
        per_node = segment_max(amax[:, None], edges[1], pos.shape[0])[:, 0]
        scale = per_node[edges[1]].clamp(min=1e-9)[:, None]
        return rel / (2 * scale) + 0.5
    if norm:
        mv = max_value if max_value is not None else rel.abs().max().clamp(min=1e-9)
        return rel / (2 * mv) + 0.5
    return rel


def _graph_planes(feat_size, n_graph, n_expansion, expansion_factor, graph_out,
                  reduction_type: str) -> List[int]:
    """Plane schedule (ref: GraphNet.py:162-192)."""
    planes = [feat_size]
    n_contract = n_graph - n_expansion
    if reduction_type == "linear":
        if n_expansion > 0:
            exp = int((planes[0] * expansion_factor - planes[0]) / n_expansion)
            for _ in range(n_expansion):
                planes.append(planes[-1] + exp)
            if n_contract > 0:
                red = int((planes[-1] - graph_out) / n_contract)
                for _ in range(n_contract):
                    planes.append(planes[-1] - red)
        else:
            red = int((planes[0] - graph_out) / n_graph)
            for _ in range(n_graph):
                planes.append(planes[-1] - red)
    elif reduction_type == "geometric":
        if n_expansion > 0:
            exp = float(expansion_factor) ** (1.0 / n_expansion)
            for _ in range(n_expansion):
                planes.append(int(planes[-1] * exp))
            if n_contract > 0:
                red = float(graph_out / planes[-1]) ** (1.0 / n_contract)
                for _ in range(n_contract):
                    planes.append(int(planes[-1] * red))
        else:
            red = float(graph_out / planes[0]) ** (1.0 / n_graph)
            for _ in range(n_graph):
                planes.append(int(planes[-1] * red))
    else:
        raise IOError("net_config.hparams.reduction_type must be either linear or geometric")
    planes[-1] = int(graph_out)
    return planes


class _GraphModel(nn.Module):
    """A model over a prepared graph batch (a dict of device tensors)."""

    is_graph = True

    def plan_requirements(self) -> Set[str]:
        """No row-conv plan or site layout: the edges come from
        ``edge_requirements``."""
        return set()


@registry.register("GraphNet", aliases=("GraphNet.GraphNet",))
class GraphNet(_GraphModel):
    """Event classifier over a kNN pulse graph (ref: GraphNet.py:86-247):
    ``n_graph`` convs (``gconv_<i>``), each followed by masked BatchNorm
    (``norm_<i>``, under ``final_norm``) and ReLU, then with ``n_lin > 0``
    a per-event max pool over the real rows and a ``LinearBlock``
    (``linear``). Multi-head convs (indices 3, 4, 5, 17) concatenate their
    heads: the next conv's input, the norms and the head widen by
    ``heads``."""

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        hp = config.net_config.hparams
        feat_size = config.system_config.n_samples * 2
        if hasattr(hp, "n_graph"):
            self.n_graph = hp.n_graph
        elif hasattr(hp, "n_contract") and hasattr(hp, "n_expand"):
            self.n_graph = hp.n_contract + hp.n_expand
        else:
            raise IOError("if net_config.hparams.n_graph not specified, must "
                          "specify n_expand and n_contract")
        self.graph_index = hp.graph_class_index
        self.k = getattr(hp, "k", 6)
        self.graph_out = getattr(hp, "graph_out", 10)
        self.use_self_loops = bool(getattr(hp, "self_loop", False))
        self.final_norm = bool(getattr(hp, "final_norm", True))
        graph_params = to_dict(getattr(hp, "graph_params", {}) or {})
        self.local_cartesian = getattr(hp, "edge_transform", "cartesian") == "localcartesian"
        planes = _graph_planes(feat_size, self.n_graph, getattr(hp, "n_expand", 0),
                               getattr(hp, "expansion_factor", 1.0), self.graph_out,
                               getattr(hp, "reduction_type", "linear"))
        self.uses_edge_attr = needs_edge_attr(self.graph_index)
        heads = int(graph_params.get("heads", 1) or 1)
        hmul = heads if self.graph_index in (3, 4, 5, 17) else 1
        for i in range(self.n_graph):
            nin = planes[i] if i == 0 else planes[i] * hmul
            self.add_module(f"gconv_{i}", _make_conv(
                self.graph_index, nin, planes[i + 1], graph_params,
                edge_dim=2 if self.uses_edge_attr else None, generator=generator,
                device=device))
            if self.final_norm:
                self.add_module(f"norm_{i}", MaskedArrayBatchNorm(planes[i + 1] * hmul,
                                                                  device=device))
        self.n_lin = getattr(hp, "n_lin", 0)
        if self.n_lin > 0:
            sc = config.system_config
            lin_outputs = getattr(sc, "n_type", None) or getattr(config.net_config, "n_out",
                                                                 None)
            if lin_outputs is None:
                raise IOError("Need system_config.n_type or net_config.n_out")
            self.linear = LinearBlock(self.graph_out * hmul, lin_outputs, self.n_lin,
                                      generator, device)

    def edge_requirements(self) -> List[Tuple]:
        return [("knn", self.k, self.use_self_loops)]

    def forward(self, db: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = db["feats"]
        coords = db["coords"]
        node_mask = db["mask"]
        edges = db[f"edges_knn{self.k}"]
        edge_mask = db[f"edge_mask_knn{self.k}"]
        edge_attr = None
        if self.uses_edge_attr:
            edge_attr = _cartesian(coords[:, :2].to(x.dtype), edges, local=self.local_cartesian)
        for i in range(self.n_graph):
            x = getattr(self, f"gconv_{i}")(x, edges, edge_mask, edge_attr)
            if self.final_norm:
                x = getattr(self, f"norm_{i}")(x, node_mask)
            x = torch.relu(x)
        if self.n_lin > 0:
            pooled = global_max_pool(x, coords[:, 2], db["labels"].shape[0], node_mask)
            return self.linear(pooled)
        return x


@registry.register("GraphZ", aliases=("GraphBlocks.GraphZ",))
class GraphZ(_GraphModel):
    """Per-segment graph stack over window-edge neighbourhoods (ref:
    GraphBlocks.py:19-143): per-row features ``[N, out_planes]``. Layer i
    runs over the window edges of its neighbourhood (``edges_w<nb>``), or
    a pointwise layer over the ``knn1`` self edges; the convs that take
    edge weights get them from the relative positions. GIN's and
    EdgeConv's nets are ``_GraphMLP_<i>`` beside the convs, where flax
    puts them."""

    def __init__(self, in_planes: int, out_planes: int = 1, neighbors: int = 1,
                 kernel: int = 3, n_conv: int = 1, n_point: int = 3, conv_position: int = 3,
                 pointwise_factor: float = 0.8, batchnorm: bool = True,
                 self_loops: bool = True, graph_index: int = 0,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.neighbors = neighbors
        self.self_loops = self_loops
        self.graph_index = graph_index
        self.batchnorm = batchnorm
        self.sched = self.schedule(in_planes, out_planes, neighbors, n_conv, n_point,
                                   conv_position, pointwise_factor)
        attr_2d = self._uses_edge_weights() and self._edge_attr_2d()
        for i, (nin, nout, _) in enumerate(self.sched):
            net = None
            if class_needs_nn(graph_index):
                mod = nn_input_modifier(graph_index, 0, {})
                net = _GraphMLP((mod * nin, nout), generator, device)
                self.add_module(f"_GraphMLP_{i}", net)
            self.add_module(f"gconv_{i}", _make_conv(
                graph_index, nin, nout, {}, kernel=kernel, edge_dim=2 if attr_2d else None,
                hoisted_net=net, generator=generator, device=device))
            if i < len(self.sched) - 1 and batchnorm:
                self.add_module(f"norm_{i}", MaskedArrayBatchNorm(nout, device=device))

    @staticmethod
    def schedule(in_planes, out_planes, neighbors, n_conv, n_point, conv_position,
                 pointwise_factor):
        """Channel/neighbour schedule (ref: GraphBlocks.py:33-77): (in,
        out, neighbours) a layer, 0 neighbours for a pointwise layer."""
        n_layers = n_conv + n_point
        if n_conv > 0 and conv_position < 1:
            raise ValueError("conv position must be >= 1 if n_conv > 0")
        if n_point > 0:
            if n_layers == 1:
                raise ValueError("n_layers must be > 1 if using pointwise convolution")
            increment = int(round(int(round(in_planes * pointwise_factor - out_planes))
                                  / float(n_layers - 1)))
        else:
            increment = int(round(float(in_planes - out_planes) / float(n_layers)))
        conv_positions = (list(range(conv_position - 1, conv_position - 1 + n_conv))
                          if n_conv > 0 else [])
        out, inp = in_planes, in_planes
        layers = []
        for i in range(n_layers):
            if i == n_layers - 1:
                out = out_planes
            else:
                out -= increment
                if i == 0 and n_point > 0 and pointwise_factor > 0:
                    out = int(round(pointwise_factor * in_planes))
            if i in conv_positions:
                curr_neighbors = max(1, neighbors - int(i + 1 - conv_position))
            else:
                curr_neighbors = 0
            layers.append((inp, out, curr_neighbors))
            inp = out
        return layers

    def edge_requirements(self) -> List[Tuple]:
        return [("knn", 1, True) if nb == 0 else ("window", nb, self.self_loops)
                for (_, _, nb) in self.sched]

    def _uses_edge_weights(self) -> bool:
        return self.graph_index in (0, 2, 5, 6, 8, 9, 10, 14)

    def _edge_attr_2d(self) -> bool:
        # index 3 (GAT) is in the reference's 2-D list but not among the
        # convs given weights, as in the JAX model (GraphBlocks.py:79-107)
        return self.graph_index in (3, 5, 10)

    def forward(self, db: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = db["feats"]
        node_mask = db["mask"]
        pos = db["coords"][:, :2].to(x.dtype)
        # layers that share an edge set share its weights
        attr_cache: Dict[str, torch.Tensor] = {}
        for i, (_, _, nb) in enumerate(self.sched):
            key = "knn1" if nb == 0 else f"w{nb}"
            edges = db[f"edges_{key}"]
            edge_mask = db[f"edge_mask_{key}"]
            edge_attr = None
            if self._uses_edge_weights():
                if key not in attr_cache:
                    rel = _cartesian(pos, edges, norm=False)
                    if self._edge_attr_2d():
                        attr_cache[key] = 1.0 - rel.abs() / (self.neighbors + 1)
                    else:
                        attr_cache[key] = 1.0 - torch.sqrt((rel ** 2).sum(-1)) / (
                            (2 * self.neighbors ** 2) ** 0.5)
                edge_attr = attr_cache[key]
            x = getattr(self, f"gconv_{i}")(x, edges, edge_mask, edge_attr)
            if i < len(self.sched) - 1 and self.batchnorm:
                x = getattr(self, f"norm_{i}")(x, node_mask)
        return x


@registry.register("GraphZNet", aliases=("GraphNet.GraphZNet",))
class GraphZNet(_GraphModel):
    """Per-segment Z regressor: ``GraphZ`` (``model``) to one plane a row,
    scattered to the dense ``[B, 1, NX, NY]`` grid (two rows at one site
    summed)."""

    out_planes = 1

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.model = GraphZ(config.system_config.n_samples * 2, out_planes=self.out_planes,
                            generator=generator, device=device,
                            **_options(GraphZ, to_dict(config.net_config.hparams)))

    def edge_requirements(self) -> List[Tuple]:
        return self.model.edge_requirements()

    def forward(self, db: Dict[str, torch.Tensor]) -> torch.Tensor:
        out = self.model(db)
        coords = db["coords"].long()
        mask = db["mask"]
        n_events = db["labels"].shape[0]
        size = n_events * NX * NY
        idx = coords[:, 2] * (NX * NY) + coords[:, 0] * NY + coords[:, 1]
        # padding rows land on one extra row, which is dropped
        idx = torch.where(mask, idx, size)
        flat = out.new_zeros((size + 1, out.shape[-1]))
        flat = flat.index_add(0, idx, torch.where(mask[:, None], out, 0))
        return flat[:size].reshape(n_events, NX, NY, -1).permute(0, 3, 1, 2)


@registry.register("SingleEndedEZGraph", aliases=("GraphNet.SingleEndedEZGraph",))
class SingleEndedEZGraph(GraphZNet):
    """(E, Z) graph head: ``GraphZ`` to two planes, dense ``[B, 2, NX, NY]``
    (ref: GraphNet.py:597-621)."""

    out_planes = 2


class PointNetConv(nn.Module):
    """max_j mlp([x_j ‖ p_j − p_i]) over the incoming live edges
    (``LinearPlanes_0``, ReLU after every layer)."""

    def __init__(self, planes: Sequence[int], generator=None, device=None):
        super().__init__()
        self.LinearPlanes_0 = LinearPlanes(planes, activation=torch.relu,
                                           generator=generator, device=device)

    def forward(self, x, pos, edges, edge_mask):
        src, dst = edges[0], edges[1]
        z = torch.cat([x[src], pos[src] - pos[dst]], dim=-1)
        return segment_max(self.LinearPlanes_0(z), dst, x.shape[0], edge_mask)


def _head_outputs(config) -> int:
    return getattr(config.system_config, "n_type", 2)


@registry.register("PointNet", aliases=("GraphNet.PointNet",))
class PointNet(_GraphModel):
    """PointNet-style classifier over the pulse point cloud (ref:
    GraphNet.py:318-445): ``PointNetConv``s (``pconv_<i>``) over the kNN
    graph, a per-event max pool and a ``LinearBlock``."""

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        hp = config.net_config.hparams
        self.k = getattr(hp, "k", 6)
        feat = config.system_config.n_samples * 2
        self.n_graph = getattr(hp, "n_graph", 3)
        graph_out = getattr(hp, "graph_out", 32)
        planes = _graph_planes(feat, self.n_graph, getattr(hp, "n_expand", 0),
                               getattr(hp, "expansion_factor", 1.0), graph_out,
                               getattr(hp, "reduction_type", "linear"))
        for i in range(self.n_graph):
            self.add_module(f"pconv_{i}", PointNetConv((planes[i] + 2, planes[i + 1]),
                                                       generator, device))
        self.linear = LinearBlock(graph_out, _head_outputs(config), getattr(hp, "n_lin", 2),
                                  generator, device)

    def edge_requirements(self) -> List[Tuple]:
        return [("knn", self.k, False)]

    def forward(self, db: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = db["feats"]
        coords = db["coords"]
        pos = coords[:, :2].to(x.dtype)
        edges = db[f"edges_knn{self.k}"]
        edge_mask = db[f"edge_mask_knn{self.k}"]
        for i in range(self.n_graph):
            x = getattr(self, f"pconv_{i}")(x, pos, edges, edge_mask)
        pooled = global_max_pool(x, coords[:, 2], db["labels"].shape[0], db["mask"])
        return self.linear(pooled)


@registry.register("Graph3DNet", aliases=("GraphNet.Graph3DNet",))
class Graph3DNet(_GraphModel):
    """3D-point variant (ref: GraphNet.py:448-594): each row's waveform
    cut into ``n_windows`` fixed windows (the last zero-padded), each a
    point at (x, y, window); the 2D kNN edges lifted onto window 0 plus
    both directions of each row's window chain; ``PointNetConv``s, a max
    pool over the windows with any signal, a ``LinearBlock``."""

    n_windows = 8

    def __init__(self, config: Any, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        hp = config.net_config.hparams
        self.k = getattr(hp, "k", 6)
        n_samples = config.system_config.n_samples
        self.window = max(1, -((-2 * n_samples) // self.n_windows))
        self.n_graph = getattr(hp, "n_graph", 3)
        graph_out = getattr(hp, "graph_out", 16)
        planes = _graph_planes(self.window, self.n_graph, getattr(hp, "n_expand", 0),
                               getattr(hp, "expansion_factor", 1.0), graph_out,
                               getattr(hp, "reduction_type", "linear"))
        for i in range(self.n_graph):
            self.add_module(f"pconv_{i}", PointNetConv((planes[i] + 3, planes[i + 1]),
                                                       generator, device))
        self.linear = LinearBlock(graph_out, _head_outputs(config), getattr(hp, "n_lin", 2),
                                  generator, device)

    def edge_requirements(self) -> List[Tuple]:
        return [("knn", self.k, False)]

    def forward(self, db: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = db["feats"]
        coords = db["coords"]
        n = x.shape[0]
        W, L = self.n_windows, self.window
        if W * L > x.shape[1]:
            x = torch.nn.functional.pad(x, (0, W * L - x.shape[1]))
        feats3d = x[:, :W * L].reshape(n * W, L)
        t = torch.arange(W, dtype=x.dtype, device=x.device).repeat(n)
        pos3 = torch.cat([coords[:, :2].to(x.dtype).repeat_interleave(W, dim=0), t[:, None]],
                         dim=1)
        batch3 = coords[:, 2].repeat_interleave(W)
        mask3 = db["mask"].repeat_interleave(W) & (feats3d.abs().sum(-1) > 0)
        edges2 = db[f"edges_knn{self.k}"]
        chain_src = torch.arange(n * W - 1, dtype=edges2.dtype, device=x.device)
        chain_ok = (chain_src % W) != (W - 1)
        edges = torch.cat([edges2 * W, torch.stack([chain_src, chain_src + 1]),
                           torch.stack([chain_src + 1, chain_src])], dim=1)
        edge_mask = torch.cat([db[f"edge_mask_knn{self.k}"], chain_ok, chain_ok])
        h = feats3d
        for i in range(self.n_graph):
            h = getattr(self, f"pconv_{i}")(h, pos3, edges, edge_mask)
        pooled = global_max_pool(h, batch3, db["labels"].shape[0], mask3)
        return self.linear(pooled)


class DynamicEdgeConv(nn.Module):
    """EdgeConv over the kNN graph rebuilt in the forward from ``x``
    (``feature_knn``; ref: GraphNet.py:24-32), convolving ``feat``; its net
    is ``_GraphMLP_0`` ([2·in] → out), where flax keeps it."""

    def __init__(self, in_channels: int, out_channels: int, k: int = 6, generator=None,
                 device=None):
        super().__init__()
        self.k = k
        self._GraphMLP_0 = _GraphMLP((2 * in_channels, out_channels), generator, device)

    def forward(self, feat, x, batch, node_mask):
        edges, edge_mask = feature_knn(x, batch, node_mask, self.k)
        return edge_conv(self._GraphMLP_0, feat, edges, edge_mask)


class DynamicGraphConv(nn.Module):
    """GCNConv (``GCNConv_0``) over the kNN graph rebuilt in the forward
    from ``x`` (ref: GraphNet.py:34-41)."""

    def __init__(self, in_channels: int, out_channels: int, k: int = 6, generator=None,
                 device=None):
        super().__init__()
        self.k = k
        self.GCNConv_0 = GCNConv(in_channels, out_channels, generator=generator, device=device)

    def forward(self, feat, x, batch, node_mask):
        edges, edge_mask = feature_knn(x, batch, node_mask, self.k)
        return self.GCNConv_0(feat, edges, edge_mask)
