"""Task base: owns the model and turns ragged blocks into padded batches
(counterpart of waveformml_tpu/engineering/base.py).

``prepare_block`` runs on the host with numpy: it pads a ``FileBlock`` to a
row bucket and an event bucket and builds every plan the model reads
(``model.plan_requirements()``): the ``[N, K²]`` neighbour plans and the
``[S, MAX]`` site layout, and a graph model's padded edge lists
(``add_graph_edges``). ``sparse_batch`` turns such a dict, once on the
device, into the model's ``SparseBatch``. ``to_device`` ships such a dict
to the card as one packed copy (``pack_db``, ``unpack_db``), each array in
its own dtype: float16 features (``half_precision``'s datasets) ship as
they are, half the bytes of float32.

``half_precision`` (the config's ``system_config``) is the JAX package's
mixed precision: ``_features`` casts the features to bf16 on the device,
the parameters stay float32, the first conv rounds its product to bf16
before its float32 bias (``ops.row_conv.SubMConvRows``), and everything
after it runs in float32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.device import resolve_device
from waveformml_tpu_torch.engineering.se_mask import se_loss_mask
from waveformml_tpu_torch.nn.functional import build_criterion
from waveformml_tpu_torch.ops.graph import knn_graph, pad_edges, window_edges
from waveformml_tpu_torch.ops.row_conv import host_neighbor_plan
from waveformml_tpu_torch.ops.site_head import MIN_CAP, host_site_layout
from waveformml_tpu_torch.ops.sparse import (SparseBatch, bucket_size, occupancy_mask,
                                             pad_sparse, scatter_to_dense)
from waveformml_tpu_torch.registry import retrieve_class
from waveformml_tpu_torch.utils import tracing

#: a packed batch's layout: (key, shape, numpy dtype string, byte offset,
#: bytes) per leaf, sorted by key
PackSpec = Tuple[Tuple[str, Tuple[int, ...], str, int, int], ...]
#: leaves start at multiples of this many bytes, so that each one's bytes
#: view as its dtype (``Tensor.view(dtype)`` needs an offset that is a
#: multiple of the element size)
PACK_ALIGN = 16


def pack_db(db: Dict[str, np.ndarray], pin_memory: bool = False
            ) -> Tuple[torch.Tensor, PackSpec]:
    """Every leaf of a prepared batch in ONE uint8 host tensor (pinned with
    ``pin_memory``, from PyTorch's pinned allocator, which holds a block
    until the copies out of it have finished), each leaf at a multiple of
    ``PACK_ALIGN`` bytes in its own native-endian dtype (int64 labels stay
    int64); returns the buffer and its layout."""
    leaves, spec, off = [], [], 0
    for k in sorted(db):
        v = np.asarray(db[k])
        shape = tuple(v.shape)  # before ascontiguousarray, which makes 0-d 1-d
        if v.dtype.byteorder not in ("=", "|"):
            v = v.astype(v.dtype.newbyteorder("="))
        v = np.ascontiguousarray(v)
        off = -(-off // PACK_ALIGN) * PACK_ALIGN
        spec.append((k, shape, v.dtype.str, off, v.nbytes))
        leaves.append(v)
        off += v.nbytes
    buf = torch.empty(max(off, 1), dtype=torch.uint8, pin_memory=pin_memory)
    host = buf.numpy()
    for v, (_, _, _, o, nb) in zip(leaves, spec):
        host[o:o + nb] = v.reshape(-1).view(np.uint8)
    return buf, tuple(spec)


def unpack_db(buf: torch.Tensor, spec: PackSpec) -> Dict[str, torch.Tensor]:
    """The leaves of a packed batch as views of ``buf`` (on any device)."""
    out = {}
    for k, shape, dt, off, nb in spec:
        dtype = torch.from_numpy(np.empty(0, np.dtype(dt))).dtype
        out[k] = buf[off:off + nb].view(dtype).view(shape)
    return out


class TaskBase:
    """Owns the model (an ``nn.Module`` on ``device``), its criterion and
    the host-side batch preparation.

    ``net_config.SELoss`` restricts the losses to the single-ended segments
    (``se_mask``); ``net_config.z_weights`` with ``z_config`` gives the
    model a frozen Z model (``_build_frozen_z``)."""

    _EVENT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
                      16384, 32768)
    #: labels padded alongside the rows (``labels_rows``), not the events
    labels_per_row = False
    #: the model's outputs are per "event" or per "row" (InferenceModel
    #: un-pads by it where the two buckets are equal)
    output_unit = "event"
    #: the net of a config without ``net_config.net_class`` (None: the
    #: config must name one)
    default_net: Optional[str] = None

    def __init__(self, config, device: Optional[Union[str, torch.device]] = None,
                 trial=None):
        self.config = config
        #: the HPO trial this task trains for (``optimization.hpo.Trial``),
        #: which ``Trainer.trial_prune_check`` reports to; None outside a study
        self.trial = trial
        self.device = resolve_device(device)
        self.half_precision = bool(getattr(config.system_config, "half_precision", 0))
        self.occlude_index = getattr(config.dataset_config, "occlude_index", None)
        self.SE_only = bool(getattr(config.net_config, "SELoss", False))
        self.se_mask = (torch.as_tensor(se_loss_mask(), device=self.device)
                        if self.SE_only else None)
        #: the random stream dropout draws from in train mode (the Trainer
        #: sets its own)
        self.generator: Optional[torch.Generator] = None
        name = getattr(config.net_config, "net_class", None) or self.default_net
        if name is None:
            raise AttributeError(f"{type(self).__name__} needs net_config.net_class")
        cls = retrieve_class(name)
        z_model = self._build_frozen_z()
        kwargs = {"z_model": z_model} if z_model is not None else {}
        self.model = cls(config, **kwargs).to(self.device)
        self.criterion = build_criterion(
            config.net_config.criterion_class,
            getattr(config.net_config, "criterion_params", None))
        #: the test pass's evaluator (``Trainer.test`` builds it)
        self.evaluator = None
        # grow-only per-site capacity of the head's slot layout, so that its
        # [S, MAX] shape does not flap between buckets from batch to batch
        self._site_cap = 0
        #: host-clock seconds spent building graph edges (``add_graph_edges``)
        self.edge_build_s = 0.0

    def _build_frozen_z(self) -> Optional[torch.nn.Module]:
        """Where ``net_config`` has ``z_weights`` (a port checkpoint or
        ``state_dict`` file of a Z model) and ``z_config`` (its config):
        that model, loaded through ``InferenceModel`` on this task's device,
        in eval mode, its parameters frozen; else None."""
        nc = self.config.net_config
        if not hasattr(nc, "z_weights"):
            return None
        if not hasattr(nc, "z_config"):
            raise ValueError("if specifying z_weights, you must also specify z_config")
        from waveformml_tpu_torch.config import load_config
        from waveformml_tpu_torch.inference.model import InferenceModel

        z_model = InferenceModel(load_config(nc.z_config), nc.z_weights,
                                 device=self.device).task.model
        z_model.requires_grad_(False)
        return z_model

    def make_evaluator(self, logger=None):
        """The task's test-pass evaluator (each task has its own)."""
        raise NotImplementedError(f"{type(self).__name__} has no evaluator")

    def _eval_params(self) -> Dict:
        """The config's ``evaluation_config`` as a dict ({} without one)."""
        from waveformml_tpu_torch.config import to_dict

        ec = getattr(self.config, "evaluation_config", None)
        return to_dict(ec) if ec is not None else {}

    # -- host-side batch preparation -------------------------------------------
    def row_bucket(self, block: FileBlock) -> int:
        return bucket_size(max(1, block.coords.shape[0]))

    def event_bucket(self, block: FileBlock) -> int:
        return bucket_size(max(1, self.n_events(block)), buckets=self._EVENT_BUCKETS)

    def n_events(self, block: FileBlock) -> int:
        """The events of a block: one past its largest event id, and for
        event labels at least their count (trailing events can have no
        rows)."""
        n = 1
        if block.coords.ndim == 2 and block.coords.shape[0]:
            n = int(block.coords[:, -1].max()) + 1
        if not self.labels_per_row:
            n = max(n, block.labels.shape[0])
        return n

    def prepare_block(self, block: FileBlock, row_bucket: int,
                      event_bucket: int) -> Dict[str, np.ndarray]:
        """FileBlock → padded numpy dict: coords, feats, mask, labels,
        label_mask and the model's ``plan_*`` arrays."""
        coords, feats, mask = pad_sparse(block.coords, block.feats, row_bucket)
        labels = block.labels
        n_ev = labels.shape[0]
        y = np.zeros((event_bucket,) + labels.shape[1:], dtype=labels.dtype)
        y[:n_ev] = labels
        ymask = np.zeros((event_bucket,), dtype=bool)
        ymask[:n_ev] = True
        out = {"coords": coords, "feats": feats, "mask": mask,
               "labels": y, "label_mask": ymask}
        self.add_row_extras(block, out, row_bucket)
        self.add_graph_edges(block, out)
        self.add_row_plans(out, event_bucket)
        return out

    @staticmethod
    def add_row_extras(block: FileBlock, out: Dict[str, np.ndarray], row_bucket: int) -> None:
        """The block's per-row extras, padded to the row bucket, as
        ``extra_<name>`` (edge lists excepted)."""
        for k, v in block.extras.items():
            if k.startswith(("edges_", "edge_mask_")):
                continue
            pad = np.zeros((row_bucket,) + v.shape[1:], dtype=v.dtype)
            pad[:v.shape[0]] = v
            out[f"extra_{k}"] = pad

    @property
    def is_graph(self) -> bool:
        """Whether the model is a graph model: it takes the whole prepared
        batch and its padded edge lists (``models.graph_net``)."""
        return getattr(type(self.model), "is_graph", False)

    def add_graph_edges(self, block: FileBlock, out: Dict[str, np.ndarray]) -> None:
        """A graph model's padded edge lists (``model.edge_requirements()``),
        built on the host by the C++ library of ``ops.graph``, each padded
        to the ``bucket_size`` of its edge count: ``edges_knn<k>`` and
        ``edges_w<d>`` with their ``edge_mask_*``. Where the block carries
        them already (a ``GraphDataset`` cache), its live edges are
        re-padded to this batch's bucket. Adds the build's host-clock
        seconds (span ``task.edge_build``) to ``edge_build_s``."""
        if not self.is_graph:
            return
        with tracing.span("task.edge_build") as built:
            coords = block.coords
            n = coords.shape[0]
            pos = coords[:, :2].astype(np.float64)
            batch_col = coords[:, -1].astype(np.int64)
            extras = block.extras or {}
            seen = set()
            for req in self.model.edge_requirements():
                key = f"knn{req[1]}" if req[0] == "knn" else f"w{req[1]}"
                if key in seen:
                    continue
                seen.add(key)
                cached = extras.get(f"edges_{key}")
                cached_mask = extras.get(f"edge_mask_{key}")
                if cached is not None and cached_mask is not None:
                    edges = np.asarray(cached)[:, np.asarray(cached_mask, dtype=bool)]
                elif n == 0:
                    edges = np.zeros((2, 0), np.int64)
                elif req[0] == "knn":
                    edges = knn_graph(pos, req[1], batch_col, loop=req[2])
                else:
                    edges = window_edges(coords[:, :2], batch_col, max_dist=req[1],
                                         self_loops=req[2])
                out[f"edges_{key}"], out[f"edge_mask_{key}"] = pad_edges(
                    edges, bucket_size(max(1, edges.shape[1])))
        self.edge_build_s += built.seconds

    def add_row_plans(self, out: Dict[str, np.ndarray], n_events: int) -> None:
        """Host-build the plans the model requires (they depend on coords
        only): ``plan_k<K>`` per conv window (``plan_k<K>t<T>`` per 3D one)
        and ``plan_site_*``."""
        for req in sorted(self.model.plan_requirements()):
            if req == "site":
                lay = host_site_layout(out["coords"], out["mask"],
                                       min_cap=max(MIN_CAP, self._site_cap))
                self._site_cap = max(self._site_cap, lay["site_take"].shape[1])
                for k, v in lay.items():
                    out[f"plan_{k}"] = v
            else:
                # "k<K>", or "k<K>t<T>" for a 3D window over T samples
                k, _, n_t = req[1:].partition("t")
                out[f"plan_{req}"] = host_neighbor_plan(
                    out["coords"], out["mask"], n_events, int(k), int(n_t) if n_t else None)

    # -- device-side ----------------------------------------------------------
    def to_device(self, db: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A prepared batch on the task's device. On the card: packed into
        one pinned buffer, copied with one asynchronous copy and viewed
        leaf by leaf; on the CPU, the arrays as tensors."""
        if self.device.type == "cpu":
            return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in db.items()}
        buf, spec = pack_db(db, pin_memory=True)
        return unpack_db(buf.to(self.device, non_blocking=True), spec)

    def sparse_batch(self, db: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None) -> SparseBatch:
        plans = {k[len("plan_"):]: v for k, v in db.items() if k.startswith("plan_")}
        return SparseBatch(db["coords"], self._features(db), db["mask"],
                           n_events=db["labels"].shape[0], plans=plans, generator=generator)

    def _features(self, db: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The batch's features as the model takes them: the occluded
        column zeroed, and cast to bf16 under ``half_precision``."""
        f = db["feats"]
        if self.occlude_index is not None:
            f = f.clone()
            f[:, self.occlude_index] = 0
        if self.half_precision:
            f = f.to(torch.bfloat16)
        return f

    def model_inputs(self, db: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A graph model's input: the whole device batch, its features as
        ``_features`` gives them."""
        out = dict(db)
        out["feats"] = self._features(db)
        return out

    def forward_model(self, db: Dict[str, torch.Tensor],
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The model over a device batch, in the mode it is in: the sparse
        nets take the batch's ``SparseBatch`` (``generator`` in it, for
        dropout in train mode), the graph models the batch itself
        (``model_inputs``)."""
        if self.is_graph:
            return self.model(self.model_inputs(db))
        return self.model(self.sparse_batch(db, generator))

    @torch.no_grad()
    def apply_model(self, db: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Eval forward of the model over a device batch, in float32."""
        self.model.eval()
        return self.forward_model(db).float()

    def model_outputs(self, db: Dict[str, torch.Tensor], train: bool) -> torch.Tensor:
        """Forward of the model over a device batch in train mode (batch
        statistics, running statistics updated) or eval mode, in float32,
        under autograd as the caller has it."""
        self.model.train(train)
        return self.forward_model(db, self.generator if train else None).float()

    # -- segment loss ---------------------------------------------------------
    def segment_loss(self, outputs_dense: torch.Tensor, db: Dict[str, torch.Tensor],
                     targets_rows: torch.Tensor, target_index: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """The criterion over the occupied sites of a dense ``[B, C, NX,
        NY]`` output against per-row targets (``[N]`` or ``[N, L]``,
        scattered to the grid, two rows at one site summed): (loss sum,
        weight, target grid ``[B, L, NX, NY]`` (column ``target_index``
        only, where given), predictions masked by the batch's occupancy).
        The weight is the count of occupied sites, under ``SE_only`` of
        the occupied single-ended ones, whose mask then also multiplies
        both sides of the criterion."""
        batch = SparseBatch(db["coords"], db["feats"], db["mask"],
                            n_events=db["labels"].shape[0])
        t = targets_rows[:, None] if targets_rows.dim() == 1 else targets_rows
        target_dense = scatter_to_dense(batch, t.float()).permute(0, 3, 1, 2)
        occf = occupancy_mask(batch)[:, None].to(outputs_dense.dtype)
        preds = outputs_dense * occf
        if target_index is not None:
            target_dense = target_dense[:, target_index:target_index + 1]
        if self.SE_only:
            m = self.se_mask.to(preds.dtype)[None, None]
            elem = self.criterion.elementwise(preds * m, target_dense * m)
            weight = (occf * m).sum()
        else:
            elem = self.criterion.elementwise(preds, target_dense)
            weight = occf.sum()
        return (elem * occf).sum(), weight, target_dense, preds
