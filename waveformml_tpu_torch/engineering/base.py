"""Task base: owns the model and turns ragged blocks into padded batches
(counterpart of waveformml_tpu/engineering/base.py).

``prepare_block`` runs on the host with numpy: it pads a ``FileBlock`` to a
row bucket and an event bucket and builds every plan the model reads
(``model.plan_requirements()``): the ``[N, K²]`` neighbour plans and the
``[S, MAX]`` site layout. ``sparse_batch`` turns such a dict, once on the
device, into the model's ``SparseBatch``.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.device import resolve_device
from waveformml_tpu_torch.ops.row_conv import host_neighbor_plan
from waveformml_tpu_torch.ops.site_head import MIN_CAP, host_site_layout
from waveformml_tpu_torch.ops.sparse import SparseBatch, bucket_size, pad_sparse
from waveformml_tpu_torch.registry import retrieve_class


class TaskBase:
    """Owns the model (an ``nn.Module`` on ``device``) and the host-side
    batch preparation."""

    _EVENT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
                      16384, 32768)

    def __init__(self, config, device: Optional[Union[str, torch.device]] = None):
        self.config = config
        self.device = resolve_device(device)
        if getattr(config.system_config, "half_precision", 0):
            raise NotImplementedError("half_precision (bf16) is not ported yet")
        self.occlude_index = getattr(config.dataset_config, "occlude_index", None)
        self.model = retrieve_class(config.net_config.net_class)(config).to(self.device)
        # grow-only per-site capacity of the head's slot layout, so that its
        # [S, MAX] shape does not flap between buckets from batch to batch
        self._site_cap = 0

    # -- host-side batch preparation -------------------------------------------
    def row_bucket(self, block: FileBlock) -> int:
        return bucket_size(max(1, block.coords.shape[0]))

    def event_bucket(self, block: FileBlock) -> int:
        n = 1
        if block.coords.ndim == 2 and block.coords.shape[0]:
            n = int(block.coords[:, -1].max()) + 1
        # trailing events can have no rows: the label vector sets the floor
        n = max(n, block.labels.shape[0])
        return bucket_size(max(1, n), buckets=self._EVENT_BUCKETS)

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
        self.add_row_plans(out, event_bucket)
        return out

    def add_row_plans(self, out: Dict[str, np.ndarray], n_events: int) -> None:
        """Host-build the plans the model requires (they depend on coords
        only): ``plan_k<K>`` per conv window and ``plan_site_*``."""
        for req in sorted(self.model.plan_requirements()):
            if req == "site":
                lay = host_site_layout(out["coords"], out["mask"],
                                       min_cap=max(MIN_CAP, self._site_cap))
                self._site_cap = max(self._site_cap, lay["site_take"].shape[1])
                for k, v in lay.items():
                    out[f"plan_{k}"] = v
            else:
                out[f"plan_{req}"] = host_neighbor_plan(
                    out["coords"], out["mask"], n_events, int(req[1:]))

    # -- device-side ----------------------------------------------------------
    def to_device(self, db: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in db.items()}

    def sparse_batch(self, db: Dict[str, torch.Tensor]) -> SparseBatch:
        plans = {k[len("plan_"):]: v for k, v in db.items() if k.startswith("plan_")}
        return SparseBatch(db["coords"], self._features(db), db["mask"],
                           n_events=db["labels"].shape[0], plans=plans)

    def _features(self, db: Dict[str, torch.Tensor]) -> torch.Tensor:
        f = db["feats"]
        if self.occlude_index is not None:
            f = f.clone()
            f[:, self.occlude_index] = 0
        return f

    @torch.no_grad()
    def apply_model(self, db: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Eval forward of the model over a device batch, in float32."""
        self.model.eval()
        return self.model(self.sparse_batch(db)).float()
