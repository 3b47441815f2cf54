"""Frozen-model batched inference (counterpart of
waveformml_tpu/inference/model.py).

``InferenceModel`` pads each ragged chunk of events to a row bucket and an
event bucket, builds the model's plans on the host, copies the batch to the
device and runs the eval forward. ``dispatch`` returns without waiting for
the device, so the host can prepare the next chunk while the card runs
this one; ``fetch`` waits, copies back and strips the padding.
``dispatch_phases`` sums the host-clock seconds of each phase over calls.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from waveformml_tpu_torch.datasets.hdf5_dataset import FileBlock
from waveformml_tpu_torch.device import resolve_device
from waveformml_tpu_torch.registry import retrieve_class

Handle = Tuple[torch.Tensor, int]


class InferenceModel:
    """A task's model with frozen weights, serving chunks of events.

    ``state_dict_or_path`` is a ``state_dict`` (e.g. from
    ``convert.flax_to_state_dict``) or the path of one saved with
    ``torch.save``. ``device=None`` means the card; pass ``device="cpu"`` to
    run the plain PyTorch versions of the kernels on the CPU.
    """

    def __init__(self, config, state_dict_or_path: Union[str, os.PathLike,
                                                         Dict[str, torch.Tensor]],
                 device: Optional[Union[str, torch.device]] = None):
        self.config = config
        self.device = resolve_device(device)
        self.task = retrieve_class(config.run_config.run_class)(config, self.device)
        state = state_dict_or_path
        if isinstance(state, (str, os.PathLike)):
            state = torch.load(state, map_location=self.device, weights_only=True)
        self.task.model.load_state_dict(state)
        self.task.model.eval()
        # host prep (pad + plans), host->device copy (synchronous for
        # pageable numpy memory), forward launch, and fetch (device wait +
        # device->host copy), summed over calls
        self.dispatch_phases = {"host_prep_s": 0.0, "h2d_s": 0.0,
                                "launch_s": 0.0, "fetch_s": 0.0}

    def dispatch(self, coords: np.ndarray, vals: np.ndarray) -> Handle:
        """Pad, build plans, copy and launch the forward of one chunk
        (coords [N, 3] with event ids 0..B-1, vals [N, F]) without waiting
        for the device; returns a handle for ``fetch``."""
        n = coords.shape[0]
        n_events = int(coords[:, -1].max()) + 1 if n else 0
        vals = np.asarray(vals, dtype=np.float32)
        t0 = time.perf_counter()
        block = FileBlock(coords=np.asarray(coords, dtype=np.int32), feats=vals,
                          labels=np.zeros((max(1, n_events),), np.int64))
        db = self.task.prepare_block(block, self.task.row_bucket(block),
                                     self.task.event_bucket(block))
        t1 = time.perf_counter()
        dev = self.task.to_device(db)
        t2 = time.perf_counter()
        out = self.task.apply_model(dev)
        t3 = time.perf_counter()
        self.dispatch_phases["host_prep_s"] += t1 - t0
        self.dispatch_phases["h2d_s"] += t2 - t1
        self.dispatch_phases["launch_s"] += t3 - t2
        return out, n_events

    def fetch(self, handle: Handle) -> np.ndarray:
        """Wait for a dispatched chunk and return its per-event outputs
        without the padding events."""
        out, n_events = handle
        t0 = time.perf_counter()
        result = out[:n_events].cpu().numpy()
        self.dispatch_phases["fetch_s"] += time.perf_counter() - t0
        return result

    def __call__(self, coords: np.ndarray, vals: np.ndarray) -> np.ndarray:
        """Ragged chunk → per-event model outputs [B, n_type] (synchronous)."""
        return self.fetch(self.dispatch(coords, vals))
