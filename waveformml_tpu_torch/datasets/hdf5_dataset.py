"""Dataset items (counterpart of waveformml_tpu/datasets/hdf5_dataset.py).

Only ``FileBlock``, the unit that tasks pad into device batches, is here so
far; the HDF5 loaders and per-row extras are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FileBlock:
    """One dataset item: a multi-event block of pulse rows."""

    coords: np.ndarray                 # [N, 3] int32 (x, y, event)
    feats: np.ndarray                  # [N, F]
    labels: np.ndarray                 # [B] event labels
