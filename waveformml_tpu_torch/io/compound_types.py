"""HDF5 compound record types of the experiment's tables that the pulse
datasets map to (the port's copy of those of
waveformml_tpu/io/compound_types.py): the field names, dtypes and lengths
are the on-disk contract."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


class H5CompoundType:
    """A named numpy structured dtype (``type``) from ``FIELDS``: (name,
    dtype, length), length 1 a scalar field."""

    NAME: str = "H5CompoundType"
    FIELDS: Sequence[Tuple[str, type, int]] = ()

    def __init__(self):
        self.name = self.NAME
        self.names = [f[0] for f in self.FIELDS]
        self.type = np.dtype([(n, t, (l,)) if l > 1 else (n, t) for n, t, l in self.FIELDS])


class WaveformPairNorm(H5CompoundType):
    """Normalized waveform pair records."""

    NAME = "WaveformPairNorm"
    FIELDS = [("t", np.float64, 1), ("coord", np.int32, 3), ("pulse", np.float32, 130),
              ("phys", np.float32, 7), ("EZ", np.float32, 2), ("PID", np.int32, 1)]


class WaveformNorm(H5CompoundType):
    """Single-waveform normalized records."""

    NAME = "WaveformNorm"
    FIELDS = [("t", np.float64, 1), ("evt", np.int64, 1), ("det", np.int32, 1),
              ("pulse", np.float32, 130), ("phys", np.float32, 7), ("EZ", np.float32, 2),
              ("PID", np.int32, 1)]


class WaveformPairCal(H5CompoundType):
    """Calibrated raw ADC waveform pairs."""

    NAME = "WaveformPairCal"
    FIELDS = [("evt", np.int64, 1), ("t", np.float64, 1), ("dt", np.float32, 1),
              ("z", np.float32, 1), ("E", np.float32, 1), ("PSD", np.float32, 1),
              ("PE", np.float32, 2), ("coord", np.int32, 3), ("waveform", np.int16, 130),
              ("EZ", np.float32, 2), ("PID", np.int32, 1)]
