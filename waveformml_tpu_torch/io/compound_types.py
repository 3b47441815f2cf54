"""HDF5 compound record types of the experiment's tables that the pulse
datasets and the prediction writers map to (the port's copy of those of
waveformml_tpu/io/compound_types.py): the field names, dtypes and lengths
are the on-disk contract."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class H5CompoundType:
    """A named numpy structured dtype (``type``) from ``FIELDS``: (name,
    dtype, length), length 1 a scalar field. ``event_index_name`` names the
    field that holds a record's event number, ``event_index_coord`` its
    column where that field is a vector."""

    NAME: str = "H5CompoundType"
    FIELDS: Sequence[Tuple[str, type, int]] = ()
    EVENT_INDEX_NAME: Optional[str] = None
    EVENT_INDEX_COORD: Optional[int] = None

    def __init__(self):
        self.name = self.NAME
        self.names = [f[0] for f in self.FIELDS]
        self.event_index_name = self.EVENT_INDEX_NAME
        self.event_index_coord = self.EVENT_INDEX_COORD
        self.type = np.dtype([(n, t, (l,)) if l > 1 else (n, t) for n, t, l in self.FIELDS])


class WaveformPairNorm(H5CompoundType):
    """Normalized waveform pair records."""

    NAME = "WaveformPairNorm"
    FIELDS = [("t", np.float64, 1), ("coord", np.int32, 3), ("pulse", np.float32, 130),
              ("phys", np.float32, 7), ("EZ", np.float32, 2), ("PID", np.int32, 1)]
    EVENT_INDEX_NAME = "coord"
    EVENT_INDEX_COORD = 2


class WaveformNorm(H5CompoundType):
    """Single-waveform normalized records."""

    NAME = "WaveformNorm"
    FIELDS = [("t", np.float64, 1), ("evt", np.int64, 1), ("det", np.int32, 1),
              ("pulse", np.float32, 130), ("phys", np.float32, 7), ("EZ", np.float32, 2),
              ("PID", np.int32, 1)]
    EVENT_INDEX_NAME = "evt"


class WaveformPairCal(H5CompoundType):
    """Calibrated raw ADC waveform pairs."""

    NAME = "WaveformPairCal"
    FIELDS = [("evt", np.int64, 1), ("t", np.float64, 1), ("dt", np.float32, 1),
              ("z", np.float32, 1), ("E", np.float32, 1), ("PSD", np.float32, 1),
              ("PE", np.float32, 2), ("coord", np.int32, 3), ("waveform", np.int16, 130),
              ("EZ", np.float32, 2), ("PID", np.int32, 1)]
    EVENT_INDEX_NAME = "coord"
    EVENT_INDEX_COORD = 2


class PhysPulse(H5CompoundType):
    """Physics-feature pulse records, with the single-ended (``*_SE``)
    fields."""

    NAME = "PhysPulse"
    FIELDS = [("evt", np.int64, 1), ("seg", np.int32, 1), ("E", np.float32, 1),
              ("rand", np.float32, 1), ("t", np.float64, 1), ("dt", np.float32, 1),
              ("PE", np.float32, 2), ("y", np.float32, 1), ("PSD", np.float32, 1),
              ("PID", np.int32, 1), ("E_SE", np.float32, 2), ("Esmear_SE", np.float32, 2),
              ("y_SE", np.float32, 1), ("PSD_SE", np.float32, 2)]
    EVENT_INDEX_NAME = "evt"


def extension_type_map(path: str) -> H5CompoundType:
    """The record type of a file, from its name's suffix: ``*WFNorm.h5``
    holds WaveformPairNorm, ``*Phys.h5`` PhysPulse, any other file
    WaveformPairCal."""
    if path.endswith("WFNorm.h5"):
        return WaveformPairNorm()
    if path.endswith("Phys.h5"):
        return PhysPulse()
    return WaveformPairCal()
