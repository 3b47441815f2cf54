"""HDF5 access for the port's datasets. h5py is imported inside these
functions only, so ``import waveformml_tpu_torch`` works on machines
without it; only reading or writing HDF5 files needs it."""
from __future__ import annotations

from typing import Any


def open_h5(path: str, mode: str = "r", **kwargs):
    """``h5py.File(path, mode)``; an ``OSError`` is raised again with the
    path and mode (as waveformml_tpu/io/hdf5.py's ``H5FileHandler``)."""
    import h5py

    try:
        return h5py.File(path, mode, **kwargs)
    except OSError as e:
        raise OSError(f"failed to open HDF5 file '{path}' (mode={mode}): {e}") from e


def is_group(node: Any) -> bool:
    """Whether an HDF5 node is a group (of datasets) and not a dataset."""
    import h5py

    return isinstance(node, h5py.Group)


def available() -> bool:
    """Whether h5py is installed, found without importing it."""
    import importlib.util

    return importlib.util.find_spec("h5py") is not None
