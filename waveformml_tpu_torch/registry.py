"""Class registry: config class-name strings → the port's classes.

The port's own copy of ``Registry`` of waveformml_tpu/registry.py. Names
resolve as there: the exact key, then its trailing dotted components
("src.engineering.LitPSD" → "LitPSD"), then any key ending in the name.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, Optional, Sequence


class Registry:
    def __init__(self) -> None:
        self._by_name: Dict[str, Any] = {}

    def register(self, name: str, aliases: Sequence[str] = ()):
        """Class decorator: register under ``name`` and its aliases."""

        def _do(obj: Any) -> Any:
            for n in (name, *aliases):
                self._by_name[n] = obj
            return obj

        return _do

    def lookup(self, name: str) -> Optional[Any]:
        if name in self._by_name:
            return self._by_name[name]
        parts = name.split(".")
        for i in range(1, len(parts)):
            suffix = ".".join(parts[i:])
            if suffix in self._by_name:
                return self._by_name[suffix]
        for key, obj in self._by_name.items():
            if key.endswith("." + name):
                return obj
        return None

    def retrieve_class(self, name: str) -> Any:
        obj = self.lookup(name)
        if obj is None:
            raise KeyError(f"no registered class for '{name}' "
                           f"(known: {sorted(self._by_name)})")
        return obj


registry = Registry()


def retrieve_class(name: str) -> Any:
    """Resolve a config class name after importing the modules whose import
    registers the port's classes (models, the grid ops' spconv names,
    tasks, criteria, optimizers, schedulers, datasets and data modules)."""
    for mod in ("waveformml_tpu_torch.models.nets",
                "waveformml_tpu_torch.ops.sparse_conv",
                "waveformml_tpu_torch.engineering.tasks",
                "waveformml_tpu_torch.nn.functional",
                "waveformml_tpu_torch.optim",
                "waveformml_tpu_torch.datasets.pulse_dataset",
                "waveformml_tpu_torch.datasets.data_module"):
        importlib.import_module(mod)
    return registry.retrieve_class(name)
