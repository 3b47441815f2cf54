"""Class registry: config class-name strings → the port's classes.

The port's own copy of ``Registry`` of waveformml_tpu/registry.py. Names
resolve as there: the exact key, then its trailing dotted components
("src.engineering.LitPSD" → "LitPSD"), then any key ending in the name.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, List, Optional, Sequence


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

    def create_class_instances(self, spec: List[Any],
                               translations: Optional[Dict[str, Callable]] = None
                               ) -> List[Any]:
        """A layer list from the config ``algorithm`` DSL: class-name
        strings, each followed by its positional arguments (a list), its
        keyword arguments (a dict or a ``Config``) or nothing (a class
        built with no arguments). ``translations`` maps a class name to the
        factory used in its place, before the registry is asked."""
        instances: List[Any] = []
        current: Optional[Callable] = None
        for item in spec:
            if isinstance(item, str):
                if current is not None:
                    instances.append(current())
                current = (translations or {}).get(item) or self.retrieve_class(item)
            elif isinstance(item, (list, tuple)):
                if current is None:
                    raise ValueError(f"algorithm DSL: args {item} with no preceding class")
                instances.append(current(*item))
                current = None
            elif isinstance(item, dict) or hasattr(item, "to_dict"):
                if current is None:
                    raise ValueError("algorithm DSL: kwargs with no preceding class")
                instances.append(current(**(item.to_dict() if hasattr(item, "to_dict")
                                            else item)))
                current = None
            else:
                raise ValueError(f"algorithm DSL: unexpected entry {item!r}")
        if current is not None:
            instances.append(current())
        return instances


registry = Registry()


def retrieve_class(name: str) -> Any:
    """Resolve a config class name after importing the modules whose import
    registers the port's classes (models, graph models, the grid ops' spconv names,
    tasks, criteria, optimizers, schedulers, datasets and data modules, the
    algorithm DSL's layers)."""
    for mod in ("waveformml_tpu_torch.models.nets",
                "waveformml_tpu_torch.models.waveform_models",
                "waveformml_tpu_torch.models.graph_net",
                "waveformml_tpu_torch.models.algorithm",
                "waveformml_tpu_torch.nn.layers",
                "waveformml_tpu_torch.ops.sparse_conv",
                "waveformml_tpu_torch.engineering.tasks",
                "waveformml_tpu_torch.nn.functional",
                "waveformml_tpu_torch.optim",
                "waveformml_tpu_torch.datasets.pulse_dataset",
                "waveformml_tpu_torch.datasets.data_module",
                "waveformml_tpu_torch.datasets.graph_dataset"):
        importlib.import_module(mod)
    return registry.retrieve_class(name)
