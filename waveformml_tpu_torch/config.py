"""JSON/YAML configs as nested attribute objects.

The port's own copy of waveformml_tpu/config.py's ``Config``,
``load_config`` and ``to_dict``, so that the two packages read the same
config files. Validation against ``config_requirements.json``
(``validate_config``) is not ported yet: readers use ``getattr`` defaults.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional


class Config:
    """Recursive attribute-access wrapper over a dict: ``config.section.key``
    and ``config["section"]["key"]`` both work, and ``to_dict`` inverts it."""

    def __init__(self, d: Optional[Dict[str, Any]] = None):
        if d:
            for k, v in d.items():
                setattr(self, str(k), _wrap(v))

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self.__dict__

    def get(self, key: str, default: Any = None) -> Any:
        return self.__dict__.get(key, default)

    def to_dict(self) -> Dict[str, Any]:
        return _unwrap(self)

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"


def _wrap(v: Any) -> Any:
    if isinstance(v, dict):
        return Config(v)
    if isinstance(v, (list, tuple)):
        return [_wrap(x) for x in v]
    return v


def _unwrap(v: Any) -> Any:
    if isinstance(v, Config):
        return {k: _unwrap(x) for k, x in v.__dict__.items()}
    if isinstance(v, (list, tuple)):
        return [_unwrap(x) for x in v]
    return v


def to_dict(obj: Any) -> Dict[str, Any]:
    """Config → dict."""
    return _unwrap(obj)


def find_config_path(name: str) -> str:
    """Resolve a config name: the path itself, ./config/<name>, then the
    working directory, each with and without .json/.yaml/.yml."""
    candidates = [os.path.join(d, name) for d in
                  (os.path.join(os.getcwd(), "config"), os.getcwd())]
    if os.path.isabs(name) or os.path.exists(name):
        candidates.insert(0, name)
    for c in candidates:
        for e in ("", ".json", ".yaml", ".yml"):
            if os.path.isfile(c + e):
                return c + e
    raise FileNotFoundError(f"config '{name}' not found (searched {candidates})")


def load_config(path: str) -> Config:
    """Load a JSON or YAML config file into a Config."""
    p = find_config_path(path)
    with open(p) as f:
        if p.endswith((".yaml", ".yml")):
            import yaml  # optional dependency, needed only for YAML configs

            return Config(yaml.safe_load(f))
        return Config(json.load(f))
