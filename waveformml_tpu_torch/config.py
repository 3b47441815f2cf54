"""JSON/YAML configs as nested attribute objects, and their validation.

The port's own copy of waveformml_tpu/config.py's ``Config``,
``load_config``, ``save_config``, ``to_dict`` and ``validate_config``,
with its own copy of the requirements template
(``config_requirements.json``), so that the two packages read the same
config files and fill the same defaults. Class names
in a config (the optimizer's, the scheduler's) resolve through the port's
registry.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Any, Dict, Optional


class Config:
    """Recursive attribute-access wrapper over a dict: ``config.section.key``
    and ``config["section"]["key"]`` both work, assignments wrap dicts, and
    ``to_dict`` inverts it."""

    def __init__(self, d: Optional[Dict[str, Any]] = None):
        if d:
            for k, v in d.items():
                setattr(self, str(k), v)

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def __setitem__(self, key: str, value: Any) -> None:
        setattr(self, key, value)

    def __setattr__(self, key: str, value: Any) -> None:
        object.__setattr__(self, key, _wrap(value))

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


def load_config(path: str, validate: bool = True) -> Config:
    """Load a JSON or YAML config file into a Config; with ``validate``,
    check it against the requirements template and fill its defaults."""
    p = find_config_path(path)
    with open(p) as f:
        if p.endswith((".yaml", ".yml")):
            import yaml  # optional dependency, needed only for YAML configs

            cfg = Config(yaml.safe_load(f))
        else:
            cfg = Config(json.load(f))
    if validate:
        validate_config(cfg)
    return cfg


def save_config(config: Any, path: str) -> None:
    """Write a Config (or dict) as indented JSON to ``path``, creating its
    directory."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(_unwrap(config), f, indent=2)


_REQUIREMENTS_FILE = os.path.join(os.path.dirname(__file__), "config_requirements.json")

#: a params dict whose template default belongs to the class named by its
#: sibling key
_SIBLING_CLASS = {"optimizer_params": "optimizer_class",
                  "scheduler_params": "scheduler_class"}


def validate_config(config: Config, requirements: Optional[Dict[str, Any]] = None) -> Config:
    """Check ``config`` against the requirements template
    (``config_requirements.json`` unless ``requirements`` is given) and fill
    in place the defaults of absent keys; raise ``ValueError`` on an absent
    key whose template value marks it required ("", 0, [""], [{}], {}).
    Template keys beginning with "_" are comments. A dict-valued default is
    atomic: filled whole where the key is absent, never merged into a
    present dict; an absent ``optimizer_params``/``scheduler_params`` gets
    the template's dict only where the config's class is the template's (as
    the port's registry resolves the names), else ``{}``."""
    if requirements is None:
        with open(_REQUIREMENTS_FILE) as f:
            requirements = json.load(f)

    def apply(node: Config, template: Dict[str, Any], path: str) -> None:
        for key, default in template.items():
            if key.startswith("_"):
                continue
            here = f"{path}/{key}" if path else key
            if isinstance(default, dict) and not path:
                if key not in node:
                    setattr(node, key, {})
                sub = getattr(node, key)
                if not isinstance(sub, Config):
                    raise ValueError(f"config key {here} must be a section (dict)")
                apply(sub, default, here)
            elif isinstance(default, dict):
                if key in node:
                    if not isinstance(getattr(node, key), Config):
                        raise ValueError(f"config key {here} must be a dict")
                    continue
                sibling = _SIBLING_CLASS.get(key)
                tmpl_cls = template.get(sibling) if sibling else None
                if sibling and not _same_class(getattr(node, sibling, tmpl_cls), tmpl_cls):
                    setattr(node, key, {})
                else:
                    setattr(node, key, copy.deepcopy(default))
            elif key not in node:
                if not _has_default(default):
                    raise ValueError(f"required config key missing: {here}")
                setattr(node, key, copy.deepcopy(default))

    apply(config, requirements, "")
    return config


def _same_class(a: Any, b: Any) -> bool:
    """Whether two class names resolve to one class in the port's registry
    ("SGD" and "optim.SGD" do); names it does not know compare as strings."""
    if a == b:
        return True
    if not (isinstance(a, str) and isinstance(b, str)):
        return False
    from waveformml_tpu_torch.registry import retrieve_class

    try:
        return retrieve_class(a) is retrieve_class(b)
    except KeyError:
        return False


def _has_default(v: Any) -> bool:
    """Whether a template value is a usable default: "", 0, [""], [{}] and
    {} mark required keys; a bare [] fills as an empty list."""
    if isinstance(v, str):
        return v != ""
    if isinstance(v, (bool, int, float)):
        return v != 0
    if isinstance(v, list):
        return len(v) == 0 or (v != [""] and v != [{}])
    if isinstance(v, dict):
        return len(v) > 0
    return True
