"""What a run of the benchmark may not load: the JAX package the port was
made from, or JAX and the libraries around it. Names are compared whole, by
the top-level part of each module's name (before the first dot), so that
``waveformml_tpu_torch``, the port, is not taken for ``waveformml_tpu``.

``check_modules`` fails a run whose process has loaded one of them;
``reference_imports`` lists what the plain references import, so that a
run fails where they import the program or the JAX package.
"""
from __future__ import annotations

import ast
import os
import sys
from typing import Iterable, List, Set

BANNED = ("jax", "jaxlib", "flax", "orbax", "waveformml_tpu")
#: what a plain reference may not import besides BANNED: the program
PROGRAM = "waveformml_tpu_torch"


class GuardError(RuntimeError):
    """A banned module is loaded, or a reference imports the program."""


def top_level(names: Iterable[str]) -> Set[str]:
    return {n.split(".", 1)[0] for n in names}


def banned_loaded(modules: Iterable[str] = None) -> List[str]:
    """The banned top-level names among ``modules`` (``sys.modules``)."""
    names = top_level(sys.modules if modules is None else modules)
    return sorted(names & set(BANNED))


def check_modules(where: str) -> None:
    """Raise ``GuardError`` naming what is loaded, if anything banned is."""
    bad = banned_loaded()
    if bad:
        raise GuardError(f"{where}: the process has loaded {', '.join(bad)}; the benchmark "
                         f"measures the port alone")


def file_imports(path: str) -> Set[str]:
    """The modules a Python file imports, as written (relative imports
    resolved against the ``portbench`` package where they are inside it)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    package = os.path.relpath(os.path.dirname(path),
                              os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    package = package.replace(os.sep, ".")
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package.split(".")[:len(package.split(".")) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            out.add(mod)
            out.update(f"{mod}.{a.name}" for a in node.names)
    return out


def reference_imports(reference_dir: str) -> List[str]:
    """What the files under ``reference_dir`` import of the program or of
    ``BANNED``, followed through the benchmark's own modules they import
    (``[]`` when they import neither)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    todo = [os.path.join(reference_dir, f) for f in sorted(os.listdir(reference_dir))
            if f.endswith(".py")]
    seen, bad = set(), []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for mod in file_imports(path):
            top = mod.split(".", 1)[0]
            if top in BANNED or top == PROGRAM:
                bad.append(f"{os.path.relpath(path, root)}: {mod}")
            elif top == "portbench":
                stem = os.path.join(root, *mod.split("."))
                for cand in (stem + ".py", os.path.join(stem, "__init__.py")):
                    if os.path.exists(cand):
                        todo.append(cand)
    return sorted(bad)
