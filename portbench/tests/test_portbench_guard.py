"""The import guard: whole top-level names, the references' imports, and a
run that fails where JAX is loaded."""
import os
import sys
import types

import pytest

from conftest import ROOT, small_run
from portbench import guard, harness


def test_names_compare_whole_top_level_parts():
    assert guard.banned_loaded(["waveformml_tpu_torch", "waveformml_tpu_torch.ops.native",
                                "jaxtyping", "flaxen.x", "numpy"]) == []
    assert guard.banned_loaded(["waveformml_tpu.ops", "jax.numpy", "jaxlib", "orbax.checkpoint",
                                "flax.linen"]) == ["flax", "jax", "jaxlib", "orbax",
                                                   "waveformml_tpu"]


def test_references_import_neither_the_program_nor_jax():
    assert guard.reference_imports(os.path.join(ROOT, "portbench", "reference")) == []


def test_a_reference_that_imports_the_program_is_found(tmp_path):
    ref = tmp_path / "reference"
    ref.mkdir()
    (ref / "Bad.py").write_text("import torch\nfrom waveformml_tpu_torch.ops import sparse\n")
    (ref / "Worse.py").write_text("import jax.numpy as jnp\n")
    found = guard.reference_imports(str(ref))
    assert any(f.endswith("Bad.py: waveformml_tpu_torch.ops") for f in found)
    assert any(f.endswith("Worse.py: jax.numpy") for f in found)


def test_a_run_fails_where_jax_is_loaded(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(guard.GuardError, match="jax"):
        harness.run_cell(small_run("zcnn.serve"))


def test_a_run_fails_where_a_metric_reader_loads_jax(tmp_path, monkeypatch):
    """A reader runs after the window has closed: JAX that it loads is found
    before the result."""
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(stub))
    load = harness.load_module

    def loading_jax(kind, name):
        if kind != "metrics":
            return load(kind, name)
        return types.SimpleNamespace(read=lambda r: __import__("jax") and None)

    monkeypatch.setattr(harness, "load_module", loading_jax)
    try:
        with pytest.raises(guard.GuardError, match="before the result: .*jax"):
            harness.run_cell(small_run("zcnn.serve", trace=True))
    finally:
        sys.modules.pop("jax", None)


def test_a_run_of_the_port_loads_nothing_banned():
    result = harness.run_cell(small_run("scnet3d.train"))
    assert result["correct"]
    assert guard.banned_loaded() == []
