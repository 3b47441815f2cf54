"""The port's prediction-writer CLIs against the JAX package's, on the CPU:
``python -m waveformml_tpu_torch.write_predictions`` against
``WritePredictions.main`` and ``...scripts.write_z_and_class`` against
scripts/WriteZAndClass.py over one file each (the same output name, table
and XML step settings), ``...scripts.write_prediction_batch`` over a
directory, and the output naming. The checkpoints, inputs and comparisons
are those of tests/test_torch_writers.py."""
import importlib.util
import os
import shutil

import numpy as np
import pytest

from test_torch_writers import (CALGROUP, INPUTS, _checkpoints, _compare, _step_settings,
                                _add_p2x)
from waveformml_tpu_torch import write_predictions
from waveformml_tpu_torch.scripts import write_prediction_batch, write_z_and_class

h5py = pytest.importorskip("h5py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from waveformml_tpu.datasets.synthetic import write_wfpair_cal
    from waveformml_tpu.io.sql import write_synthetic_caldb

    tmp = tmp_path_factory.mktemp("cli")
    models = {name: _checkpoints(tmp, name, seed) for seed, name in
              ((0, "irnim"), (3, "z"))}
    caldb = str(tmp / "cal.db")
    write_synthetic_caldb(caldb, CALGROUP, seed=2)
    name, table = INPUTS["cal"]
    source = str(tmp / name)
    write_wfpair_cal(source, n_events=30, seed=6)
    _add_p2x(source, table, np.random.default_rng(8))
    inputs = {}
    for package in ("jax", "port"):
        os.makedirs(tmp / package)
        inputs[package] = str(tmp / package / name)
        shutil.copy(source, inputs[package])
    return dict(tmp=tmp, models=models, caldb=caldb, inputs=inputs)


def _records(path, table):
    with h5py.File(path, "r") as h5:
        return h5[table][()]


def _printed_output(out: str, prefix: str) -> str:
    return next(line for line in out.splitlines() if line.startswith(prefix))[len(prefix):]


def test_write_predictions_cli_matches_jax(setup, monkeypatch, capsys):
    import WritePredictions

    monkeypatch.setenv("PROSPECT_CALDB", setup["caldb"])
    cfg, jax_ckpt, port_ckpt = setup["models"]["z"]
    flags = ["-w", "z", "-c", CALGROUP, "-r", "16", "-d", "WaveformPairCal"]
    assert WritePredictions.main([setup["inputs"]["jax"], cfg, jax_ckpt] + flags) == 0
    want_path = _printed_output(capsys.readouterr().out, "Writing output to ")
    assert write_predictions.main([setup["inputs"]["port"], cfg, port_ckpt, "--cpu"]
                                  + flags) == 0
    got_path = _printed_output(capsys.readouterr().out, "Writing output to ")
    assert os.path.basename(got_path) == os.path.basename(want_path) == \
        "run1_WFCalFilteredSEModelOut.h5"
    assert os.path.dirname(got_path) == os.path.dirname(setup["inputs"]["port"])
    table = INPUTS["cal"][1]
    _compare("z_cal", _records(got_path, table), _records(want_path, table),
             _records(setup["inputs"]["port"], table))
    assert (_step_settings(got_path + ".xml", "ZPredictionWriter")
            == _step_settings(want_path + ".xml", "ZPredictionWriter"))


def test_write_z_and_class_cli_matches_jax(setup, monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "WriteZAndClass", os.path.join(ROOT, "scripts", "WriteZAndClass.py"))
    jax_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_script)
    monkeypatch.setenv("PROSPECT_CALDB", setup["caldb"])
    zc, zj, zp = setup["models"]["z"]
    cc, cj, cp = setup["models"]["irnim"]
    flags = ["-c", CALGROUP, "-r", "16", "-sz", "1.5"]
    assert jax_script.main([setup["inputs"]["jax"], zc, zj, cc, cj] + flags) == 0
    want_path = _printed_output(capsys.readouterr().out, "Writing phys pulse output to ")
    assert write_z_and_class.main([setup["inputs"]["port"], zc, zp, cc, cp, "--cpu"]
                                  + flags) == 0
    got_path = _printed_output(capsys.readouterr().out, "Writing phys pulse output to ")
    assert os.path.basename(got_path) == os.path.basename(want_path) == "run1_Phys.h5"
    _compare("z_and_class", _records(got_path, "PhysPulse"), _records(want_path, "PhysPulse"),
             _records(setup["inputs"]["port"], INPUTS["cal"][1]))
    assert (_step_settings(got_path + ".xml", "ZAndClassWriter")
            == _step_settings(want_path + ".xml", "ZAndClassWriter"))


def test_write_prediction_batch_writes_each_file(setup, monkeypatch, tmp_path):
    """Every input of a directory gets its output; earlier outputs are not
    read as inputs."""
    monkeypatch.setenv("PROSPECT_CALDB", setup["caldb"])
    cfg, _, port_ckpt = setup["models"]["z"]
    for name in ("a_WFCalFilteredSE.h5", "b_WFCalFilteredSE.h5"):
        shutil.copy(setup["inputs"]["port"], tmp_path / name)
    shutil.copy(setup["inputs"]["port"], tmp_path / "old_ModelOut.h5")
    assert write_prediction_batch.main([str(tmp_path), cfg, port_ckpt, "-w", "z", "-c",
                                        CALGROUP, "-d", "WaveformPairCal", "--cpu"]) == 0
    assert sorted(os.listdir(tmp_path)) == sorted([
        "a_WFCalFilteredSE.h5", "a_WFCalFilteredSEModelOut.h5",
        "a_WFCalFilteredSEModelOut.h5.xml", "b_WFCalFilteredSE.h5",
        "b_WFCalFilteredSEModelOut.h5", "b_WFCalFilteredSEModelOut.h5.xml",
        "old_ModelOut.h5"])
    table = INPUTS["cal"][1]
    np.testing.assert_array_equal(_records(str(tmp_path / "a_WFCalFilteredSEModelOut.h5"), table),
                                  _records(str(tmp_path / "b_WFCalFilteredSEModelOut.h5"), table))


@pytest.mark.parametrize("inp, output, datatype, want", [
    ("/d/run_WFCal.h5", None, None, "/d/run_WFCalModelOut.h5"),
    ("/d/run_WFCal.hdf", None, None, "/d/run_WFCalModelOut.h5"),
    ("/d/s01_f2_WFCal.h5", None, "PhysPulse", "/d/s01_f2_Phys.h5"),
    ("/d/run_WFCal.h5", "/o/x.h5", None, "/o/x.h5"),
    ("/d/run_WFCal.h5", "DIR", None, "DIR/run_WFCalModelOut.h5"),
    ("/d/run_WFCal.h5", "DIR", "PhysPulse", "DIR/run_Phys.h5"),
])
def test_output_path_names_as_the_jax_cli(tmp_path, inp, output, datatype, want):
    if output == "DIR":
        output = str(tmp_path)
    assert write_predictions.output_path(inp, output, datatype) == \
        want.replace("DIR", str(tmp_path))


def test_output_path_refuses_what_is_neither_file_nor_directory(tmp_path):
    with pytest.raises(IOError, match="not a valid directory"):
        write_predictions.output_path("/d/run_WFCal.h5", str(tmp_path / "missing"))
