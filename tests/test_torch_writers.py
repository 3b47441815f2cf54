"""The prediction writers against the JAX package's, on the CPU.

Tiny JAX checkpoints (the configs of tests/test_inference.py's writer
tests, weights redrawn from a seed) are converted to port state dicts
(``convert.flax_to_state_dict``); one input file per record type is
written with the JAX synthetic writers, with a Chanmap table and PyTables
attributes, and one calibration database with the JAX
``write_synthetic_caldb``. Each case runs the JAX writer, then the port's
with ``device="cpu"``, 16 rows a read (many chunks, each cut at an event
boundary), and holds the port's table to the JAX one: the same dtype and
rows, every field the writer copies byte-equal, the fields the model
writes within rtol 1e-4, atol 1e-5, the random
fields of PhysPulse records in [0, 1) on the same rows, the table
attributes and the Chanmap equal, and the XML sidecar's step settings
equal but for paths and checksums."""
import copy
import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from waveformml_tpu_torch.convert import flax_to_state_dict
from waveformml_tpu_torch.datasets import synthetic
from waveformml_tpu_torch.detector import NX
from waveformml_tpu_torch.engineering.se_mask import seg_status_maps
from waveformml_tpu_torch.inference import prediction_writer as port_pw
from waveformml_tpu_torch.io import sql as port_sql
from waveformml_tpu_torch.io.hdf5 import open_h5
from waveformml_tpu_torch.ops.sparse import consecutive_event_index, normalize_waveforms

h5py = pytest.importorskip("h5py")

RTOL, ATOL = 1e-4, 1e-5              # tests/test_torch_slice.py's output tolerance
CALGROUP = "testcal"
READ = 16
N_EVENTS = 40
#: the settings of an AnalysisStep that name a path or a checksum
PATH_SETTINGS = {"model_checkpoint", "model_config", "model_checkpoint_hash",
                 "model_config_hash", "model_z_checkpoint", "model_z_config",
                 "model_classifier_checkpoint", "model_classifier_config"}

CONV_SEG = {"pointwise_factor": 0, "pad_factor": 1.0, "size_factor": 3, "stride_factor": 1.2,
            "n_expansion": 1, "expansion_factor": 1.2, "version": 1, "n_contraction": 1}
#: name → (run class, net config, n_type, dataset class)
MODELS = {
    "z": ("LitZ", {"criterion_class": "L1Loss", "algorithm": "conv",
                   "hparams": {"conv": {"kernel_size": 3, "n_layers": 2},
                               "point": {"pointwise_layers": 1}}}, 2, "PulseDatasetWFPair"),
    "z_norm": ("LitZ", {"criterion_class": "L1Loss", "algorithm": "conv",
                        "hparams": {"conv": {"kernel_size": 3, "n_layers": 2},
                                    "point": {"pointwise_layers": 1}}}, 2,
               "PulseDatasetWFPairNorm"),
    "irn": ("LitPSD", {"criterion_class": "CrossEntropyLoss", "net_class": "SubMPSDNet",
                       "hparams": {"out_planes": 4, "n_lin": 1,
                                   "conv_params": {"kernel_size": 3, "n_conv": 1, "n_point": 1,
                                                   "conv_position": 1, "version": 2}}},
            3, "PulseDatasetWFPairNorm"),
    "irnim": ("LitSegClassifier", {"criterion_class": "CrossEntropyLoss",
                                   "net_class": "SPConvPreserveNet",
                                   "hparams": {"n_conv": 1, "conv_params": CONV_SEG}},
              5, "PulseDatasetWFPairNorm"),
}

#: case → (writer class name, models, input, keyword arguments, output file name)
CASES = {
    "z_cal": ("ZPredictionWriter", ("z",), "cal",
              {"calgroup": CALGROUP, "datatype": "WaveformPairCal"}, "run1_ModelOut.h5"),
    "z_norm": ("ZPredictionWriter", ("z_norm",), "norm", {}, "run2_ModelOut.h5"),
    "irn": ("IRNPredictionWriter", ("irn",), "norm", {}, "run2_ModelOut.h5"),
    "irnim_swap": ("IRNIMPredictionWriter", ("irnim",), "norm", {}, "run2_ModelOut.h5"),
    "irnim_phys": ("IRNIMPredictionWriter", ("irnim",), "cal",
                   {"calgroup": CALGROUP, "datatype": "PhysPulse"}, "run1_Phys.h5"),
    "z_and_class": ("ZAndClassWriter", ("z", "irnim"), "cal", {"calgroup": CALGROUP},
                    "run1_Phys.h5"),
}
INPUTS = {"cal": ("run1_WFCalFilteredSE.h5", "WaveformPairCal"),
          "norm": ("run2_WFNorm.h5", "WaveformPairNorm")}


def _config(tmp, name):
    run_class, net, n_type, dataset_class = MODELS[name]
    return {
        "run_config": {"exp_name": name, "run_class": run_class, "imports": []},
        "system_config": {"model_name": name, "n_samples": 65, "n_type": n_type,
                          "type_names": [f"c{i}" for i in range(n_type)],
                          "model_base_path": str(tmp / "model"), "half_precision": 0},
        "net_config": {"criterion_params": [], "imports": [], "net_type": "2DConvolution",
                       **copy.deepcopy(net)},
        "optimize_config": {"total_epoch": 1, "lr": 0.01, "validation_freq": 1, "imports": [],
                            "optimizer_class": "optim.SGD", "optimizer_params": {}},
        "dataset_config": {"mode": "path", "imports": [], "paths": ["a"],
                           "dataset_class": dataset_class, "dataset_params": {},
                           "n_train": 8, "n_validate": 4},
    }


def _checkpoints(tmp, name, seed):
    """A JAX Trainer's state with its biases, BatchNorm scales and
    statistics redrawn from ``seed`` (init leaves them trivial), saved as
    an orbax checkpoint, and the same weights as a port state dict saved
    with ``torch.save``; returns (config path, JAX checkpoint, port
    checkpoint)."""
    import jax
    import jax.numpy as jnp
    from flax.traverse_util import flatten_dict, unflatten_dict

    from waveformml_tpu.config import Config, save_config
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock
    from waveformml_tpu.engineering.trainer import Trainer
    from waveformml_tpu.parallel.mesh import make_mesh
    from waveformml_tpu.registry import retrieve_class

    d = _config(tmp, name)
    cfg = Config(d)
    task = retrieve_class(d["run_config"]["run_class"])(cfg)
    rng = np.random.default_rng(seed)
    coords = np.array([[1, 1, 0], [2, 2, 1]], dtype=np.int32)
    feats = rng.random((2, 130)).astype(np.float32)
    labels = (np.zeros(2, np.int64) if d["run_config"]["run_class"] != "LitZ"
              else rng.random(2).astype(np.float32))
    jt = Trainer(cfg, task, mesh=make_mesh(jax.devices()[:1]), seed=seed)
    jt._ensure_state(FileBlock(coords, feats, labels, {}))
    flat = {}
    for k, v in flatten_dict(jax.device_get({"params": jt.state.params,
                                             "batch_stats": jt.state.batch_stats}),
                             sep="/").items():
        v = np.asarray(v)
        if k.endswith("/kernel"):
            value = v
        elif k.endswith("/var"):
            value = rng.uniform(0.5, 2.0, size=v.shape)
        else:
            value = rng.normal(size=v.shape) * 0.1 + k.endswith("/scale")
        flat[k] = value.astype(np.float32)
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v) for k, v in flat.items()})
    jt.state.params, jt.state.batch_stats = tree["params"], tree["batch_stats"]
    cfg_path = str(tmp / f"{name}.json")
    save_config(cfg, cfg_path)
    jax_ckpt = str(tmp / f"{name}.ckpt")
    jt.save_checkpoint(jax_ckpt)
    port_ckpt = str(tmp / f"{name}.pt")
    torch.save(flax_to_state_dict(flat), port_ckpt)
    return cfg_path, jax_ckpt, port_ckpt


def _add_p2x(path, table, rng):
    """PyTables attributes on a table and a Chanmap table with its own, as
    the analysis chain's files carry them."""
    def s(text):
        return np.bytes_(text.encode())

    with h5py.File(path, "a") as h5:
        attrs = h5[table].attrs
        attrs["CLASS"] = s("TABLE")
        for n, field in enumerate(h5[table].dtype.names):
            attrs[f"FIELD_{n}_NAME"] = s(field)
        attrs["TITLE"] = s("")
        attrs["VERSION"] = s("2.7")
        attrs["abstime"] = np.array([1.6e9 + rng.uniform()])
        attrs["runtime"] = np.array([rng.uniform(100, 200)])
        attrs["calgrp"] = s(CALGROUP)
        attrs["rname"] = s("s015_f00001_ts1520")
        attrs["scalingfactor"] = np.array([0.75])
        chanmap = np.zeros(308, dtype=[("det", np.int32), ("x", np.int32), ("y", np.int32)])
        chanmap["det"] = np.arange(308)
        chanmap["x"] = (chanmap["det"] // 2) % NX
        chanmap["y"] = (chanmap["det"] // 2) // NX
        h5.create_dataset("Chanmap", data=chanmap)
        cattrs = h5["Chanmap"].attrs
        cattrs["CLASS"] = s("TABLE")
        for n, field in enumerate(chanmap.dtype.names):
            cattrs[f"FIELD_{n}_NAME"] = s(field)
        cattrs["TITLE"] = s("channel map")
        cattrs["VERSION"] = s("2.7")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from waveformml_tpu.datasets.synthetic import write_wfnorm, write_wfpair_cal
    from waveformml_tpu.io.sql import write_synthetic_caldb

    tmp = tmp_path_factory.mktemp("writers")
    models = {name: _checkpoints(tmp, name, seed) for seed, name in enumerate(sorted(MODELS))}
    caldb = str(tmp / "cal.db")
    write_synthetic_caldb(caldb, CALGROUP, seed=2)
    rng = np.random.default_rng(7)
    inputs = {}
    for key, (name, table) in INPUTS.items():
        path = str(tmp / "in" / name)
        if key == "cal":
            write_wfpair_cal(path, n_events=N_EVENTS, seed=4)
        else:
            write_wfnorm(path, n_events=N_EVENTS, seed=5)
        _add_p2x(path, table, rng)
        inputs[key] = path
    return dict(tmp=tmp, models=models, caldb=caldb, inputs=inputs)


def _run(setup, case, package, monkeypatch):
    """One writer of ``package`` ("jax" or "port") over the case's input;
    returns the writer (its output and XML written)."""
    from waveformml_tpu.inference import prediction_writer as jax_pw

    writer, models, inp, kwargs, out_name = CASES[case]
    monkeypatch.setenv("PROSPECT_CALDB", setup["caldb"])
    out_dir = setup["tmp"] / case / package
    out_dir.mkdir(parents=True, exist_ok=True)
    args = []
    for m in models:
        cfg_path, jax_ckpt, port_ckpt = setup["models"][m]
        args += [cfg_path, jax_ckpt if package == "jax" else port_ckpt]
    kw = dict(kwargs, n_rows_per_read=READ)
    if package == "port":
        kw["device"] = "cpu"
    cls = getattr(jax_pw if package == "jax" else port_pw, writer)
    pw = cls(str(out_dir / out_name), setup["inputs"][inp], *args, **kw)
    pw.write_predictions()
    pw.write_XML(runtime=1.0)
    return pw


def _bytes(a):
    return np.ascontiguousarray(a).view(np.uint8)


def _read(path, table):
    with h5py.File(path, "r") as h5:
        rec = h5[table][()]
        attrs = {k: h5[table].attrs[k] for k in h5[table].attrs}
        chanmap = None
        if "Chanmap" in h5:
            chanmap = (h5["Chanmap"][()], {k: h5["Chanmap"].attrs[k]
                                           for k in h5["Chanmap"].attrs})
        attr_types = {k: h5[table].attrs.get_id(k).dtype for k in h5[table].attrs}
    return rec, attrs, attr_types, chanmap


def _assert_attrs_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert _bytes(np.asarray(got[k])).tobytes() == _bytes(np.asarray(want[k])).tobytes(), k


def _model_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _row_kinds(coords):
    """Rows at single-ended, double-ended and dead segments, and the
    seeing side of each row (the default dead PMTs)."""
    _, bl, br = seg_status_maps(None)
    left = bl[coords[:, 0], coords[:, 1]] == 1
    right = br[coords[:, 0], coords[:, 1]] == 1
    se = (left | right) & ~(left & right)
    return se, ~left & ~right, left & right, np.where(left, 1, 0)


def _compare_phys(got, want, inp, z_from_model):
    """PhysPulse records: the classifier's scores (and the model's z) at
    single-ended rows, copies elsewhere, the two random fields in [0, 1) on
    the rows that draw them."""
    se, de, dead, side = _row_kinds(inp["coord"])
    assert se.any() and de.any()
    assert not np.allclose(got["E"][se], inp["E"][se])
    for field in ("evt", "seg", "t", "PE", "PID", "E_SE", "PSD_SE"):
        assert _bytes(got[field]).tobytes() == _bytes(want[field]).tobytes(), field
    for field in ("E", "dt", "y", "PSD"):
        assert _bytes(got[field][~se]).tobytes() == _bytes(want[field][~se]).tobytes(), field
        _model_close(got[field][se], want[field][se])
    if z_from_model:
        _model_close(got["y_SE"][se], want["y_SE"][se])
        assert _bytes(got["y_SE"][~se]).tobytes() == _bytes(want["y_SE"][~se]).tobytes()
    else:
        assert _bytes(got["y_SE"]).tobytes() == _bytes(want["y_SE"]).tobytes()
    # rand: a score at single-ended rows, a draw at double-ended ones,
    # untouched at dead ones
    _model_close(got["rand"][se], want["rand"][se])
    for rec in (got, want):
        assert ((rec["rand"][de] >= 0) & (rec["rand"][de] < 1)).all()
    assert _bytes(got["rand"][dead]).tobytes() == _bytes(want["rand"][dead]).tobytes()
    # Esmear_SE: a draw on the seeing side of single-ended rows, else as left
    drawn = np.zeros(got["Esmear_SE"].shape, bool)
    drawn[np.flatnonzero(se), side[se]] = True
    for rec in (got, want):
        assert ((rec["Esmear_SE"][drawn] >= 0) & (rec["Esmear_SE"][drawn] < 1)).all()
    assert _bytes(got["Esmear_SE"][~drawn]).tobytes() == _bytes(want["Esmear_SE"][~drawn]).tobytes()


def _compare(case, got, want, inp):
    """The port's table against the JAX one, ``inp`` the input records."""
    assert got.dtype == want.dtype
    assert got.shape == want.shape == inp.shape
    if CASES[case][4].endswith("_Phys.h5"):
        _compare_phys(got, want, inp, z_from_model=case == "z_and_class")
        return
    field, cols = {"z_cal": ("EZ", [1]), "z_norm": ("EZ", [1]), "irn": ("phys", [4, 5, 6]),
                   "irnim_swap": ("phys", [2, 3, 4, 5, 6])}[case]
    for name in want.dtype.names:
        if name != field:
            assert _bytes(got[name]).tobytes() == _bytes(want[name]).tobytes(), name
    keep = [c for c in range(want[field].shape[1]) if c not in cols]
    assert _bytes(got[field][:, keep]).tobytes() == _bytes(want[field][:, keep]).tobytes()
    _model_close(got[field][:, cols], want[field][:, cols])
    assert not np.allclose(got[field][:, cols], inp[field][:, cols])


def _step_settings(xml_path, step):
    root = ET.parse(xml_path).getroot()
    steps = root.findall(".//AnalysisStep")
    assert len(steps) == 1
    node = steps[0].find(step)
    assert node is not None, step
    assert steps[0].find("input") is not None and steps[0].find("output") is not None
    return {k: v for k, v in node.attrib.items() if k not in PATH_SETTINGS}


@pytest.mark.parametrize("case", sorted(CASES))
def test_writer_matches_jax(setup, case, monkeypatch):
    jax_writer = _run(setup, case, "jax", monkeypatch)
    port_writer = _run(setup, case, "port", monkeypatch)
    table = jax_writer.data_type.name
    assert port_writer.data_type.name == table
    want, want_attrs, want_types, want_chanmap = _read(jax_writer.path, table)
    got, got_attrs, got_types, got_chanmap = _read(port_writer.path, table)
    inp, in_table = setup["inputs"][CASES[case][2]], INPUTS[CASES[case][2]][1]
    with h5py.File(inp, "r") as h5:
        _compare(case, got, want, h5[in_table][()])
    _assert_attrs_equal(got_attrs, want_attrs)
    assert got_types == want_types
    assert "nevents" in got_attrs and "CLASS" in got_attrs
    assert got_chanmap is not None and want_chanmap is not None
    np.testing.assert_array_equal(got_chanmap[0], want_chanmap[0])
    _assert_attrs_equal(got_chanmap[1], want_chanmap[1])
    step = CASES[case][0]
    assert (_step_settings(port_writer.path + ".xml", step)
            == _step_settings(jax_writer.path + ".xml", step))
    assert port_writer.model.dispatch_phases["fetch_s"] > 0
    assert set(port_writer.stage_seconds) == set(jax_writer.stage_seconds)


@pytest.mark.parametrize("case", ["z_cal", "irnim_swap", "z_and_class"])
def test_in_memory_stand_ins_match_the_files(setup, case, monkeypatch):
    """The stand-ins that serve machines without h5py (``in_memory_writer``)
    give the rows the HDF5 writer gives, from the same records."""
    writer, models, inp, kwargs, out_name = CASES[case]
    monkeypatch.setenv("PROSPECT_CALDB", setup["caldb"])
    file_writer = _run(setup, case, "port", monkeypatch)
    table = file_writer.data_type.name
    with h5py.File(file_writer.path, "r") as h5:
        want = h5[table][()]
    in_table = INPUTS[inp][1]
    with h5py.File(setup["inputs"][inp], "r") as h5:
        tables = {in_table: h5[in_table][()], "Chanmap": h5["Chanmap"][()]}
    args = []
    for m in models:
        cfg_path, _, port_ckpt = setup["models"][m]
        args += [cfg_path, port_ckpt]
    cls = synthetic.in_memory_writer(getattr(port_pw, writer), tables)
    pw = cls(str(setup["tmp"] / "never_written.h5"), setup["inputs"][inp], *args,
             n_rows_per_read=READ, device="cpu", **kwargs)
    pw.write_predictions()
    assert not os.path.exists(setup["tmp"] / "never_written.h5")
    got = pw.tables[table]
    assert got.dtype == want.dtype and got.shape == want.shape
    if table == "PhysPulse":
        for field in got.dtype.names:
            if field not in ("rand", "Esmear_SE"):
                np.testing.assert_array_equal(got[field], want[field], err_msg=field)
    else:
        assert _bytes(got).tobytes() == _bytes(want).tobytes()
    np.testing.assert_array_equal(pw.tables["Chanmap"], tables["Chanmap"])


def test_z_and_class_needs_a_calgroup(setup, monkeypatch):
    monkeypatch.setenv("PROSPECT_CALDB", setup["caldb"])
    (zc, _, zp), (cc, _, cp) = setup["models"]["z"], setup["models"]["irnim"]
    out = setup["tmp"] / "errors"
    out.mkdir(exist_ok=True)
    with pytest.raises(IOError, match="calgroup"):
        port_pw.ZAndClassWriter(str(out / "a_Phys.h5"), setup["inputs"]["cal"], zc, zp, cc, cp,
                                device="cpu")
    with pytest.raises(IOError, match="scale factor"):
        port_pw.ZAndClassWriter(str(out / "b_Phys.h5"), setup["inputs"]["cal"], zc, zp, cc, cp,
                                calgroup=CALGROUP, scale_factor=2.0, device="cpu")


def test_bad_datatype_raises(setup):
    cfg_path, _, port_ckpt = setup["models"]["irn"]
    out = setup["tmp"] / "errors"
    out.mkdir(exist_ok=True)
    with pytest.raises(IOError, match="unrecognized datatype"):
        port_pw.IRNPredictionWriter(str(out / "c_ModelOut.h5"), setup["inputs"]["norm"],
                                    cfg_path, port_ckpt, datatype="Waveforms", device="cpu")


def test_default_device_needs_a_card(setup, monkeypatch):
    """No fallback: without a card the default device raises, before any
    file is opened."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_path, _, port_ckpt = setup["models"]["irn"]
    out = setup["tmp"] / "errors" / "d_ModelOut.h5"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_pw.IRNPredictionWriter(str(out), setup["inputs"]["norm"], cfg_path, port_ckpt)
    assert not out.exists()


@pytest.mark.parametrize("kind", ["wfpair_cal", "wfnorm"])
def test_synthetic_writers_match_jax(tmp_path, kind):
    from waveformml_tpu.datasets import synthetic as jax_synthetic

    table = {"wfpair_cal": "WaveformPairCal", "wfnorm": "WaveformPairNorm"}[kind]
    paths = {}
    for name, module in (("jax", jax_synthetic), ("port", synthetic)):
        paths[name] = str(tmp_path / name / f"run_{table}.h5")
        getattr(module, f"write_{kind}")(paths[name], n_events=30, seed=11)
    with open_h5(paths["jax"]) as a, open_h5(paths["port"]) as b:
        assert a[table].dtype == b[table].dtype
        assert _bytes(a[table][()]).tobytes() == _bytes(b[table][()]).tobytes()
        assert sorted(a[table].attrs) == sorted(b[table].attrs)
        np.testing.assert_array_equal(a[table].attrs["nevents"], b[table].attrs["nevents"])
    records = getattr(synthetic, f"{kind}_records")(30, seed=11)
    with open_h5(paths["port"]) as b:
        assert _bytes(records).tobytes() == _bytes(b[table][()]).tobytes()


def test_get_gains_matches_jax(tmp_path):
    from waveformml_tpu.io import sql as jax_sql

    jax_db, port_db = str(tmp_path / "jax.db"), str(tmp_path / "port.db")
    jax_sql.write_synthetic_caldb(jax_db, CALGROUP, seed=3)
    port_sql.write_synthetic_caldb(port_db, CALGROUP, seed=3)
    want = jax_sql.get_gains(jax_db, CALGROUP)
    assert want.shape == (14, 11, 2) and (want > 0).all()
    for db in (jax_db, port_db):
        got = port_sql.get_gains(db, CALGROUP)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        with port_sql.CalibrationDB(db, CALGROUP) as cal:
            for g, w in zip(cal.get_seg_cal_values(),
                            jax_sql.CalibrationDB(jax_db, CALGROUP).get_seg_cal_values()):
                np.testing.assert_array_equal(g, w)
    with pytest.raises(KeyError):
        port_sql.CalibrationDB(port_db, "nocal")
    assert port_sql.chan_to_coords(31) == jax_sql.chan_to_coords(31)


def test_gain_normalisation_on_the_device_is_the_hosts(setup, monkeypatch):
    """The captured ``preprocess`` gives the JAX device normalisation's
    products bit for bit: int16 → float32, each half times its factor."""
    from waveformml_tpu.inference.prediction_writer import _device_gain_pre as jax_pre
    from waveformml_tpu.ops.sparse import normalize_waveforms as jax_normalize

    monkeypatch.setenv("PROSPECT_CALDB", setup["caldb"])
    gains = port_pw._gain_factors(CALGROUP, 1.5)
    with h5py.File(setup["inputs"]["cal"], "r") as h5:
        rec = h5["WaveformPairCal"][()]
    coords, wf = rec["coord"].copy(), rec["waveform"]
    got = port_pw._device_gain_pre(gains, "cpu")(torch.from_numpy(coords),
                                                 torch.from_numpy(wf), None).numpy()
    want = np.asarray(jax_pre(gains)(coords, wf, None))
    assert got.dtype == np.float32
    assert _bytes(got).tobytes() == _bytes(want).tobytes()
    host = jax_normalize(coords.copy(), wf, gains)
    assert _bytes(got).tobytes() == _bytes(host).tobytes()
    port_coords = coords.copy()
    assert _bytes(normalize_waveforms(port_coords, wf, gains)).tobytes() == _bytes(host).tobytes()
    np.testing.assert_array_equal(port_coords[:, -1], consecutive_event_index(coords[:, -1]))


@pytest.mark.parametrize("compression", [0, 4])
@pytest.mark.parametrize("preserve_event", ["truncate", "extend", False])
def test_h5input_chunks_match_jax(tmp_path, compression, preserve_event):
    """The event-preserving reader, over a plain table and a gzip-chunked
    one (decoded on the thread pool), cuts the chunks the JAX reader cuts."""
    from waveformml_tpu.datasets.synthetic import write_wfpair_cal
    from waveformml_tpu.io.compound_types import WaveformPairCal as JaxType
    from waveformml_tpu.io.hdf5 import H5Input as JaxInput

    from waveformml_tpu_torch.io.compound_types import WaveformPairCal
    from waveformml_tpu_torch.io.hdf5 import H5Input, ParallelChunkReader

    path = str(tmp_path / "run_WFCalFilteredSE.h5")
    write_wfpair_cal(path, n_events=60, seed=12, compression=compression)
    chunks = {}
    for key, reader, t in (("jax", JaxInput, JaxType()), ("port", H5Input, WaveformPairCal())):
        with reader(path) as inp:
            inp.setup_table(t.name, t.type, t.event_index_name,
                            event_index_coord=t.event_index_coord)
            if key == "port":
                assert isinstance(inp._par, ParallelChunkReader) == bool(compression)
            chunks[key] = [c.copy() for c in inp.iter_chunks(16, preserve_event)]
            assert inp.next_chunk(16, preserve_event) is not None  # a pass restarts
    assert [len(c) for c in chunks["port"]] == [len(c) for c in chunks["jax"]]
    for got, want in zip(chunks["port"], chunks["jax"]):
        assert _bytes(got).tobytes() == _bytes(want).tobytes()


def test_h5_output_matches_jax(tmp_path):
    """Row blocks appended with flushes between them (the direct-chunk
    gzip appender and its partial chunk), a foreign-dtype block (h5py's
    conversion), a resize past the created length and the PyTables
    attributes: the file reads as the JAX writer's."""
    from waveformml_tpu.io.hdf5 import P2XTableWriter as JaxWriter

    from waveformml_tpu_torch.io.compound_types import PhysPulse
    from waveformml_tpu_torch.io.hdf5 import P2XTableWriter

    src = str(tmp_path / "src.h5")
    rec = np.zeros(3000, dtype=PhysPulse().type)
    rng = np.random.default_rng(13)
    for name in rec.dtype.names:
        rec[name] = rng.integers(0, 100, rec[name].shape)
    with h5py.File(src, "w") as h5:
        h5.create_dataset("PhysPulse", data=rec[:10])
    _add_p2x(src, "PhysPulse", rng)
    narrow = np.zeros(200, dtype=[(n, rec.dtype[n]) for n in rec.dtype.names])
    for name in rec.dtype.names:
        narrow[name] = rec[name][2000:2200]
    narrow = narrow.astype([(n, "<f8" if n == "E" else rec.dtype[n]) for n in rec.dtype.names])
    tables = {}
    for key, cls in (("jax", JaxWriter), ("port", P2XTableWriter)):
        out = str(tmp_path / f"{key}.h5")
        src_file = _InputFile(src)
        w = cls(out)
        w.copy_chanmap(src_file)
        w.create_table("PhysPulse", (2500,), rec.dtype, compression_opts=4)
        w.copy_p2x_attrs(src_file, "PhysPulse", "PhysPulse", list(rec.dtype.names))
        for lo in range(0, 2000, 700):
            w.add_rows("PhysPulse", rec[lo:min(lo + 700, 2000)])
            w.flush("PhysPulse")
        w.add_rows("PhysPulse", narrow)
        w.add_rows("PhysPulse", rec[2200:])
        w.close()
        src_file.close()
        tables[key] = _read(out, "PhysPulse")
    got, want = tables["port"], tables["jax"]
    assert got[0].shape == (3000,)
    assert _bytes(got[0]).tobytes() == _bytes(want[0]).tobytes()
    _assert_attrs_equal(got[1], want[1])
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[3][0], want[3][0])
    _assert_attrs_equal(got[3][1], want[3][1])


class _InputFile:
    """An open input file as the writers' ``copy_*`` methods read it."""

    def __init__(self, path):
        self.path = path
        self.h5f = h5py.File(path, "r")

    def close(self):
        self.h5f.close()


def test_concurrent_fetches_lose_no_update(setup, monkeypatch):
    """``fetch`` from more threads than cores at once, as the writers'
    fetch workers call it, with a short switch interval: every call's
    seconds reach ``dispatch_phases["fetch_s"]`` (each call's clock is
    made to advance by exactly 1)."""
    import sys
    import threading
    import types

    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.inference import model as model_module
    from waveformml_tpu_torch.utils import tracing

    cfg_path, _, port_ckpt = setup["models"]["irn"]
    server = model_module.InferenceModel(load_config(cfg_path), port_ckpt, device="cpu")
    with h5py.File(setup["inputs"]["norm"], "r") as h5:
        rec = h5["WaveformPairNorm"][()]
    handles = [server.dispatch(rec["coord"][:40], rec["pulse"][:40]) for _ in range(4)]
    local = threading.local()

    def clock():
        local.t = getattr(local, "t", 0.0) + 1.0
        return local.t

    # fetch times itself with a span of the tracer, which reads this clock
    monkeypatch.setattr(tracing, "time", types.SimpleNamespace(perf_counter=clock))
    server.dispatch_phases["fetch_s"] = 0.0
    n_threads, rounds = min(32, 2 * (os.cpu_count() or 1) + 1), 10
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [server.fetch(h) for _ in range(rounds)
                                                    for h in handles])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert server.dispatch_phases["fetch_s"] == n_threads * rounds * len(handles)
