"""The port's user scripts (``waveformml_tpu_torch.scripts``) and its
TensorBoard readers (``utils.tb``) against the JAX package's ``scripts/``
and ``waveformml_tpu.utils.tb``, on the fixtures of tests/test_scripts.py:
each pair is run on the same inputs and compared on what it gives its user
(the printed lines, the sqlite rows, the commands it runs, the best values
it reads back, the figure files it writes, the attribute it copies, the
peaks it finds)."""
import copy
import importlib
import json
import os
import sqlite3
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")


def _jax_script(name):
    """A module of the repository's ``scripts/``, imported in this process
    (EvalWFParams imports CompareSimCalCurve by its bare name)."""
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    return importlib.import_module(name)


def _port_script(name):
    return importlib.import_module(f"waveformml_tpu_torch.scripts.{name}")


def _run(capsys, module, argv):
    """(return code, printed lines) of ``module.main(argv)``."""
    capsys.readouterr()
    rc = module.main(argv) if argv is not None else module.main()
    return rc, capsys.readouterr().out.splitlines()


def _both(capsys, jax_name, port_name, argv_jax, argv_port=None):
    """Both scripts' (return code, printed lines); they must both succeed."""
    j = _run(capsys, _jax_script(jax_name), argv_jax)
    p = _run(capsys, _port_script(port_name), argv_jax if argv_port is None else argv_port)
    assert j[0] == p[0] == 0
    return j[1], p[1]


def _caldbs(tmp_path, *groups):
    """One synthetic calibration database per (calgroup, seed)."""
    from waveformml_tpu_torch.io.sql import write_synthetic_caldb

    paths = []
    for i, (group, seed) in enumerate(groups):
        path = str(tmp_path / f"cal{i}.db")
        write_synthetic_caldb(path, group, seed=seed)
        paths.append(path)
    return paths


def _rows(db, sql):
    conn = sqlite3.connect(db)
    try:
        return conn.execute(sql).fetchall()
    finally:
        conn.close()


def _same_rows(got, want):
    """Equal rows; floats to 1e-12 relative, NaN equal to NaN."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(b, float):
                np.testing.assert_allclose(a, b, rtol=1e-12, equal_nan=True)
            else:
                assert a == b


def test_peak_finder_matches_jax(capsys):
    """The same peaks, global maximum and culled peaks, printed the same."""
    from waveformml_tpu.ops.dsp import cull_peaks as jax_cull
    from waveformml_tpu.ops.dsp import find_peaks as jax_find

    from waveformml_tpu_torch.ops.dsp import cull_peaks, find_peaks

    want = _run(capsys, _jax_script("test_peak_finder"), None)
    got = _run(capsys, _port_script("peak_finder"), [])
    assert got == want and want[1][-1] == "OK"
    wf = _port_script("peak_finder").example_waveform()
    gmax, locs = find_peaks(wf, sep=10)
    jmax, jlocs = jax_find(wf, sep=10)
    assert gmax == jmax
    np.testing.assert_array_equal(locs, jlocs)
    np.testing.assert_array_equal(cull_peaks(locs, wf, gmax), jax_cull(jlocs, wf, jmax))


def test_compare_gains_matches_jax(capsys, tmp_path):
    db1, db2 = _caldbs(tmp_path, ("testcal", 1), ("testcal", 2))
    want, got = _both(capsys, "CompareGains", "compare_gains", [db1, db2, "testcal"])
    assert got == want and want[-1].startswith("max diff is det")


@pytest.mark.parametrize("seg", [None, 0, 7])
def test_compare_sim_cal_curve_matches_jax(capsys, tmp_path, seg):
    db1, db2 = _caldbs(tmp_path, ("simcal", 1), ("refcal", 2))
    argv = [db1, "simcal", db2, "refcal"] + ([] if seg is None else ["--seg", str(seg)])
    want, got = _both(capsys, "CompareSimCalCurve", "compare_sim_cal_curve", argv)
    assert got == want and want and all("normed diff" in line for line in want)
    with pytest.raises(IOError, match="nocal"):
        _port_script("compare_sim_cal_curve").main([db1, "nocal", db2, "refcal"])


def _gen(capsys, tmp_path, ranges, n):
    """GenWFParamConfig and gen_wf_param_config on one ranges file, each
    into its own database and directory: (jax db, port db, jax dir, port dir)."""
    path = tmp_path / "ranges.json"
    path.write_text(json.dumps(ranges))
    out = []
    for tag, name, module in (("jax", "GenWFParamConfig", _jax_script),
                              ("port", "gen_wf_param_config", _port_script)):
        db, cfgs = str(tmp_path / f"{tag}.db"), str(tmp_path / f"{tag}_cfgs")
        rc, lines = _run(capsys, module(name), [str(path), db, "-n", str(n), "-o", cfgs])
        assert rc == 0
        out.append((db, cfgs, [ln.replace(db, "DB").replace(cfgs, "DIR") for ln in lines]))
    (jdb, jdir, jlines), (pdb, pdir, plines) = out
    assert plines == jlines
    return jdb, pdb, jdir, pdir


def _body(path):
    """A rendered config without its comment lines."""
    with open(path) as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith("#")]


@pytest.mark.parametrize("ranges,n", [
    ({"lambda": [1500, 2000], "n": [1.4, 1.8]}, 2),
    ({"param_ranges": {"gain": [-6000, -4000], "zoff": [0, 10]}, "num_points": 3}, 1),
])
def test_gen_wf_param_config_matches_jax(capsys, tmp_path, ranges, n):
    """The same parameter sets in the database and the same rendered
    configs."""
    jdb, pdb, jdir, pdir = _gen(capsys, tmp_path, ranges, n)
    sql = "SELECT * FROM param_set ORDER BY id"
    _same_rows(_rows(pdb, sql), _rows(jdb, sql))
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(pdir)) == names and names
    for name in names:
        assert _body(os.path.join(pdir, name)) == _body(os.path.join(jdir, name))
        assert "%(" not in "".join(_body(os.path.join(pdir, name)))


def test_eval_wf_params_matches_jax(capsys, tmp_path):
    """The same curve differences stored for each parameter set, the same
    lines printed, and the same best fits read back."""
    from waveformml_tpu_torch.io.sql import write_synthetic_caldb

    jdb, pdb, _, _ = _gen(capsys, tmp_path, {"lambda": [1500, 2000]}, 3)
    refdb = str(tmp_path / "ref.db")
    write_synthetic_caldb(refdb, "refcal", seed=0)
    for name, seed in (("WaveCal1", 1), ("WaveCal2", 2)):
        write_synthetic_caldb(str(tmp_path / f"{name}.db"), name, seed=seed)
    # WaveCal3 has no simulated calibration: both skip it
    pattern = str(tmp_path / "{name}.db")
    want = _run(capsys, _jax_script("EvalWFParams"),
                [jdb, refdb, "refcal", "--sim_caldb_pattern", pattern])
    got = _run(capsys, _port_script("eval_wf_params"),
               [pdb, refdb, "refcal", "--sim_caldb_pattern", pattern])
    assert got[0] == want[0] == 0
    assert [ln.split(":")[0] for ln in got[1]] == [ln.split(":")[0] for ln in want[1]]
    assert sum("evaluated" in ln for ln in got[1]) == 2
    assert sum("skipping" in ln for ln in got[1]) == 1
    sql = "SELECT * FROM curve_diffs ORDER BY id"
    _same_rows(_rows(pdb, sql), _rows(jdb, sql))
    for seg in (0, 5):
        argv = ["-b", "2", "--seg", str(seg)]
        want = _run(capsys, _jax_script("EvalWFParams"), [jdb, refdb, "refcal"] + argv)
        got = _run(capsys, _port_script("eval_wf_params"), [pdb, refdb, "refcal"] + argv)
        assert got == want and len(want[1]) == 3


def test_compare_calibration_curves_matches_jax(capsys, tmp_path):
    db1, db2 = _caldbs(tmp_path, ("calA", 1), ("calB", 2))
    outs = [str(tmp_path / "jax"), str(tmp_path / "port")]
    lines = []
    for out, (name, module) in zip(outs, (("CompareCalibrationCurves", _jax_script),
                                          ("compare_calibration_curves", _port_script))):
        for curve in ("atten", "time", "lsum"):
            rc, printed = _run(capsys, module(name), [db1, "calA", db2, "calB", "-ch", "0",
                                                      "1", "5", "--curve", curve, "-o", out])
            assert rc == 0
            lines.append([ln.replace(out, "OUT") for ln in printed])
    assert lines[3:] == lines[:3]
    assert sorted(os.listdir(outs[1])) == sorted(os.listdir(outs[0]))
    assert "compare_atten_ch0.png" in os.listdir(outs[1])


def test_compare_pmt_wf_matches_jax(capsys, tmp_path):
    """The same per-channel averages, and a figure written."""
    from waveformml_tpu_torch.datasets.synthetic import write_wfpair_cal

    f1, f2 = str(tmp_path / "a_WFPairSim.h5"), str(tmp_path / "b_WFPairSim.h5")
    write_wfpair_cal(f1, n_events=120, seed=0)
    write_wfpair_cal(f2, n_events=120, seed=1)
    channels = [0, 1, 2, 3, 4, 5, 60, 61]
    jmod, pmod = _jax_script("Compare_PMT_WF"), _port_script("compare_pmt_wf")
    for f in (f1, f2):
        want = jmod.average_waveforms(f, "WaveformPairCal", 10000, channels)
        got = pmod.average_waveforms(f, "WaveformPairCal", 10000, channels)
        assert sorted(got) == sorted(want) and want
        for ch in want:
            np.testing.assert_array_equal(got[ch], want[ch])
    argv = [f1, f2, "-ch"] + [str(c) for c in channels]
    want, got = _both(capsys, "Compare_PMT_WF", "compare_pmt_wf",
                      argv + ["-o", str(tmp_path / "jax.png")],
                      argv + ["-o", str(tmp_path / "port.png")])
    assert [ln.replace("port", "jax") for ln in got] == want
    assert os.path.getsize(tmp_path / "port.png") > 0


def test_add_attr_matches_jax(capsys, tmp_path):
    import h5py

    ref = tmp_path / "ref.h5"
    targets = [tmp_path / "jax.h5", tmp_path / "port.h5"]
    for p, runtime in ((ref, 123.5), (targets[0], 0.0), (targets[1], 0.0)):
        with h5py.File(p, "w") as h5:
            h5.create_dataset("PhysPulse", data=np.zeros(4))
            h5["PhysPulse"].attrs.create("runtime", runtime)
            h5["PhysPulse"].attrs.create("livetime", runtime / 2)
    for attr in ("runtime", "livetime"):
        want, got = _both(capsys, "AddAttr", "add_attr",
                          [str(ref), str(targets[0]), "--attr", attr],
                          [str(ref), str(targets[1]), "--attr", attr])
        assert got == want == []
    values = []
    for t in targets:
        with h5py.File(t) as h5:
            values.append({k: h5["PhysPulse"].attrs[k] for k in ("runtime", "livetime")})
    assert values[1] == values[0] == {"runtime": 123.5, "livetime": 61.75}


def test_plot_model_weights_matches_jax(capsys, tmp_path):
    """The same tensors of rank ≥ 2 plotted, the port's from its own
    checkpoint of the same weights (``flax_to_state_dict``, each file named
    by its state_dict key)."""
    import orbax.checkpoint as ocp

    from waveformml_tpu_torch.convert import flax_to_state_dict

    rng = np.random.default_rng(0)
    params = {"dense_0": {"kernel": rng.random((8, 4)), "bias": np.zeros(4)},
              "conv": {"kernel": rng.random((3, 3, 2, 4)), "bias": np.zeros(4)},
              "stack": {"l0": {"kernel": rng.random((9, 3, 5)), "bias": np.zeros(5)}}}
    jckpt = tmp_path / "model.ckpt"
    ocp.PyTreeCheckpointer().save(str(jckpt), {"params": params})
    flat = {f"params/{m}/{leaf}": v for m, d in (("dense_0", params["dense_0"]),
                                                  ("conv", params["conv"]),
                                                  ("stack/l0", params["stack"]["l0"]))
            for leaf, v in d.items()}
    pckpt = tmp_path / "port.ckpt"
    trainer_like = {"state_dict": flax_to_state_dict(flat), "epoch": 0}
    torch.save(trainer_like, pckpt)
    jout, pout = tmp_path / "jax_plots", tmp_path / "port_plots"
    want, got = _both(capsys, "PlotModelWeights", "plot_model_weights",
                      [str(jckpt), "-o", str(jout)], [str(pckpt), "-o", str(pout)])
    renamed = sorted(n.replace("weight", "kernel") for n in os.listdir(pout))
    assert renamed == sorted(os.listdir(jout)) and len(renamed) == 3
    assert sorted(ln.replace("weight", "kernel") for ln in got) == sorted(want)
    # a bare state_dict file, and the plot limit
    torch.save(trainer_like["state_dict"], tmp_path / "state.pt")
    rc, lines = _run(capsys, _port_script("plot_model_weights"),
                     [str(tmp_path / "state.pt"), "-o", str(tmp_path / "two"),
                      "--max_plots", "2"])
    assert rc == 0 and len(lines) == 2 == len(os.listdir(tmp_path / "two"))


def test_run_occlusion_study_runs_the_port_evaluate(monkeypatch, tmp_path):
    """One evaluation per feature index with the JAX script's flags, through
    ``python -m waveformml_tpu_torch.evaluate``; unknown flags pass through."""
    jmod, pmod = _jax_script("RunOcclusionStudy"), _port_script("run_occlusion_study")
    assert jmod.subprocess is pmod.subprocess
    calls = []
    monkeypatch.setattr(pmod.subprocess, "call", lambda a, env=None: calls.append((a, env)) or 0)
    cfg = tmp_path / "c.json"
    cfg.write_text("{}")
    for argv in ([str(cfg), "ckpt", "3", "-c", "mycal", "--", "-nt", "2"],
                 [str(cfg), "ckpt", "2", "--device", "cpu", "-v", "1"]):
        calls.clear()
        assert jmod.main(argv) == 0
        jax_calls = [a for a, _ in calls]
        calls.clear()
        assert pmod.main(argv) == 0
        assert len(calls) == len(jax_calls) == int(argv[2])
        for (got, env), want in zip(calls, jax_calls):
            assert got[:3] == [sys.executable, "-m", "waveformml_tpu_torch.evaluate"]
            assert want[1].endswith("Evaluate.py")
            assert got[3:] == want[2:]
            assert env["PYTHONPATH"].split(os.pathsep)[0] == ROOT
    assert ["--device", "cpu"] == got[got.index("--device"):got.index("--device") + 2]


def _occlusion_dirs(tmp_path, losses):
    from waveformml_tpu_torch.utils.tb import TBLogger

    for idx, loss in losses.items():
        lg = TBLogger(str(tmp_path / f"occlude_{idx}"))
        lg.log_scalar("test_loss", loss + 0.1, 0)
        lg.log_scalar("test_loss", loss, 1)
        lg.log_scalar("test_accuracy", 1 - loss, 0)
        lg.close()


@pytest.mark.parametrize("split", [False, True])
def test_eval_occlusion_study_matches_jax(capsys, tmp_path, split):
    """The same best value of each index read back and printed, and the
    same figure files written."""
    _occlusion_dirs(tmp_path, {0: 0.5, 1: 0.25, 3: 0.125})
    argv = [str(tmp_path), "4"] + (["-s"] if split else [])
    figures = []
    lines = []
    for name, module in (("EvalOcclusionStudy", _jax_script),
                         ("eval_occlusion_study", _port_script)):
        rc, printed = _run(capsys, module(name), argv)
        assert rc == 0
        lines.append(sorted(printed))
        pngs = sorted(f for f in os.listdir(tmp_path) if f.endswith(".png"))
        figures.append(pngs)
        for f in pngs:
            os.remove(tmp_path / f)
    assert lines[1] == lines[0]
    assert figures[1] == figures[0] and len(figures[0]) == (2 if split else 1)
    best = _port_script("eval_occlusion_study").best_values(str(tmp_path), 4)
    np.testing.assert_array_equal(best, [0.5, 0.25, np.nan, 0.125])
    rc, _ = _run(capsys, _port_script("eval_occlusion_study"), [str(tmp_path / "none"), "2"])
    assert rc == 1


def test_tb_readers_match_jax(tmp_path):
    from waveformml_tpu.utils.tb import TBHelper as JaxTBHelper
    from waveformml_tpu.utils.tb import find_tfevents as jax_find_tfevents

    from waveformml_tpu_torch.utils.tb import TBHelper, find_tfevents

    _occlusion_dirs(tmp_path, {0: 0.5, 2: 0.75})
    files = find_tfevents(str(tmp_path))
    assert files == jax_find_tfevents(str(tmp_path)) and len(files) == 2
    got, want = TBHelper(), JaxTBHelper()
    for f in files:
        got.set_path(f)
        want.set_path(f)
        assert got.get_scalar_names() == want.get_scalar_names()
        for name in ("test_loss", "test_accuracy", "missing"):
            assert ([(s.step, s.value) for s in got.get_scalars(name)]
                    == [(s.step, s.value) for s in want.get_scalars(name)])
            for mode in ("min", "max"):
                assert got.get_best_value(name, mode) == want.get_best_value(name, mode)


def test_run_evaluation_matches_jax(tmp_path):
    """``utils.tb.run_evaluation`` of a port checkpoint gives the JAX
    ``run_evaluation``'s test metrics for the JAX checkpoint of the same
    weights, each logged into its folder."""
    import jax
    from flax.traverse_util import flatten_dict

    from waveformml_tpu.config import load_config as jax_load_config
    from waveformml_tpu.engineering.tasks import LitPSD as JaxLitPSD
    from waveformml_tpu.engineering.trainer import Trainer as JaxTrainer
    from waveformml_tpu.parallel.mesh import make_mesh
    from waveformml_tpu.utils.tb import run_evaluation as jax_run_evaluation

    from test_torch_evaluate import CFG, N_SAMPLES
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.convert import flax_to_state_dict
    from waveformml_tpu_torch.datasets.synthetic import write_classification_dirs
    from waveformml_tpu_torch.engineering.tasks import LitPSD
    from waveformml_tpu_torch.engineering.trainer import Trainer
    from waveformml_tpu_torch.main import choose_data_module
    from waveformml_tpu_torch.utils.tb import find_tfevents, run_evaluation

    write_classification_dirs(str(tmp_path / "data"), ["Ioni", "Recoil"], n_files=4,
                              events_per_file=20, n_samples=N_SAMPLES, seed=5)
    with open(os.path.join(ROOT, "config", "examples", "SubMPSD.json")) as f:
        d = json.load(f)
    d["net_config"] = copy.deepcopy(CFG["net_config"])
    d["system_config"].update(n_samples=N_SAMPLES, model_base_path=str(tmp_path / "model"))
    d["dataset_config"].update(base_path=str(tmp_path / "data"), n_train=40, n_validate=20,
                               n_test=20, shuffled_size=20,
                               dataloader_params={"batch_size": 1, "num_workers": 0})
    path = str(tmp_path / "SubMPSD.json")
    with open(path, "w") as f:
        json.dump(d, f)

    jcfg = jax_load_config(path)
    jt = JaxTrainer(jcfg, JaxLitPSD(jcfg), mesh=make_mesh(jax.devices()[:1]), seed=0,
                    callbacks=[])
    dm = choose_data_module(load_config(path))
    dm.setup("test")
    first = next(iter(dm.test_dataloader()))
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock

    jt._ensure_state(JaxFileBlock(first.coords, first.feats, first.labels, {}))
    jckpt = str(tmp_path / "jax" / "epoch=0-val_loss=0.69.ckpt")
    jt.save_checkpoint(jckpt)
    flat = flatten_dict(jax.device_get({"params": jt.state.params,
                                        "batch_stats": jt.state.batch_stats}), sep="/")
    config = load_config(path)
    task = LitPSD(config, "cpu")
    task.model.load_state_dict(flax_to_state_dict({k: np.asarray(v) for k, v in flat.items()}))
    pckpt = str(tmp_path / "port" / "epoch=0-val_loss=0.69.ckpt")
    os.makedirs(os.path.dirname(pckpt))
    Trainer(config, task, "cpu").save_checkpoint(pckpt)

    want = jax_run_evaluation(str(tmp_path / "jax_logs"), path, jckpt, calgroup=None)
    got = run_evaluation(str(tmp_path / "port_logs"), path, pckpt, device="cpu")
    assert set(got) == set(want) == {"test_loss", "test_accuracy"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert find_tfevents(str(tmp_path / "port_logs"))
