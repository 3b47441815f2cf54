"""The port's data-prep and study tools against the JAX package's:
``python -m waveformml_tpu_torch.combine_data`` and the top-level
``CombineData.py`` write the same ``Combined_*`` files (every dataset and
sidecar equal) for each ``-t`` whose files the synthetic writers write,
with the same ``TYPE_MAP``; ``scripts/validate_combined.py`` passes on both
outputs and fails on a file with one event moved; and
``scripts/eval_best_trials.py`` picks the trials ``scripts/EvalBestTrials.py``
picks, building a ``python -m waveformml_tpu_torch.evaluate`` command for
each."""
import importlib
import json
import logging
import os
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVENTS = 10


@pytest.fixture(autouse=True)
def _restore_logger():
    """``setup_logger`` points the package's loggers at stdout; put their
    handlers and levels back afterwards."""
    loggers = [logging.getLogger(n) for n in ("waveformml_tpu_torch", "waveformml_tpu", "")]
    saved = [(list(lg.handlers), lg.level) for lg in loggers]
    yield
    for lg, (handlers, level) in zip(loggers, saved):
        lg.handlers, lg.level = handlers, level


def _writers():
    """-t type → (writer(path, seed), file name pattern, HDF5 table)."""
    from waveformml_tpu.datasets import synthetic as s

    def pair(label):
        return lambda p, seed: s.write_waveform_pair_sim(p, EVENTS, 8, kind=seed // 100,
                                                         seed=seed, with_labels=label)

    wfpair = lambda p, seed: s.write_wfpair_cal(p, EVENTS, seed=seed)  # noqa: E731
    return {
        "2d": (pair(None), "WaveformPairSim.h5", "WaveformPairs"),
        "2dz": (pair("z"), "WaveformPairZSim.h5", "WaveformPairsWithZ"),
        "2dez": (pair("EZ"), "WaveformPairEZSim.h5", "WaveformPairsWithEZ"),
        "3d": (lambda p, seed: s.write_waveform_3d_pair_sim(p, EVENTS, 8, kind=seed // 100,
                                                            seed=seed),
               "Waveform3DPairSim.h5", "Waveform3DPairs"),
        "wfpair": (wfpair, "WFPairSim.h5", "WaveformPairCal"),
        "wfpairez": (wfpair, "WFPairSim.h5", "WaveformPairCal"),
    }


def _combine(tmp_path, monkeypatch, kind):
    """Two class directories of 3 files each, combined by both packages
    into files of 8 events; returns the two output directories."""
    import CombineData

    from waveformml_tpu_torch import combine_data

    writer, pattern, _ = _writers()[kind]
    dirs = []
    for k, name in enumerate(("a", "b")):
        d = tmp_path / "data" / name
        os.makedirs(d)
        for i in range(3):
            writer(str(d / f"{name}_{i:05d}_{pattern}"), 100 * k + i)
        dirs.append(str(d))
    monkeypatch.chdir(tmp_path)
    out = {}
    for mod, tag in ((CombineData, "jax"), (combine_data, "port")):
        out[tag] = str(tmp_path / f"out_{tag}")
        assert mod.main(dirs + ["-t", kind, "-s", "8", "-o", out[tag], "-v", "1"]) == 0
    return out


def _leaves(f):
    out = {}
    f.visititems(lambda k, v: out.__setitem__(k, v[()]) if isinstance(v, h5py.Dataset)
                 else None)
    return out


@pytest.mark.parametrize("kind", sorted(_writers()))
def test_combine_data_matches_jax(tmp_path, monkeypatch, kind):
    """Equal file lists, sidecars and datasets (coords, waveforms and
    labels, event for event); the port's validator passes on both."""
    from waveformml_tpu_torch.scripts.validate_combined import validate_dir

    out = _combine(tmp_path, monkeypatch, kind)
    names = sorted(os.listdir(out["port"]))
    assert names == sorted(os.listdir(out["jax"]))
    h5_names = [n for n in names if n.startswith("Combined_") and n.endswith(".h5")]
    assert len(h5_names) >= 2
    for name in names:
        jp, pp = os.path.join(out["jax"], name), os.path.join(out["port"], name)
        if name.endswith(".json"):
            with open(jp) as a, open(pp) as b:
                assert json.load(a) == json.load(b)
            continue
        with h5py.File(jp, "r") as a, h5py.File(pp, "r") as b:
            la, lb = _leaves(a), _leaves(b)
            assert sorted(la) == sorted(lb)
            for k in la:
                assert la[k].dtype == lb[k].dtype, k
                np.testing.assert_array_equal(la[k], lb[k], err_msg=f"{name} {k}")
    table = _writers()[kind][2]
    for tag in ("jax", "port"):
        assert validate_dir(out[tag], dataset=table) == len(h5_names)


def test_type_map_matches_jax():
    import CombineData

    from waveformml_tpu_torch import combine_data
    from waveformml_tpu_torch.registry import retrieve_class

    assert combine_data.TYPE_MAP == CombineData.TYPE_MAP
    for name in combine_data.TYPE_MAP.values():
        assert retrieve_class(name).__module__.startswith("waveformml_tpu_torch.")


def _move_first_event_to_the_end(path: Path, table: str) -> None:
    """Rewrite a combined file with its first event's rows moved behind the
    last event's (event ids as stored)."""
    with h5py.File(path, "r+") as h5:
        node = h5[table]
        if isinstance(node, h5py.Group):
            coords, feats = node["coord"][()], node["waveform"][()]
        else:
            rec = node[()]
            coords = rec["coord"]
        first = coords[:, -1] == coords[0, -1]
        order = np.concatenate([np.flatnonzero(~first), np.flatnonzero(first)])
        if isinstance(node, h5py.Group):
            del node["coord"], node["waveform"]
            node.create_dataset("coord", data=coords[order])
            node.create_dataset("waveform", data=feats[order])
        else:
            del h5[table]
            h5.create_dataset(table, data=rec[order])


@pytest.mark.parametrize("kind", ["2d", "2dz"], ids=["group_layout", "compound_layout"])
def test_validate_combined_fails_on_a_moved_event(tmp_path, monkeypatch, capsys, kind):
    from waveformml_tpu_torch.scripts import validate_combined

    out = _combine(tmp_path, monkeypatch, kind)
    table = _writers()[kind][2]
    assert validate_combined.main([out["port"], "--dataset", table]) == 0
    assert "Combined_0" in capsys.readouterr().out
    path = sorted(Path(out["port"]).glob("Combined_*.h5"))[1]
    _move_first_event_to_the_end(path, table)
    with pytest.raises(ValueError, match=path.name):
        validate_combined.main([out["port"], "--dataset", table])


def test_eval_best_trials_picks_the_jax_trials(tmp_path, monkeypatch):
    """A study of 4 trials, artifacts for 2 of the top 3: both scripts
    evaluate the same two trials' config and checkpoint, the port through
    ``python -m waveformml_tpu_torch.evaluate`` with ``-c`` passed on."""
    from waveformml_tpu_torch.config import Config, save_config
    from waveformml_tpu_torch.optimization.hpo import create_study
    from waveformml_tpu_torch.scripts import eval_best_trials

    cfg = Config({
        "run_config": {"exp_name": "sweep", "run_class": "LitPSD", "imports": []},
        "system_config": {"model_name": "m", "n_samples": 8, "n_type": 2,
                          "type_names": ["a"], "model_base_path": str(tmp_path / "model")},
        "net_config": {"criterion_class": "CrossEntropyLoss", "criterion_params": [],
                       "imports": [], "net_type": "2DConvolution", "net_class": "SubMPSDNet",
                       "hparams": {"out_planes": 4, "n_lin": 1,
                                   "conv_params": {"kernel_size": 3, "n_conv": 1, "n_point": 1,
                                                   "conv_position": 1, "version": 2}}},
        "optimize_config": {"total_epoch": 1, "lr": 0.01, "validation_freq": 1,
                            "imports": [], "optimizer_class": "optim.SGD",
                            "optimizer_params": {}},
        "dataset_config": {"mode": "path", "imports": [], "paths": ["a"],
                           "dataset_class": "PulseDataset2D", "dataset_params": {},
                           "n_train": 1, "n_validate": 1},
    })
    cfg_path = tmp_path / "config.json"
    save_config(cfg, str(cfg_path))
    study_dir = tmp_path / "model" / "m" / "studies" / "sweep"
    study = create_study("sweep", storage=str(study_dir / "study.db"))
    values = iter([0.4, 0.1, 0.3, 0.2])
    study.optimize(lambda t: next(values), n_trials=4)
    # trials 1 and 2 have a config and a checkpoint; trial 3 (ranked 2nd) none
    for number, ckpt in ((1, "epoch=1-val_loss=0.10.ckpt"), (2, "epoch=0-val_loss=0.30.ckpt")):
        trial_dir = study_dir / f"trial_{number}"
        os.makedirs(trial_dir)
        (trial_dir / ckpt).write_bytes(b"")
        save_config(cfg, str(trial_dir / "config.json"))

    monkeypatch.syspath_prepend(os.path.join(ROOT, "scripts"))
    jax_script = importlib.import_module("EvalBestTrials")
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jax_script.subprocess, "call", lambda a: calls["jax"].append(a) or 0)
    assert jax_script.main([str(cfg_path), "-n", "3", "-c", "g"]) == 0
    monkeypatch.setattr(eval_best_trials.subprocess, "call",
                        lambda a: calls["port"].append(a) or 0)
    assert eval_best_trials.main([str(cfg_path), "-n", "3", "-c", "g"]) == 0

    assert [c[2:4] for c in calls["jax"]] == [c[3:5] for c in calls["port"]]
    assert [os.path.basename(os.path.dirname(c[3])) for c in calls["port"]] == ["trial_1",
                                                                                 "trial_2"]
    for c in calls["port"]:
        assert c[:3] == [sys.executable, "-m", "waveformml_tpu_torch.evaluate"]
        assert c[3].endswith("config.json") and c[4].endswith(".ckpt")
        assert c[5:] == ["-c", "g"]
    ranked = eval_best_trials.top_trials(cfg, 3)
    assert [(n, v) for n, v, _, _ in ranked] == [(1, 0.1), (3, 0.2), (2, 0.3)]
    assert ranked[1][2:] == (None, None)
