"""The port's HDF5 datasets against the JAX package's, over files that the
JAX package's synthetic writers write (h5py runs here; the port imports it
only inside its loaders): every registered ``PulseDataset*`` binding gives
the same ``FileBlock``s, array for array and dtype for dtype, for the
training, validation and test splits (each excluding the files of the ones
before it), with and without ``use_half``; label files, ``label_map`` and
``additional_fields`` pass through alike; ``write_shuffled`` writes the
same combined files in both packages (group and compound layouts); and a
dataset restored by ``retrieve_config`` from ``save_info_to_file``'s JSON
gives the same blocks without rediscovering its files."""
import copy
import os

import h5py
import numpy as np
import pytest

from waveformml_tpu_torch.config import Config
from waveformml_tpu_torch.registry import retrieve_class

TYPES = ("a", "b")
FILES, EVENTS = 4, 10


def _write_dirs(base, writer, pattern):
    """Two class directories of FILES files named ``<type>_<i>_<pattern>``,
    each written by ``writer(path, seed)``."""
    for k, name in enumerate(TYPES):
        os.makedirs(os.path.join(base, name), exist_ok=True)
        for i in range(FILES):
            writer(os.path.join(base, name, f"{name}_{i:05d}_{pattern}"), 100 * k + i)


def _det_pulse(table, label=None):
    """A writer of DetPulseCoord-style tables (coord [3], pulse [7] or [8],
    an optional z or EZ label field), which the JAX package has no writer
    for."""
    def write(path, seed):
        from waveformml_tpu.datasets.synthetic import make_events

        rng = np.random.default_rng(seed)
        ev = make_events(rng, EVENTS, 4)
        n = ev["coords"].shape[0]
        width = 8 if table == "DetPulseCoord8" else 7
        fields = [("coord", np.int32, (3,)), ("pulse", np.float32, (width,))]
        if label == "z":
            fields.append(("z", np.float32, (1,)))
        elif label == "EZ":
            fields.append(("EZ", np.float32, (2,)))
        rec = np.zeros(n, np.dtype(fields))
        rec["coord"] = ev["coords"]
        rec["pulse"] = rng.normal(size=(n, width)) * 100
        if label:
            rec[label] = rng.uniform(size=rec[label].shape)
        name = {"DetPulseCoord8": "DetPulseCoord"}.get(table, table)
        with h5py.File(path, "w") as h5:
            h5.create_dataset(name, data=rec)
            h5[name].attrs.create("nevents", np.array([float(EVENTS)]))
    return write


def _writers():
    from waveformml_tpu.datasets import synthetic as s

    pair = lambda label: (lambda p, seed: s.write_waveform_pair_sim(  # noqa: E731
        p, EVENTS, 8, kind=seed // 100, seed=seed, with_labels=label))
    return {
        "PulseDataset2D": (pair(None), "WaveformPairSim.h5", {}),
        "PulseDataset2DWithZ": (pair("z"), "WaveformPairZSim.h5", {}),
        "PulseDataset2DWithEZ": (pair("EZ"), "WaveformPairEZSim.h5", {"label_index": 1}),
        "PulseDataset3D": (lambda p, seed: s.write_waveform_3d_pair_sim(
            p, EVENTS, 8, kind=seed // 100, seed=seed), "Waveform3DPairSim.h5", {}),
        "PulseDatasetPMT": (_det_pulse("DetPulseCoord8"), "PMTCoordSim.h5", {}),
        "PulseDatasetDet": (_det_pulse("DetPulseCoord"), "DetCoordSim.h5", {}),
        "PulseDatasetDetWithZ": (_det_pulse("DetPulseCoordWithZ", "z"), "DetCoordZSim.h5",
                                 {}),
        "PulseDatasetDetWithEZ": (_det_pulse("DetPulseCoordWithEZ", "EZ"),
                                  "DetCoordEZSim.h5", {"label_index": 0}),
        "PulseDatasetWFPair": (lambda p, seed: s.write_wfpair_cal(p, EVENTS, seed=seed),
                               "WFPairSim.h5",
                               {"label_name": "PID", "label_map": {1: 0, 4: 1, 6: 1},
                                "additional_fields": ["E", "PSD"]}),
        "PulseDatasetWFPairEZ": (lambda p, seed: s.write_wfpair_cal(p, EVENTS, seed=seed),
                                 "WFPairSim.h5", {"label_index": 1}),
        "PulseDatasetRealWFPair": (lambda p, seed: s.write_wfpair_cal(p, EVENTS, seed=seed),
                                   "WFCalFilteredSE.h5", {}),
        "PulseDatasetWFPairNorm": (lambda p, seed: s.write_wfnorm(p, EVENTS, seed=seed),
                                   "WFNorm.h5", {"waveform_subset": [2, 40]}),
        "PulseDatasetWaveformNorm": (lambda p, seed: s.write_pulse_norm(p, EVENTS, seed=seed),
                                     "PulseNorm.h5", {"label_index": 0}),
        "PulseDatasetNormFeatures": (lambda p, seed: s.write_wf_features(p, EVENTS,
                                                                         seed=seed),
                                     "WFFeatures.h5", {}),
    }


def _config(tmp_path, root, dataset_class, **dataset_config):
    d = {"system_config": {"model_name": "m", "model_base_path":
                           str(tmp_path / root / "model")},
         "dataset_config": {"base_path": str(tmp_path / "data"), "paths": list(TYPES),
                            "dataset_class": dataset_class, "dataset_params": {},
                            **dataset_config}}
    return d


def _pair(tmp_path, dataset_class, split, n, params, excludes=(), **dataset_config):
    """The JAX and the port dataset of one split, each writing its metadata
    under a model folder of its own."""
    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.registry import retrieve_class as jax_retrieve_class

    d = _config(tmp_path, "jax", dataset_class, **dataset_config)
    jds = jax_retrieve_class(dataset_class)(JaxConfig(copy.deepcopy(d)), split, n,
                                            file_excludes=list(excludes),
                                            **copy.deepcopy(params))
    d = _config(tmp_path, "port", dataset_class, **dataset_config)
    pds = retrieve_class(dataset_class)(Config(d), split, n, file_excludes=list(excludes),
                                        **copy.deepcopy(params))
    return jds, pds


def _assert_same_blocks(jds, pds, name=lambda path: path):
    """Equal blocks, and equal file lists (as ``name`` maps each path)."""
    assert len(jds) == len(pds) > 0
    assert [name(f) for f in jds.get_file_list()] == [name(f) for f in pds.get_file_list()]
    for i in range(len(jds)):
        a, b = jds[i], pds[i]
        for name in ("coords", "feats", "labels"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and x.shape == y.shape, (i, name, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"block {i} {name}")
        assert sorted(a.extras) == sorted(b.extras)
        for k in a.extras:
            assert a.extras[k].dtype == b.extras[k].dtype
            np.testing.assert_array_equal(a.extras[k], b.extras[k])


@pytest.mark.parametrize("use_half", [False, True], ids=["float32", "half"])
@pytest.mark.parametrize("dataset_class", sorted(_writers()))
def test_binding_blocks_match_jax(tmp_path, dataset_class, use_half):
    writer, pattern, params = _writers()[dataset_class]
    _write_dirs(str(tmp_path / "data"), writer, pattern)
    params = dict(params, use_half=use_half)
    excludes = []
    for split, n in (("train", 2 * EVENTS), ("validate", EVENTS), ("test", EVENTS)):
        jds, pds = _pair(tmp_path, dataset_class, split, n, params, excludes)
        _assert_same_blocks(jds, pds)
        assert pds[0].feats.dtype == (np.float16 if use_half else np.float32)
        assert not set(excludes) & set(pds.get_file_list())
        excludes += pds.get_file_list()
    assert len(set(excludes)) == len(excludes) >= 2 * 3


def test_label_files_match_jax(tmp_path):
    """Per-event labels from ``*Labels.h5`` files beside the data files."""
    from waveformml_tpu.datasets.synthetic import write_classification_dirs

    write_classification_dirs(str(tmp_path / "data"), TYPES, FILES, EVENTS, 8, seed=7)
    rng = np.random.default_rng(8)
    for name in TYPES:
        for i in range(FILES):
            with h5py.File(tmp_path / "data" / name / f"{name}_{i:05d}_Labels.h5", "w") as h5:
                h5.create_dataset("labels", data=rng.integers(0, 3, EVENTS))
    params = {"label_name": "labels", "label_file_pattern": "*Labels.h5"}
    jds, pds = _pair(tmp_path, "PulseDataset2D", "train", 3 * EVENTS, params)
    _assert_same_blocks(jds, pds)
    assert pds[0].labels.shape == (EVENTS,) and pds[0].labels.max() > 0


@pytest.mark.parametrize("dataset_class,label", [("PulseDataset2D", None),
                                                 ("PulseDataset2DWithZ", "z")],
                         ids=["group_layout", "compound_layout"])
def test_write_shuffled_matches_jax(tmp_path, dataset_class, label):
    """The offline interleave: the same combined files (every dataset and
    attribute equal), the same sidecar configs, and the re-rooted datasets
    give the same blocks."""
    writer, pattern, params = _writers()[dataset_class]
    _write_dirs(str(tmp_path / "data"), writer, pattern)
    jds, pds = _pair(tmp_path, dataset_class, "train", 3 * EVENTS, params,
                     data_prep="shuffle", shuffled_size=8)
    assert jds.shuffle_queue == pds.shuffle_queue and pds.shuffle_queue
    jds.write_shuffled()
    pds.write_shuffled()
    names = sorted(os.listdir(pds.data_dir))
    assert names == sorted(os.listdir(jds.data_dir))
    assert any(n.startswith("Combined_") and n.endswith(".h5") for n in names)
    for name in names:
        jp, pp = os.path.join(jds.data_dir, name), os.path.join(pds.data_dir, name)
        if name.endswith(".json"):
            with open(jp) as a, open(pp) as b:
                assert a.read() == b.read()
            continue
        with h5py.File(jp, "r") as a, h5py.File(pp, "r") as b:
            def leaves(f):
                out = {}
                f.visititems(lambda k, v: out.__setitem__(k, v) if isinstance(
                    v, h5py.Dataset) else None)
                return out
            la, lb = leaves(a), leaves(b)
            assert sorted(la) == sorted(lb)
            for k in la:
                assert la[k].dtype == lb[k].dtype
                np.testing.assert_array_equal(la[k][()], lb[k][()])
            for k in a:
                assert dict(a[k].attrs) == dict(b[k].attrs)
    assert pds.group_mode == jds.group_mode == (label is None)
    _assert_same_blocks(jds, pds, name=os.path.basename)


def test_retrieve_config_round_trip(tmp_path):
    from waveformml_tpu.registry import retrieve_class as jax_retrieve_class

    writer, pattern, params = _writers()["PulseDatasetWFPair"]
    _write_dirs(str(tmp_path / "data"), writer, pattern)
    jds, pds = _pair(tmp_path, "PulseDatasetWFPair", "train", 2 * EVENTS, params)
    path = str(tmp_path / "saved.json")
    pds.save_info_to_file(path)
    cls = retrieve_class("PulseDatasetWFPair")
    restored = cls.retrieve_config(path, use_half=True)
    assert restored.get_file_list() == pds.get_file_list()
    assert restored.info["label_map"] == {1: 0, 4: 1, 6: 1}
    assert restored[0].feats.dtype == np.float16
    # the JAX package restores the port's JSON, and the port the JAX one's
    jax_restored = jax_retrieve_class("PulseDatasetWFPair").retrieve_config(path, True)
    _assert_same_blocks(jax_restored, restored)
    jpath = str(tmp_path / "saved_jax.json")
    jds.save_info_to_file(jpath)
    _assert_same_blocks(jds, cls.retrieve_config(jpath))
