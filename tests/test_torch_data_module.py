"""The port's ``PSDDataModule`` against the JAX package's over the same
synthetic HDF5 class directories: the same file lists for the training,
validation and test splits and the same loader batches (the training
loader shuffled under one seed), without and with the offline shuffle
(``"data_prep": "shuffle"``), in float32 and under ``half_precision``;
splits restored from saved dataset JSONs (``train_config``,
``val_config``, ``test_config``) alike."""
import copy
import os

import numpy as np
import pytest

from waveformml_tpu_torch.config import Config, validate_config
from waveformml_tpu_torch.datasets.data_module import DataLoaderLite, PSDDataModule
from waveformml_tpu_torch.registry import retrieve_class

TYPES = ("Ioni", "Recoil")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from waveformml_tpu.datasets.synthetic import write_classification_dirs

    base = tmp_path_factory.mktemp("data")
    write_classification_dirs(str(base), TYPES, n_files=6, events_per_file=12, n_samples=8,
                              seed=11)
    return str(base)


def _config(data_dir, root, **dataset_config):
    return {
        "run_config": {"exp_name": "dm", "run_class": "LitPSD"},
        "system_config": {"model_name": "dm", "n_samples": 8, "n_type": 2,
                          "type_names": list(TYPES), "half_precision": 0,
                          "model_base_path": os.path.join(root, "model")},
        "net_config": {"net_class": "SubMPSDNet"},
        "optimize_config": {},
        "dataset_config": {"base_path": data_dir, "paths": list(TYPES),
                           "dataset_class": "PulseDataset2D", "dataset_params": {},
                           "n_train": 36, "n_validate": 12, "n_test": 12,
                           "dataloader_params": {"batch_size": 2, "num_workers": 0,
                                                 "seed": 3},
                           **dataset_config},
    }


def _modules(tmp_path, data_dir, half=False, **dataset_config):
    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.config import validate_config as jax_validate
    from waveformml_tpu.datasets.data_module import PSDDataModule as JaxPSDDataModule

    d = _config(data_dir, str(tmp_path / "jax"), **dataset_config)
    d["system_config"]["half_precision"] = int(half)
    jdm = JaxPSDDataModule(jax_validate(JaxConfig(copy.deepcopy(d))))
    d = _config(data_dir, str(tmp_path / "port"), **dataset_config)
    d["system_config"]["half_precision"] = int(half)
    pdm = PSDDataModule(validate_config(Config(d)))
    return jdm, pdm


def _assert_same_batches(jl, pl):
    jb, pb = list(jl), list(pl)
    assert len(jb) == len(pb) == len(jl) == len(pl) > 0
    for a, b in zip(jb, pb):
        for name in ("coords", "feats", "labels"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    return pb


@pytest.mark.parametrize("half", [False, True], ids=["float32", "half"])
@pytest.mark.parametrize("data_prep", [None, "shuffle"], ids=["in_order", "shuffled"])
def test_splits_and_batches_match_jax(tmp_path, data_dir, data_prep, half):
    extra = {"data_prep": "shuffle", "shuffled_size": 8} if data_prep else {}
    jdm, pdm = _modules(tmp_path, data_dir, half, **extra)
    for dm in (jdm, pdm):
        dm.setup("fit")
        dm.setup("test")
    name = os.path.basename if data_prep else (lambda p: p)
    for split in ("train", "val", "test"):
        jds, pds = getattr(jdm, f"{split}_dataset"), getattr(pdm, f"{split}_dataset")
        assert [name(f) for f in jds.get_file_list()] == [name(f) for f in pds.get_file_list()]
    files = [set(getattr(pdm, f"{s}_dataset").get_file_list()) for s in ("val", "test")]
    assert not files[0] & files[1] and not files[0] & set(pdm.train_excludes)
    if data_prep:
        assert all(os.path.basename(f).startswith("Combined_")
                   for f in pdm.train_dataset.get_file_list())
    # two epochs of the training loader: its order is drawn anew each epoch
    jl, pl = jdm.train_dataloader(), pdm.train_dataloader()
    assert isinstance(pl, DataLoaderLite) and pl.shuffle
    epochs = [_assert_same_batches(jl, pl) for _ in range(2)]
    labels = [np.concatenate([b.labels for b in e]) for e in epochs]
    assert set(np.unique(labels[0])) == {0, 1}
    _assert_same_batches(jdm.val_dataloader(), pdm.val_dataloader())
    test = _assert_same_batches(jdm.test_dataloader(), pdm.test_dataloader())
    assert test[0].feats.dtype == (np.float16 if half else np.float32)


def test_saved_splits_restore_alike(tmp_path, data_dir):
    """Splits given as the dataset JSONs a first module wrote."""
    _, first = _modules(tmp_path / "first", data_dir)
    first.setup(None)
    saved = {}
    for split, key in (("train", "train_config"), ("val", "val_config"),
                       ("test", "test_config")):
        path = str(tmp_path / f"{split}.json")
        getattr(first, f"{split}_dataset").save_info_to_file(path)
        saved[key] = path
    jdm, pdm = _modules(tmp_path / "second", data_dir, **saved)
    for dm in (jdm, pdm):
        dm.setup(None)
    for split in ("train", "val", "test"):
        assert (getattr(pdm, f"{split}_dataset").get_file_list()
                == getattr(first, f"{split}_dataset").get_file_list())
    _assert_same_batches(jdm.train_dataloader(), pdm.train_dataloader())
    _assert_same_batches(jdm.test_dataloader(), pdm.test_dataloader())


def test_registered_under_both_names():
    assert retrieve_class("PSDDataModule") is PSDDataModule
    assert retrieve_class("PSDDataModule.PSDDataModule") is PSDDataModule
