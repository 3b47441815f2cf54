"""The port's test pass and evaluation entry points against the JAX
package's, on the CPU: ``Trainer.test`` of a narrow SubMPSD with the JAX
model's weights (``convert.flax_to_state_dict``) gives the JAX
``Trainer.test``'s metrics, evaluator arrays and logged tags over the same
blocks; ``python -m waveformml_tpu_torch.evaluate`` writes into the
checkpoint's version directory (``occlude_<n>`` with ``-oc``, ``model.pt2``
with ``--script``) and prints ``test:``; ``analyze_records`` gives the JAX
``AnalyzeWaveforms``'s average waveforms and feature means."""
import ast
import copy
import glob
import importlib.util
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_eval_common import FakeLogger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SAMPLES = 8

CFG = {
    "run_config": {"exp_name": "t", "run_class": "LitPSD", "imports": []},
    "system_config": {"model_name": "t", "n_samples": N_SAMPLES, "n_type": 2,
                      "type_names": ["Ioni", "Recoil"], "half_precision": 0},
    "net_config": {"criterion_class": "CrossEntropyLoss", "criterion_params": [],
                   "imports": [], "net_class": "SubMPSDNet", "net_type": "2DConvolution",
                   "hparams": {"out_planes": 8, "n_lin": 2,
                               "conv_params": {"kernel_size": 3, "n_conv": 2, "n_point": 1,
                                               "conv_position": 1, "version": 2}}},
    "optimize_config": {"total_epoch": 1, "lr": 0.01, "validation_freq": 1, "imports": [],
                        "optimizer_class": "optim.SGD", "optimizer_params": {}},
    "dataset_config": {"mode": "path", "imports": [], "paths": ["a", "b"],
                       "dataset_class": "PulseDataset2D", "dataset_params": {}},
}


@pytest.fixture(autouse=True)
def _restore_logger():
    """The CLIs point the package's logger at stdout; put it back."""
    logger = logging.getLogger("waveformml_tpu_torch")
    saved = (list(logger.handlers), logger.level)
    yield
    logger.handlers, logger.level = saved[0], saved[1]


def test_trainer_test_matches_the_jax_trainer_test():
    """Same weights, same three blocks of 40 events: equal test metrics
    (rtol 1e-5), evaluator arrays (rtol 1e-5: the logits agree to float32
    rounding, and no event's two logits lie that close) and logged tags."""
    import jax
    from flax.traverse_util import flatten_dict

    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock
    from waveformml_tpu.engineering.tasks import LitPSD as JaxLitPSD
    from waveformml_tpu.engineering.trainer import Trainer as JaxTrainer
    from waveformml_tpu.parallel.mesh import make_mesh

    from waveformml_tpu_torch.config import Config
    from waveformml_tpu_torch.convert import flax_to_state_dict
    from waveformml_tpu_torch.datasets.synthetic import BlockDataModule, labelled_block
    from waveformml_tpu_torch.engineering.tasks import LitPSD
    from waveformml_tpu_torch.engineering.trainer import Trainer
    from waveformml_tpu_torch.evaluation import accumulated_arrays

    rng = np.random.default_rng(31)
    blocks = [labelled_block(rng, 40, N_SAMPLES) for _ in range(3)]
    jcfg = JaxConfig(copy.deepcopy(CFG))
    jlog = FakeLogger()
    jtrainer = JaxTrainer(jcfg, JaxLitPSD(jcfg), logger=jlog,
                          mesh=make_mesh(jax.devices()[:1]), seed=0)
    jtrainer._ensure_state(JaxFileBlock(blocks[0].coords, blocks[0].feats, blocks[0].labels,
                                        {}))
    flat = flatten_dict(jax.device_get({"params": jtrainer.state.params,
                                        "batch_stats": jtrainer.state.batch_stats}), sep="/")
    want = jtrainer.test(BlockDataModule([], [], blocks))

    cfg = Config(copy.deepcopy(CFG))
    task = LitPSD(cfg, device="cpu")
    task.model.load_state_dict(flax_to_state_dict({k: np.asarray(v) for k, v in flat.items()}))
    log = FakeLogger()
    trainer = Trainer(cfg, task, device="cpu", logger=log)
    got = trainer.test(BlockDataModule([], [], blocks))

    assert set(got) == set(want) == {"test_loss", "test_accuracy"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    assert [p["events"] for p in trainer.test_phases] == [40, 40, 40]
    np.testing.assert_array_equal(trainer.last_test_arrays["confusion"],
                                  jtrainer.last_test_arrays["confusion"])
    want_arrays = accumulated_arrays(jtrainer.task.evaluator)
    got_arrays = accumulated_arrays(task.evaluator)
    assert sorted(got_arrays) == sorted(want_arrays)
    assert task.evaluator.confusion.sum() == 120
    for k, v in want_arrays.items():
        np.testing.assert_allclose(got_arrays[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    assert log.figures == jlog.figures and "test_confusion_matrix" in log.figures
    assert log.histograms == jlog.histograms
    assert sorted(log.scalars) == sorted(jlog.scalars)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """HDF5 class directories, SubMPSD.json over them (8 samples a PMT), and
    a checkpoint of the port's Trainer in a version directory that holds a
    TensorBoard event file, as ``main`` leaves one."""
    from waveformml_tpu_torch.config import load_config
    from waveformml_tpu_torch.datasets.synthetic import write_classification_dirs
    from waveformml_tpu_torch.engineering.tasks import LitPSD
    from waveformml_tpu_torch.engineering.trainer import Trainer
    from waveformml_tpu_torch.utils.tb import TBLogger

    base = tmp_path_factory.mktemp("evaluate")
    write_classification_dirs(str(base / "data"), ["Ioni", "Recoil"], n_files=4,
                              events_per_file=20, n_samples=N_SAMPLES, seed=5)
    with open(os.path.join(ROOT, "config", "examples", "SubMPSD.json")) as f:
        cfg = json.load(f)
    cfg["system_config"].update(n_samples=N_SAMPLES, model_base_path=str(base / "model"))
    cfg["dataset_config"].update(base_path=str(base / "data"), n_train=40, n_validate=20,
                                 n_test=20, shuffled_size=20,
                                 dataloader_params={"batch_size": 1, "num_workers": 0})
    path = str(base / "SubMPSD.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    version = base / "model" / "SubMPSD" / "runs" / "SubMPSD" / "version_0"
    TBLogger(str(version)).close()
    config = load_config(path)
    ckpt = str(version / "epoch=0-val_loss=0.69.ckpt")
    Trainer(config, LitPSD(config, "cpu"), "cpu").save_checkpoint(ckpt)
    return {"config": path, "ckpt": ckpt, "version": str(version)}


def _printed_test(out: str) -> dict:
    line = [ln for ln in out.splitlines() if ln.startswith("test: ")]
    assert len(line) == 1, out
    return ast.literal_eval(line[0][len("test: "):])


def test_evaluate_cli_writes_into_the_version_directory(checkpoint, capsys):
    from waveformml_tpu_torch import evaluate

    version = checkpoint["version"]

    def event_bytes():
        return sum(os.path.getsize(f) for f in glob.glob(os.path.join(version, "*tfevents*")))

    before = event_bytes()
    assert evaluate.main([checkpoint["config"], checkpoint["ckpt"], "--device", "cpu",
                          "-v", "1"]) == 0
    metrics = _printed_test(capsys.readouterr().out)
    assert set(metrics) == {"test_loss", "test_accuracy"}
    # the test scalars and figures went into the checkpoint's own directory
    assert event_bytes() > before + 10_000
    assert not os.path.exists(os.path.join(version, "evaluate"))
    assert evaluate.log_dir_for(checkpoint["ckpt"], 3) == os.path.join(version, "occlude_3")
    # --script exports the eval forward into the same directory
    assert evaluate.main([checkpoint["config"], checkpoint["ckpt"], "--script",
                          "--limit_test_batches", "1", "--device", "cpu", "-v", "1"]) == 0
    assert set(_printed_test(capsys.readouterr().out)) == {"test_loss", "test_accuracy"}
    assert os.path.getsize(os.path.join(version, "model.pt2")) > 0


def test_evaluate_module_occludes_into_its_own_directory(checkpoint):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-m", "waveformml_tpu_torch.evaluate",
                           checkpoint["config"], checkpoint["ckpt"], "-oc", "3",
                           "--limit_test_batches", "1", "--device", "cpu", "-nt", "2"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert set(_printed_test(proc.stdout)) == {"test_loss", "test_accuracy"}
    assert glob.glob(os.path.join(checkpoint["version"], "occlude_3", "*tfevents*"))


def _jax_analyze_waveforms():
    spec = importlib.util.spec_from_file_location(
        "AnalyzeWaveforms", os.path.join(ROOT, "scripts", "AnalyzeWaveforms.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_analyze_records_matches_jax_analyze_dir(tmp_path):
    """The average waveform (float64 sums, exact) and the feature means
    (the port sums float64 on the device, the JAX script float32 with
    numpy: rtol 1e-5) over the same files; the CLI writes its outputs."""
    from waveformml_tpu_torch.datasets.synthetic import write_classification_dirs
    from waveformml_tpu_torch.io.hdf5 import open_h5
    from waveformml_tpu_torch.scripts import analyze_waveforms

    dirs = write_classification_dirs(str(tmp_path / "data"), ["A", "B"], n_files=2,
                                     events_per_file=8, n_samples=40, seed=11)
    jax_aw = _jax_analyze_waveforms()
    for name, d in dirs.items():
        want = jax_aw.analyze_dir(d, *jax_aw.TYPE_INFO["2d"], 1_000_000)
        got = analyze_waveforms.analyze_dir(d, *analyze_waveforms.TYPE_INFO["2d"], 1_000_000,
                                            device="cpu")
        chunks = []
        for fp in sorted(glob.glob(os.path.join(d, "*WaveformPairSim.h5"))):
            with open_h5(fp) as h5:
                chunks.append(h5["WaveformPairs"][:]["waveform"])
        again = analyze_waveforms.analyze_records(chunks, device="cpu")
        for r in (got, again):
            assert r["n"] == want["n"] > 0
            np.testing.assert_array_equal(r["mean"], want["mean"])
            np.testing.assert_array_equal(r["err"], want["err"])
            assert sorted(r["features"]) == sorted(want["features"])
            for k, v in want["features"].items():
                assert r["features"][k] == pytest.approx(v, rel=1e-5), (name, k)
    out = tmp_path / "analysis"
    assert analyze_waveforms.main([dirs["A"], dirs["B"], "-o", str(out), "--device", "cpu"]) == 0
    feats = json.load(open(out / "waveform_features.json"))
    assert feats["B"]["psd"] > feats["A"]["psd"]
    assert np.load(out / "average_waveforms.npz")["A_mean"].shape == (80,)
    assert (out / "average_waveforms.png").exists()
