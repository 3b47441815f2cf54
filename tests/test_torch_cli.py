"""The port's CLI, ``python -m waveformml_tpu_torch.main``, on the CPU
(``--device cpu``) over synthetic HDF5 class directories: the run
directories are named as the JAX CLI names them (the JAX package's
``next_experiment_name`` and ``next_version_dir``, the experiment kept
when a run resumes), each holds ``run_info.json``, the TensorBoard scalars
and the best checkpoint; ``fit:`` and ``test:`` print the JAX CLI's keys;
``-lb`` and ``-lc … -r`` start from a checkpoint (``-r`` resuming at its
epoch), ``-lb`` without one raises ``IOError``, and the GSPMD engine's
flags, not ported yet, raise ``NotImplementedError`` before any rendezvous
(``-oc`` and ``--profiler`` are held in tests/test_torch_hpo.py and
tests/test_torch_profiler.py, ``--distributed`` in
tests/test_torch_distributed.py)."""
import ast
import glob
import json
import logging
import os
import re
import subprocess
import sys

import pytest

from waveformml_tpu_torch import main as cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_KEYS = {"train_loss", "train_accuracy", "val_loss", "val_accuracy"}
TEST_KEYS = {"test_loss", "test_accuracy"}


@pytest.fixture(autouse=True)
def _restore_logger():
    """``main`` points the package's logger at the (captured) stdout; put
    its handlers and level back afterwards."""
    logger = logging.getLogger("waveformml_tpu_torch")
    saved = (list(logger.handlers), logger.level)
    yield
    logger.handlers, logger.level = saved[0], saved[1]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Class directories of synthetic events and a SubMPSD config over them
    (8 samples a PMT, 40 training events a class)."""
    from waveformml_tpu_torch.datasets.synthetic import write_classification_dirs

    base = tmp_path_factory.mktemp("cli")
    write_classification_dirs(str(base / "data"), ["Ioni", "Recoil"], n_files=4,
                              events_per_file=20, n_samples=8, seed=21)
    with open(os.path.join(ROOT, "config", "examples", "SubMPSD.json")) as f:
        cfg = json.load(f)
    cfg["system_config"].update(n_samples=8, model_base_path=str(base / "model"))
    cfg["dataset_config"].update(base_path=str(base / "data"), n_train=40, n_validate=20,
                                 n_test=20, shuffled_size=20,
                                 dataloader_params={"batch_size": 1, "num_workers": 0})
    path = base / "SubMPSD.json"
    with open(path, "w") as f:
        json.dump(cfg, f)
    return {"dir": base, "config": str(path), "folder": str(base / "model" / "SubMPSD")}


def _expected_run_dir(folder: str, exp: str, resuming: bool) -> str:
    from waveformml_tpu.utils.util import next_experiment_name, next_version_dir

    if not resuming:
        exp = next_experiment_name(folder, exp)
    return next_version_dir(os.path.join(folder, "runs", exp))


def _printed(out: str, tag: str) -> dict:
    line = [ln for ln in out.splitlines() if ln.startswith(f"{tag}: ")]
    assert len(line) == 1, out
    return ast.literal_eval(line[0][len(tag) + 2:])


def _check_run_dir(run_dir: str) -> str:
    assert os.path.isfile(os.path.join(run_dir, "run_info.json"))
    with open(os.path.join(run_dir, "run_info.json")) as f:
        info = json.load(f)
    assert info["device"] == "cpu" and "torch" in info
    assert glob.glob(os.path.join(run_dir, "*tfevents*"))
    ckpts = glob.glob(os.path.join(run_dir, "epoch=*-val_loss=*.ckpt"))
    assert len(ckpts) == 1, os.listdir(run_dir)
    return ckpts[0]


def _main(capsys, *argv) -> str:
    assert cli.main(list(argv)) == 0
    return capsys.readouterr().out


def test_cli_runs_and_resumes(workdir, capsys):
    folder = workdir["folder"]
    first = _expected_run_dir(folder, "SubMPSD", False)
    proc = subprocess.run(
        [sys.executable, "-m", "waveformml_tpu_torch.main", workdir["config"], "-t",
         "--max_epochs", "2", "--device", "cpu"],
        cwd=str(workdir["dir"]), capture_output=True, text=True, timeout=300,
        env={**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
             "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert first.endswith(os.path.join("runs", "SubMPSD", "version_0"))
    _check_run_dir(first)
    assert set(_printed(proc.stdout, "fit")) == FIT_KEYS
    assert set(_printed(proc.stdout, "test")) == TEST_KEYS

    # a second fresh run: the experiment name is incremented
    second = _expected_run_dir(folder, "SubMPSD", False)
    assert second.endswith(os.path.join("SubMPSD_1", "version_0"))
    out = _main(capsys, workdir["config"], "--max_epochs", "1", "--device", "cpu")
    _check_run_dir(second)
    assert set(_printed(out, "fit")) == FIT_KEYS and "test: " not in out

    # -lb: the best checkpoint under the model folder, a fresh run
    third = _expected_run_dir(folder, "SubMPSD", False)
    out = _main(capsys, workdir["config"], "-lb", "--max_epochs", "1", "--device", "cpu")
    assert "best checkpoint: " in out
    _check_run_dir(third)

    # -lc … -r: resumes in the same experiment, at the checkpoint's epoch
    ckpt = _check_run_dir(first)
    epoch = int(re.search(r"epoch=(\d+)", os.path.basename(ckpt)).group(1))
    resumed = _expected_run_dir(folder, "SubMPSD", True)
    assert resumed.endswith(os.path.join("runs", "SubMPSD", "version_1"))
    out = _main(capsys, workdir["config"], "-lc", ckpt, "-r", "-t", "--max_epochs", "4",
                "--device", "cpu")
    assert os.path.isfile(os.path.join(resumed, "run_info.json"))
    done = [int(m) for m in re.findall(r"epoch (\d+) done in", out)]
    assert done == list(range(epoch, 4))
    assert set(_printed(out, "test")) == TEST_KEYS

    # -r without a checkpoint: a warning and a fresh run
    fresh = _expected_run_dir(folder, "SubMPSD", False)
    out = _main(capsys, workdir["config"], "-r", "--max_epochs", "1", "--device", "cpu")
    assert "--restore_training ignored" in out
    assert os.path.isfile(os.path.join(fresh, "run_info.json"))


def test_load_best_without_checkpoint_raises(workdir):
    with open(workdir["config"]) as f:
        cfg = json.load(f)
    cfg["system_config"]["model_name"] = "Empty"
    path = str(workdir["dir"] / "Empty.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(IOError, match="no checkpoint found"):
        cli.main([path, "-lb", "--max_epochs", "1", "--device", "cpu"])


@pytest.mark.parametrize("flags", [["--distributed", "--parallel", "gspmd", "--tp", "2",
                                    "--coordinator", "localhost:1", "--num_processes", "3",
                                    "--process_id", "0"], ["--tp", "2"]],
                         ids=lambda f: f[0].lstrip("-"))
def test_flags_not_ported_raise(workdir, flags):
    """``--tp 2`` over 3 processes, or without ``--distributed``, forms no
    (data, model) grid: the CLI raises before any rendezvous."""
    with pytest.raises(ValueError, match="cannot form a"):
        cli.main([workdir["config"], "--device", "cpu", *flags])
