"""The port's ``--profiler`` (waveformml_tpu_torch/utils/profiler.py and the
Trainer's ``profiler`` argument) against the JAX package's: the same
``SimpleProfiler`` table under one clock; a profiled fit of the port and
of the JAX Trainer over the same blocks write ``profile_results.txt`` with
the same actions and call counts; the ``torch.profiler`` trace lands under
``profile/`` of the run's log directory with and without a TensorBoard
logger, and names the kernels' ops; profiling changes no loss; the CLI
writes both into the run directory."""
import copy
import glob
import json
import logging
import os
import time

import numpy as np
import pytest
import torch

from waveformml_tpu_torch.config import Config
from waveformml_tpu_torch.datasets.synthetic import BlockDataModule
from waveformml_tpu_torch.engineering.tasks import LitPSD
from waveformml_tpu_torch.engineering.trainer import Trainer
from waveformml_tpu_torch.utils.profiler import SimpleProfiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS, STEPS = 2, 4


@pytest.fixture(autouse=True)
def _restore_logger():
    logger = logging.getLogger("waveformml_tpu_torch")
    saved = (list(logger.handlers), logger.level)
    yield
    logger.handlers, logger.level = saved[0], saved[1]


def _table(path: str) -> dict:
    """``profile_results.txt`` as {action: number of calls}, the Total row
    left out."""
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "Profiler Report"
    rows = {}
    for line in lines[6:]:
        cells = [c.strip() for c in line.split("|")]
        rows[cells[0]] = int(cells[2])
    return rows


def _drive(profiler):
    """The same start/stop sequence, with a nested and an unmatched stop."""
    for i in range(3):
        profiler.start("get_train_batch")
        profiler.stop("get_train_batch")
        with profiler.profile("run_training_step"):
            profiler.start("inner")
            profiler.stop("inner")
    profiler.stop("never_started")
    profiler.start("evaluation_step")
    profiler.stop("evaluation_step")


def test_simple_profiler_matches_jax(monkeypatch):
    """Under a clock that advances 0.25 s a reading (the wall clock 1.5 s),
    both profilers give the same rows and the same summary text."""
    from waveformml_tpu.utils.profiler import SimpleProfiler as JaxSimpleProfiler

    out = []
    for cls in (JaxSimpleProfiler, SimpleProfiler):
        ticks = iter(np.arange(0, 1000, 0.25))
        walls = iter(np.arange(100, 1000, 1.5))
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
        monkeypatch.setattr(time, "time", lambda: float(next(walls)))
        profiler = cls()
        _drive(profiler)
        out.append((profiler.rows(), profiler.summary()))
        monkeypatch.undo()
    assert out[0] == out[1]
    rows = {name: count for name, count, _, _ in out[1][0]}
    assert rows == {"get_train_batch": 3, "run_training_step": 3, "inner": 3,
                    "evaluation_step": 1}


class _Blocks:
    """An in-memory data module for the JAX Trainer."""

    def __init__(self, train, val):
        self.train, self.val = train, val

    def setup(self, stage=None):
        pass

    def train_dataloader(self):
        return self.train

    def val_dataloader(self):
        return self.val


def _data():
    from test_torch_trainer import _blocks

    rng = np.random.default_rng(5)
    return _blocks(rng, STEPS), _blocks(rng, 1)


def _port_fit(tmp_path, profiler: bool, logger=None, checkpoint_dir=None):
    from test_torch_trainer import CFG

    train, val = _data()
    cfg = Config(copy.deepcopy(CFG))
    torch.manual_seed(0)
    task = LitPSD(cfg, "cpu")
    trainer = Trainer(cfg, task, "cpu", max_epochs=EPOCHS, profiler=profiler, logger=logger,
                      checkpoint_dir=checkpoint_dir)
    trainer.fit(BlockDataModule(train, val))
    return trainer


def test_profile_table_matches_the_jax_trainer(tmp_path):
    """2 epochs of 4 steps and one validation batch: the same actions and
    counts in both packages' profile_results.txt."""
    import jax
    from test_torch_trainer import CFG

    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock
    from waveformml_tpu.engineering.tasks import LitPSD as JaxLitPSD
    from waveformml_tpu.engineering.trainer import Trainer as JaxTrainer
    from waveformml_tpu.parallel.mesh import make_mesh
    from waveformml_tpu.utils.tb import TBLogger as JaxTBLogger

    train, val = _data()
    jcfg = JaxConfig(copy.deepcopy(CFG))
    jlog = JaxTBLogger(str(tmp_path / "jax"))
    jtrainer = JaxTrainer(jcfg, JaxLitPSD(jcfg), logger=jlog, mesh=make_mesh(jax.devices()[:1]),
                          max_epochs=EPOCHS, profiler=True)
    to_jax = lambda bs: [JaxFileBlock(b.coords, b.feats, b.labels, {}) for b in bs]  # noqa: E731
    jtrainer.fit(_Blocks(to_jax(train), to_jax(val)))
    jlog.close()
    want = _table(str(tmp_path / "jax" / "profile_results.txt"))

    _port_fit(tmp_path, True, checkpoint_dir=str(tmp_path / "port"))
    got = _table(str(tmp_path / "port" / "profile_results.txt"))
    assert got == want == {"run_training_step": EPOCHS * STEPS,
                           "get_train_batch": EPOCHS * STEPS, "evaluation_step": EPOCHS}


@pytest.mark.parametrize("with_logger", [True, False], ids=["tb_logger", "no_logger"])
def test_trace_lands_in_the_log_dir(tmp_path, with_logger):
    """The trace is one Chrome-trace JSON under <log_dir>/profile, the
    logger's directory or, without one, the checkpoint directory, and it
    records the kernels' ops; the table lies beside it."""
    from waveformml_tpu_torch.utils.tb import TBLogger

    logger = TBLogger(str(tmp_path / "tb")) if with_logger else None
    log_dir = str(tmp_path / ("tb" if with_logger else "ckpt"))
    _port_fit(tmp_path, True, logger=logger, checkpoint_dir=str(tmp_path / "ckpt"))
    if logger is not None:
        logger.close()
    traces = glob.glob(os.path.join(log_dir, "profile", "*.pt.trace.json"))
    assert len(traces) == 1, os.listdir(log_dir)
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    for op in ("waveformml::subm_conv_rows", "waveformml::site_grouped_matmul",
               "waveformml::subm_conv_rows_wgrad", "waveformml::site_grouped_matmul_bwd"):
        assert op in names, op
    assert os.path.isfile(os.path.join(log_dir, "profile_results.txt"))


def test_profiler_changes_no_loss(tmp_path):
    plain = _port_fit(tmp_path, False)
    profiled = _port_fit(tmp_path, True, checkpoint_dir=str(tmp_path / "p"))
    assert profiled.step_losses == plain.step_losses
    assert len(profiled.step_losses) == EPOCHS * STEPS
    assert plain.simple_profiler is None


def test_cli_profiler_writes_into_the_run_dir(tmp_path, capsys):
    """``main <cfg> --profiler --device cpu``: the table and the trace in
    ``runs/<exp>/version_0``."""
    from waveformml_tpu_torch import main as cli
    from waveformml_tpu_torch.datasets.synthetic import write_classification_dirs

    write_classification_dirs(str(tmp_path / "data"), ["Ioni", "Recoil"], n_files=3,
                              events_per_file=20, n_samples=8, seed=4)
    with open(os.path.join(ROOT, "config", "examples", "SubMPSD.json")) as f:
        cfg = json.load(f)
    cfg["system_config"].update(n_samples=8, model_base_path=str(tmp_path / "model"))
    cfg["dataset_config"].update(base_path=str(tmp_path / "data"), n_train=20, n_validate=20,
                                 n_test=20, shuffled_size=20,
                                 dataloader_params={"batch_size": 1, "num_workers": 0})
    path = str(tmp_path / "SubMPSD.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    assert cli.main([path, "--profiler", "--max_epochs", "1", "--device", "cpu"]) == 0
    run_dir = os.path.join(str(tmp_path / "model"), "SubMPSD", "runs", "SubMPSD", "version_0")
    table = _table(os.path.join(run_dir, "profile_results.txt"))
    # one epoch: a validation batch for each class directory's file
    assert table["evaluation_step"] == 2
    assert table["run_training_step"] == table["get_train_batch"] >= 1
    assert len(glob.glob(os.path.join(run_dir, "profile", "*.pt.trace.json"))) == 1
    assert "fit:" in capsys.readouterr().out
