"""The port's hyperparameter search (waveformml_tpu_torch/optimization/hpo.py)
against the JAX package's: each test of tests/test_hpo.py on the port
(the suggest_* distributions, TPE against random sampling, the median
pruner, sqlite persistence and resume, ``OptunaDB``, config-path
addressing, ``main -oc -p`` end to end over synthetic HDF5 class
directories); then parity with the JAX package: for the same seeds a toy
study gives the same params, states, values and intermediate values in
both, each package reads the other's ``study.db``, the Trainer's pruning
hook prunes at the JAX Trainer's epoch, an objective's ``RuntimeError`` is
a failed trial in both, and on the port a CUDA fault other than running
out of memory, or a kernel that does not build, stops the study. Every task of the port takes a ``trial``
and leaves its config as it found it on a second construction."""
import copy
import json
import logging
import math
import os
import sqlite3
import subprocess
import sys

import numpy as np
import pytest
import torch

from waveformml_tpu_torch.config import Config
from waveformml_tpu_torch.optimization import hpo
from waveformml_tpu_torch.optimization.hpo import (
    MedianPruner, ModelOptimization, NopPruner, OptunaDB, RandomSampler, Study, TPESampler,
    Trial, TrialPruned, create_study, is_cuda_fault)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_logger():
    """``main`` points the package's logger at the (captured) stdout; put
    its handlers and level back afterwards."""
    logger = logging.getLogger("waveformml_tpu_torch")
    saved = (list(logger.handlers), logger.level)
    yield
    logger.handlers, logger.level = saved[0], saved[1]


# ---------------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------------

def test_suggest_distributions_bounds_and_types():
    study = create_study(sampler=RandomSampler(seed=7))
    ints, floats, logs, cats = [], [], [], []
    for i in range(400):
        t = Trial(study, i)
        ints.append(t.suggest_int("i", 2, 9))
        floats.append(t.suggest_float("f", -1.5, 2.5))
        logs.append(t.suggest_float("lg", 1e-5, 1e-1, log=True))
        cats.append(t.suggest_categorical("c", ["a", "b", "c"]))
    assert all(isinstance(v, int) and 2 <= v <= 9 for v in ints)
    assert set(ints) == set(range(2, 10))
    assert all(-1.5 <= v <= 2.5 for v in floats)
    assert all(1e-5 <= v <= 1e-1 for v in logs)
    # log-uniform: the median near the geometric mean 1e-3, far from 0.05
    assert 2e-4 < float(np.median(logs)) < 5e-3
    assert set(cats) == {"a", "b", "c"}


def test_suggest_is_stable_within_a_trial():
    study = create_study(sampler=RandomSampler(seed=0))
    t = Trial(study, 0)
    v1 = t.suggest_float("lr", 1e-4, 1e-1, log=True)
    v2 = t.suggest_float("lr", 1e-4, 1e-1, log=True)
    assert v1 == v2
    assert t.suggest_loguniform("lr", 1e-4, 1e-1) == v1
    assert t.suggest_uniform("u", 0, 1) == t.params["u"]


def _run_study(sampler, n_trials=40):
    """A quadratic bowl at x = 0.31 with a log-scaled lr."""
    study = create_study(sampler=sampler)

    def objective(trial):
        x = trial.suggest_float("x", 0.0, 1.0)
        lr = trial.suggest_float("lr", 1e-5, 1e-1, log=True)
        return (x - 0.31) ** 2 + (math.log10(lr) - (-3)) ** 2 * 0.01

    study.optimize(objective, n_trials=n_trials)
    return study


def test_tpe_beats_random_on_toy_objective():
    tpe_tail, rnd_tail, tpe_best = [], [], []
    for seed in range(5):
        tpe = _run_study(TPESampler(seed=seed, n_startup_trials=10))
        rnd = _run_study(RandomSampler(seed=seed))
        tpe_tail += [t.value for t in tpe.get_trials()[10:]]
        rnd_tail += [t.value for t in rnd.get_trials()[10:]]
        tpe_best.append(min(t.value for t in tpe.get_trials()))
    assert float(np.mean(tpe_tail)) < float(np.mean(rnd_tail))
    assert float(np.median(tpe_best)) < 0.01


def test_tpe_categorical_prefers_good_choice():
    study = create_study(sampler=TPESampler(seed=1, n_startup_trials=8))

    def objective(trial):
        c = trial.suggest_categorical("c", ["good", "bad"])
        return 0.1 if c == "good" else 1.0

    study.optimize(objective, n_trials=60)
    tail = [t.params["c"] for t in study.get_trials()[20:]]
    assert tail.count("good") > tail.count("bad")


# ---------------------------------------------------------------------------------
# pruners
# ---------------------------------------------------------------------------------

def _completed_trial(study, number, curve):
    t = Trial(study, number)
    t.params = {"x": number}
    for step, v in enumerate(curve):
        t.intermediate_values[step] = v
    t.value = curve[-1]
    t.state = "COMPLETE"
    study._persist_trial(t)


def test_median_pruner_semantics():
    pruner = MedianPruner(n_startup_trials=2, n_warmup_steps=2, interval_steps=1)
    study = create_study(pruner=pruner)
    for n in range(3):
        _completed_trial(study, n, [1.0, 0.7, 0.5, 0.45])
    bad = Trial(study, 10)
    bad.intermediate_values = {0: 5.0}
    assert not pruner.prune(study, bad)
    bad.intermediate_values = {0: 5.0, 1: 5.0, 2: 5.0}
    assert pruner.prune(study, bad)
    good = Trial(study, 11)
    good.intermediate_values = {0: 1.0, 1: 0.6, 2: 0.3}
    assert not pruner.prune(study, good)


def test_median_pruner_interval_and_startup():
    pruner = MedianPruner(n_startup_trials=5, n_warmup_steps=2, interval_steps=3)
    study = create_study(pruner=pruner)
    for n in range(3):
        _completed_trial(study, n, [1.0, 0.7, 0.5])
    t = Trial(study, 9)
    t.intermediate_values = {0: 9.0, 1: 9.0, 2: 9.0}
    assert not pruner.prune(study, t)
    for n in range(3, 6):
        _completed_trial(study, n, [1.0, 0.7, 0.5])
    assert pruner.prune(study, t)
    t.intermediate_values[3] = 9.0
    assert not pruner.prune(study, t)


def test_nop_pruner_never_prunes():
    study = create_study(pruner=NopPruner())
    t = Trial(study, 0)
    t.intermediate_values = {i: 100.0 for i in range(20)}
    assert not t.should_prune()


def test_optimize_records_pruned_trials():
    study = create_study()

    def objective(trial):
        trial.report(1.0, 0)
        if trial.number % 2 == 0:
            raise TrialPruned()
        return 0.5

    study.optimize(objective, n_trials=4)
    assert [t.state for t in study.get_trials()] == ["PRUNED", "COMPLETE", "PRUNED",
                                                     "COMPLETE"]
    assert study.get_trials()[0].value == 1.0


# ---------------------------------------------------------------------------------
# sqlite persistence / resume
# ---------------------------------------------------------------------------------

def test_sqlite_persistence_and_resume(tmp_path):
    db = str(tmp_path / "study.db")
    storage = "sqlite:///" + db
    s1 = Study("exp", storage=storage, sampler=RandomSampler(seed=0))
    s1.optimize(lambda t: t.suggest_float("x", 0, 1) ** 2, n_trials=3)
    assert os.path.exists(db)
    assert len(s1.get_trials()) == 3
    s2 = Study("exp", storage=storage, sampler=RandomSampler(seed=1), load_if_exists=True)
    assert len(s2.get_trials()) == 3
    s2.optimize(lambda t: t.suggest_float("x", 0, 1) ** 2, n_trials=2)
    trials = s2.get_trials()
    assert [t.number for t in trials] == [0, 1, 2, 3, 4]
    assert all(t.state == "COMPLETE" for t in trials)
    assert all("x" in t.params for t in trials)
    assert s2.best_trial.value == min(t.value for t in trials)
    with pytest.raises(RuntimeError):
        Study("exp", storage=storage, load_if_exists=False)


def test_optunadb_reader(tmp_path):
    db = str(tmp_path / "study.db")
    s = Study("exp", storage="sqlite:///" + db, sampler=RandomSampler(seed=3))
    values = iter([0.5, 0.1, 0.9, 0.3])
    s.optimize(lambda t: next(values), n_trials=4)
    reader = OptunaDB(db)
    assert reader.get_best_trial() == 1
    assert reader.get_top_trials(2) == [(1, 0.1), (3, 0.3)]
    reader.close()


def test_sqlite_storage_isolates_studies(tmp_path):
    db = f"sqlite:///{tmp_path}/shared.db"
    a = create_study(study_name="A", storage=db, load_if_exists=True)
    b = create_study(study_name="B", storage=db, load_if_exists=True)
    a.optimize(lambda t: 1.25 + t.suggest_float("x", 0, 1) * 0, n_trials=1)
    b.optimize(lambda t: 2.5 + t.suggest_float("x", 0, 1) * 0, n_trials=1)
    a2 = create_study(study_name="A", storage=db, load_if_exists=True)
    b2 = create_study(study_name="B", storage=db, load_if_exists=True)
    assert [t.value for t in a2.get_trials()] == [1.25]
    assert [t.value for t in b2.get_trials()] == [2.5]


def test_sqlite_storage_migrates_old_schema(tmp_path):
    path = str(tmp_path / "old.db")
    conn = sqlite3.connect(path)
    conn.execute("""CREATE TABLE trials (
                        number INTEGER PRIMARY KEY, study_name TEXT, state TEXT,
                        value REAL, params TEXT, intermediate TEXT,
                        datetime_start TEXT, datetime_complete TEXT)""")
    conn.execute("INSERT INTO trials VALUES (0, 'old', 'COMPLETE', 3.5, '{}', '{}', NULL, "
                 "NULL)")
    conn.commit()
    conn.close()
    s = create_study(study_name="old", storage=f"sqlite:///{path}", load_if_exists=True)
    trials = s.get_trials()
    assert len(trials) == 1 and trials[0].value == 3.5
    s.optimize(lambda t: 1.0 + t.suggest_float("x", 0, 1) * 0, n_trials=1)
    assert sorted(t.value for t in s.get_trials()) == [1.0, 3.5]


def test_concurrent_trial_reservation_no_clobber(tmp_path):
    """Two handles on one sqlite file never take the same trial number."""
    storage = "sqlite:///" + str(tmp_path / "study.db")
    a = Study("exp", storage=storage, sampler=RandomSampler(seed=0))
    b = Study("exp", storage=storage, sampler=RandomSampler(seed=1), load_if_exists=True)
    ta0, tb0, ta1, tb1 = (a._reserve_trial(), b._reserve_trial(), a._reserve_trial(),
                          b._reserve_trial())
    numbers = [t.number for t in (ta0, tb0, ta1, tb1)]
    assert len(set(numbers)) == 4, numbers
    for t, v in ((tb1, 4.0), (ta0, 1.0), (tb0, 2.0), (ta1, 3.0)):
        t.value, t.state = v, "COMPLETE"
        t.study._persist_trial(t)
    trials = a.get_trials()
    assert sorted(t.number for t in trials) == sorted(numbers)
    assert sorted(t.value for t in trials) == [1.0, 2.0, 3.0, 4.0]
    assert all(t.state == "COMPLETE" for t in trials)


# ---------------------------------------------------------------------------------
# ModelOptimization config-path semantics
# ---------------------------------------------------------------------------------

def _mo_dict(tmp_path):
    return {
        "run_config": {"exp_name": "hpo_exp", "run_class": "LitPSD", "imports": []},
        "system_config": {"model_name": "hpo_m", "n_samples": 8, "n_type": 2,
                          "type_names": ["a", "b"],
                          "model_base_path": str(tmp_path / "model"),
                          "gpu_enabled": False, "half_precision": 0},
        "net_config": {"criterion_class": "CrossEntropyLoss", "criterion_params": [],
                       "imports": [], "net_class": "DenseConvNet",
                       "net_type": "2DConvolution",
                       "hparams": {"n_conv": 1, "n_lin": 1, "out_planes": 2,
                                   "conv_params": {"size_factor": 3, "pad_factor": 1.0}}},
        "optimize_config": {"total_epoch": 2, "lr": 0.05, "validation_freq": 1,
                            "imports": [], "optimizer_class": "optim.SGD",
                            "optimizer_params": {"momentum": 0.9},
                            "scheduler_class": "lr_scheduler.ExponentialLR",
                            "scheduler_params": {"gamma": 0.97}},
        "dataset_config": {"mode": "path", "imports": [],
                           "base_path": str(tmp_path / "data"),
                           "paths": ["a", "b"], "dataset_class": "PulseDataset2D",
                           "dataset_params": {},
                           "dataloader_params": {"batch_size": 1, "num_workers": 0},
                           "n_train": 30, "n_validate": 20, "n_test": 20},
    }


def test_modify_config_path_addressing(tmp_path):
    cfg = Config(_mo_dict(tmp_path))
    opt = Config({"hyperparameters": {
        "/optimize_config/lr": [1e-4, 1e-1],
        "/optimize_config/optimizer_params/momentum": [0.5, 0.99],
        "/net_config/hparams/out_planes": [2, 8],
        "/net_config/hparams/n_lin": [1, 2, 3],
        "/optimize_config/optimizer_params/nesterov": True,
        "/net_config/hparams/n_conv": {"val": [1, 2]},
    }})
    mo = ModelOptimization(opt, cfg, str(tmp_path / "model"))
    trial = Trial(create_study(sampler=RandomSampler(seed=0)), 0)
    mo.modify_config(trial)
    assert 1e-4 <= cfg.optimize_config.lr <= 1e-1
    assert 0.5 <= cfg.optimize_config.optimizer_params.momentum <= 0.99
    assert cfg.net_config.hparams.out_planes in range(2, 9)
    assert cfg.net_config.hparams.n_lin in (1, 2, 3)
    assert isinstance(cfg.optimize_config.optimizer_params.nesterov, bool)
    assert cfg.net_config.hparams.n_conv in (1, 2)
    assert trial.params["lr"] == cfg.optimize_config.lr
    with pytest.raises(IOError):
        ModelOptimization(Config({"hyperparameters": {"/no_such/section": [0, 1]}}), cfg,
                          str(tmp_path / "model"))
    with pytest.raises(IOError):
        ModelOptimization(Config({}), cfg, str(tmp_path / "model"))
    mo2 = ModelOptimization(Config({"hyperparameters": {"/optimize_config/lr": {"min": 0}}}),
                            cfg, str(tmp_path / "model"))
    with pytest.raises(ValueError):
        mo2.modify_config(Trial(create_study(), 1))


def test_modify_config_colliding_leaf_names(tmp_path):
    """Two paths sharing a leaf sample independently, each named by its
    path."""
    cfg = Config({
        "run_config": {"exp_name": "c", "run_class": "LitPSD", "imports": []},
        "system_config": {"model_name": "c", "n_samples": 8, "n_type": 2,
                          "type_names": ["a"], "model_base_path": str(tmp_path),
                          "gpu_enabled": False, "half_precision": 0},
        "net_config": {"dropout": 0.0, "imports": []},
        "optimize_config": {"dropout": 0.0, "lr": 0.01, "imports": [], "total_epoch": 1,
                            "validation_freq": 1, "optimizer_class": "optim.SGD",
                            "optimizer_params": {}},
        "dataset_config": {"mode": "path", "imports": [], "paths": ["a"],
                           "dataset_class": "PulseDataset2D", "dataset_params": {},
                           "n_train": 2},
    })
    opt = Config({"hyperparameters": {"/net_config/dropout": [0.0, 0.1],
                                      "/optimize_config/dropout": [0.8, 0.9]}})
    mo = ModelOptimization(opt, cfg, str(tmp_path / "model"))
    trial = Trial(create_study(sampler=RandomSampler(seed=0)), 0)
    mo.modify_config(trial)
    assert 0.0 <= cfg.net_config.dropout <= 0.1
    assert 0.8 <= cfg.optimize_config.dropout <= 0.9
    assert set(trial.params) == {"/net_config/dropout", "/optimize_config/dropout"}


# ---------------------------------------------------------------------------------
# e2e: python -m waveformml_tpu_torch.main <cfg> -oc <opt.json> -p
# ---------------------------------------------------------------------------------

def _write_study_inputs(tmp_path, seed, n_trials):
    cfg_path = str(tmp_path / "config.json")
    if not os.path.exists(cfg_path):
        from waveformml_tpu_torch.datasets.synthetic import write_classification_dirs

        write_classification_dirs(str(tmp_path / "data"), ["a", "b"], n_files=3,
                                  events_per_file=30, n_samples=8, seed=0)
        with open(cfg_path, "w") as f:
            json.dump(_mo_dict(tmp_path), f)
    opt_path = str(tmp_path / "opt.json")
    with open(opt_path, "w") as f:
        json.dump({"hyperparameters": {"/optimize_config/lr": [1e-3, 1e-1]},
                   "sampler": "RandomSampler", "sampler_params": {"seed": seed},
                   "optimize_args": {"n_trials": n_trials}}, f)
    return cfg_path, opt_path


def test_hpo_end_to_end_via_main(tmp_path):
    from waveformml_tpu_torch import main as cli
    from waveformml_tpu_torch.utils.util import retrieve_best_checkpoint

    cfg_path, opt_path = _write_study_inputs(tmp_path, seed=0, n_trials=3)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "waveformml_tpu_torch.main", cfg_path, "-oc", opt_path, "-p",
         "--max_epochs", "2", "--device", "cpu"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=600,
        env={**env, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    study_dir = os.path.join(str(tmp_path / "model"), "hpo_m", "studies", "hpo_exp")
    assert os.path.exists(os.path.join(study_dir, "study.db"))
    with open(os.path.join(study_dir, "trial_results.json")) as f:
        results = json.load(f)
    assert results["n_finished_trials"] == 3
    assert math.isfinite(results["best_trial"])
    assert "lr" in results["best_trial_params"]
    reader = OptunaDB(os.path.join(study_dir, "study.db"))
    best_n = reader.get_best_trial()
    reader.close()
    trial_dir = os.path.join(study_dir, f"trial_{best_n}")
    with open(os.path.join(trial_dir, "config.json")) as f:
        saved = json.load(f)
    assert saved["optimize_config"]["lr"] == results["best_trial_params"]["lr"]
    assert retrieve_best_checkpoint(trial_dir) is not None
    assert os.path.isfile(os.path.join(study_dir, "run_info.json"))

    # resume: 2 more trials continue the numbering in the db
    cfg_path, opt_path = _write_study_inputs(tmp_path, seed=1, n_trials=2)
    assert cli.main([cfg_path, "-oc", opt_path, "--max_epochs", "1", "--device", "cpu"]) == 0
    reader = OptunaDB(os.path.join(study_dir, "study.db"))
    top = reader.get_top_trials(10)
    reader.close()
    assert len(top) == 5
    assert sorted(n for n, _ in top) == [0, 1, 2, 3, 4]


def test_main_refuses_study_with_distributed(tmp_path):
    from waveformml_tpu_torch import main as cli

    cfg_path, opt_path = _write_study_inputs(tmp_path, seed=0, n_trials=1)
    with pytest.raises(SystemExit, match="drop --distributed"):
        cli.main([cfg_path, "-oc", opt_path, "--distributed", "--device", "cpu"])


# ---------------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------------

def _toy_objective(pruned):
    """Four kinds of parameter, an intermediate value reported each of 5
    steps and the pruner asked after each (``pruned``: the package's
    TrialPruned)."""
    def objective(trial):
        x = trial.suggest_float("x", 0.0, 1.0)
        lr = trial.suggest_float("lr", 1e-5, 1e-1, log=True)
        n = trial.suggest_int("n", 1, 4)
        c = trial.suggest_categorical("c", ["a", "b", "c"])
        base = (x - 0.31) ** 2 + 0.01 * (math.log10(lr) + 3) ** 2 + 0.1 * n \
            + (0.2 if c == "b" else 0.0)
        for step in range(5):
            trial.report(base + 1.0 / (step + 1), step)
            if trial.should_prune():
                raise pruned()
        return base
    return objective


def _frozen(study):
    return [(t.number, t.state, t.value, t.params, t.intermediate_values)
            for t in study.get_trials()]


@pytest.mark.parametrize("storage", ["memory", "sqlite"])
@pytest.mark.parametrize("sampler", ["TPESampler", "RandomSampler"])
def test_study_matches_jax(tmp_path, sampler, storage):
    """The same seeds give the same 12 trials in both packages: params,
    states, values and intermediate values, exactly."""
    from waveformml_tpu.optimization import hpo as jhpo

    params = {"seed": 3} if sampler == "RandomSampler" else {"seed": 3, "n_startup_trials": 4}
    studies = []
    for mod, tag in ((jhpo, "jax"), (hpo, "port")):
        url = f"sqlite:///{tmp_path}/{tag}.db" if storage == "sqlite" else None
        study = mod.create_study(
            study_name="toy", storage=url, sampler=mod.SAMPLERS[sampler](**params),
            pruner=mod.MedianPruner(n_startup_trials=2, n_warmup_steps=1, interval_steps=1))
        study.optimize(_toy_objective(mod.TrialPruned), n_trials=12)
        studies.append(_frozen(study))
    assert studies[0] == studies[1]
    states = [s for _, s, _, _, _ in studies[1]]
    assert "PRUNED" in states and "COMPLETE" in states, states


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_study_db_read_by_both_packages(tmp_path, writer):
    from waveformml_tpu.optimization import hpo as jhpo

    mod = jhpo if writer == "jax" else hpo
    path = str(tmp_path / "study.db")
    study = mod.create_study(study_name="s", storage="sqlite:///" + path,
                             sampler=mod.RandomSampler(seed=5),
                             pruner=mod.MedianPruner(n_startup_trials=1, n_warmup_steps=1,
                                                     interval_steps=1))
    study.optimize(_toy_objective(mod.TrialPruned), n_trials=8)
    readers = [jhpo.OptunaDB(path), hpo.OptunaDB(path)]
    try:
        best = [r.get_best_trial() for r in readers]
        top = [r.get_top_trials(5) for r in readers]
    finally:
        for r in readers:
            r.close()
    assert best[0] == best[1] is not None
    assert top[0] == top[1] and len(top[1]) >= 2
    # and each package's Study resumes the other's trials
    other = hpo if writer == "jax" else jhpo
    resumed = other.create_study(study_name="s", storage="sqlite:///" + path)
    assert _frozen(resumed) == _frozen(study)


class _Blocks:
    """An in-memory data module for the JAX Trainer (lists of blocks)."""

    def __init__(self, train, val):
        self.train, self.val = train, val

    def setup(self, stage=None):
        pass

    def train_dataloader(self):
        return self.train

    def val_dataloader(self):
        return self.val

    def test_dataloader(self):
        return self.val


def _pruning_study(mod):
    """A study whose one completed peer reported -1 at every step: a trial
    is pruned at its first report past the warm-up step."""
    study = mod.create_study(pruner=mod.MedianPruner(n_startup_trials=1, n_warmup_steps=1,
                                                     interval_steps=1))
    peer = mod.Trial(study, 0)
    peer.intermediate_values = {s: -1.0 for s in range(6)}
    peer.value, peer.state = -1.0, "COMPLETE"
    study._persist_trial(peer)
    return study, mod.Trial(study, 1)


def test_trial_prune_check_prunes_at_the_jax_epoch(tmp_path):
    """The port's Trainer reports each validation's val_loss to the task's
    trial and raises TrialPruned at the epoch the JAX Trainer does."""
    import jax
    from flax.traverse_util import flatten_dict
    from test_torch_trainer import CFG, _blocks

    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.datasets.hdf5_dataset import FileBlock as JaxFileBlock
    from waveformml_tpu.engineering.tasks import LitPSD as JaxLitPSD
    from waveformml_tpu.engineering.trainer import Trainer as JaxTrainer
    from waveformml_tpu.optimization import hpo as jhpo
    from waveformml_tpu.parallel.mesh import make_mesh

    from waveformml_tpu_torch.convert import flax_to_state_dict
    from waveformml_tpu_torch.datasets.synthetic import BlockDataModule
    from waveformml_tpu_torch.engineering.tasks import LitPSD
    from waveformml_tpu_torch.engineering.trainer import Trainer

    rng = np.random.default_rng(11)
    train, val = _blocks(rng, 3), _blocks(rng, 1)
    jtrain = [JaxFileBlock(b.coords, b.feats, b.labels, {}) for b in train]
    _, jtrial = _pruning_study(jhpo)
    jcfg = JaxConfig(copy.deepcopy(CFG))
    jtrainer = JaxTrainer(jcfg, JaxLitPSD(jcfg, jtrial), mesh=make_mesh(jax.devices()[:1]),
                          max_epochs=4, checkpoint_dir=str(tmp_path / "jax"))
    jtrainer._ensure_state(jtrain[0])
    flat = flatten_dict(jax.device_get({"params": jtrainer.state.params,
                                        "batch_stats": jtrainer.state.batch_stats}), sep="/")
    init = flax_to_state_dict({k: np.asarray(v) for k, v in flat.items()})
    with pytest.raises(jhpo.TrialPruned):
        jtrainer.fit(_Blocks(jtrain, [JaxFileBlock(b.coords, b.feats, b.labels, {})
                                      for b in val]))

    _, trial = _pruning_study(hpo)
    cfg = Config(copy.deepcopy(CFG))
    task = LitPSD(cfg, "cpu", trial=trial)
    task.model.load_state_dict(init)
    assert task.trial is trial
    trainer = Trainer(cfg, task, "cpu", max_epochs=4, checkpoint_dir=str(tmp_path / "port"))
    with pytest.raises(TrialPruned):
        trainer.fit(BlockDataModule(train, val))
    assert sorted(trial.intermediate_values) == sorted(jtrial.intermediate_values) == [0, 1]
    assert trainer.current_epoch == jtrainer.current_epoch == 1
    for step, v in trial.intermediate_values.items():
        np.testing.assert_allclose(v, jtrial.intermediate_values[step], rtol=2e-3, atol=2e-4)


def _failing_objective(tmp_path, monkeypatch, trainer_module, error):
    """Write the study's data, patch ``trainer_module.Trainer.fit`` to raise
    ``error`` (or to call it, where it is a function that raises)."""
    from waveformml_tpu_torch.datasets.synthetic import write_classification_dirs

    write_classification_dirs(str(tmp_path / "data"), ["a", "b"], n_files=3,
                              events_per_file=10, n_samples=8, seed=0)

    def fit(self, data_module):
        if callable(error):
            error()
        raise error

    monkeypatch.setattr(trainer_module.Trainer, "fit", fit)


def test_runtime_error_fails_the_trial_as_in_jax(tmp_path, monkeypatch):
    """An objective's RuntimeError (not a CUDA fault) is a FAIL trial with
    value None in both packages, and the study goes on."""
    monkeypatch.syspath_prepend(ROOT)
    from waveformml_tpu.config import Config as JaxConfig
    from waveformml_tpu.engineering import trainer as jtrainer_mod
    from waveformml_tpu.optimization import hpo as jhpo

    from waveformml_tpu_torch.engineering import trainer as trainer_mod

    _failing_objective(tmp_path, monkeypatch, jtrainer_mod, RuntimeError("boom"))
    _failing_objective(tmp_path, monkeypatch, trainer_mod, RuntimeError("boom"))
    opt = {"hyperparameters": {"/optimize_config/lr": [1e-3, 1e-1]},
           "sampler": "RandomSampler", "sampler_params": {"seed": 0},
           "optimize_args": {"n_trials": 2}}
    got = []
    for mod, config_cls, args in ((jhpo, JaxConfig, {}), (hpo, Config, {"device": "cpu"})):
        d = _mo_dict(tmp_path)
        d["system_config"]["model_base_path"] = str(tmp_path / f"model_{mod.__name__}")
        mo = mod.ModelOptimization(config_cls(copy.deepcopy(opt)), config_cls(d),
                                   d["system_config"]["model_base_path"], trainer_args=args)
        got.append([(t.state, t.value) for t in mo.run_study().get_trials()])
    assert got[0] == got[1] == [("FAIL", None), ("FAIL", None)]


class _FaultedLibrary:
    """A loaded kernel library, as ``native.check_launch`` reads it."""

    @staticmethod
    def wf_cuda_error_string(err):
        return b"an illegal memory access was encountered"


@pytest.mark.parametrize("kind", ["accelerator_error", "kernel_launch_error",
                                  "kernel_build_failed", "nvcc_not_found", "out_of_memory"])
def test_cuda_fault_stops_the_study(tmp_path, monkeypatch, kind):
    """A CUDA fault other than running out of memory is raised out of the
    study (its trial left RUNNING, no later trial started): a CUDA error, a
    kernel's failed launch, and a kernel that does not build at its first
    launch inside a trial. Running out of memory is a FAIL trial and the
    study goes on."""
    import shutil

    from waveformml_tpu_torch.engineering import trainer as trainer_mod
    from waveformml_tpu_torch.ops import native

    if kind == "kernel_build_failed":
        # a compiler that fails every build, and no library built yet
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(native, "_nvcc", lambda: shutil.which("false"))
    if kind == "nvcc_not_found":
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
        monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    monkeypatch.setattr(native, "_LIBS", {})

    def first_launch():
        native.load("row_conv", {})

    error = {"accelerator_error": torch.AcceleratorError(
                 "CUDA error: an illegal memory access was encountered"),
             "kernel_launch_error": lambda: native.check_launch(
                 _FaultedLibrary, 700, "subm_conv_rows"),
             "kernel_build_failed": first_launch,
             "nvcc_not_found": first_launch,
             "out_of_memory": torch.OutOfMemoryError("CUDA out of memory.")}[kind]
    _failing_objective(tmp_path, monkeypatch, trainer_mod, error)
    opt = Config({"hyperparameters": {"/optimize_config/lr": [1e-3, 1e-1]},
                  "optimize_args": {"n_trials": 3}})
    mo = ModelOptimization(opt, Config(_mo_dict(tmp_path)), str(tmp_path / "model"),
                           trainer_args={"device": "cpu"})
    if kind == "out_of_memory":
        assert not is_cuda_fault(error)
        states = [(t.state, t.value) for t in mo.run_study().get_trials()]
        assert states == [("FAIL", None)] * 3
        return
    expected = torch.AcceleratorError if kind == "accelerator_error" else native.KernelError
    with pytest.raises(expected) as raised:
        mo.run_study()
    assert is_cuda_fault(raised.value)
    study = create_study(study_name="hpo_exp", storage=mo.connstr)
    assert [(t.number, t.state) for t in study.get_trials()] == [(0, "RUNNING")]


def test_objective_frees_the_trial(tmp_path, monkeypatch):
    """A trial's config.json and its best val_loss, and no reference to its
    Trainer kept once the objective has returned or raised TrialPruned."""
    import weakref

    from waveformml_tpu_torch.datasets.synthetic import BlockDataModule, labelled_block
    from waveformml_tpu_torch.engineering import trainer as trainer_mod

    rng = np.random.default_rng(3)
    train = [labelled_block(rng, 16, 8) for _ in range(2)]
    val = [labelled_block(rng, 16, 8)]
    made = []
    original = trainer_mod.Trainer.__init__

    def init(self, *a, **k):
        original(self, *a, **k)
        made.append(weakref.ref(self))

    monkeypatch.setattr(trainer_mod.Trainer, "__init__", init)
    # trial 1 is pruned at its first validation
    monkeypatch.setattr(NopPruner, "prune", lambda self, study, trial: trial.number == 1)
    opt = Config({"hyperparameters": {"/optimize_config/lr": [1e-3, 1e-1]},
                  "optimize_args": {"n_trials": 3}})
    mo = ModelOptimization(opt, Config(_mo_dict(tmp_path)), str(tmp_path / "model"),
                           trainer_args={"device": "cpu", "max_epochs": 1},
                           data_module=BlockDataModule(train, val))
    alive = []
    objective = mo.objective

    def checked(trial):
        try:
            return objective(trial)
        finally:
            # before the study has handled the objective's return or raise
            alive.append([ref() is not None for ref in made])

    mo.objective = checked
    study = mo.run_study()
    assert alive == [[False], [False, False], [False, False, False]]
    assert [t.state for t in study.get_trials()] == ["COMPLETE", "PRUNED", "COMPLETE"]
    for t in study.get_trials():
        assert math.isfinite(t.value)
        with open(os.path.join(mo.study_dir, f"trial_{t.number}", "config.json")) as f:
            assert json.load(f)["optimize_config"]["lr"] == t.params["lr"]


EXAMPLES = ("SubMPSD", "SubMPSD_w128", "DensePSD", "GEP", "IoniClassifierCNN", "OPs3ns_SCNet",
            "SCNet3D", "SegQuantifier", "SingleEndedZCNN", "SingleWaveformRNN",
            "SingleWaveformTCN")


@pytest.mark.parametrize("name", EXAMPLES)
def test_tasks_take_a_trial_and_keep_the_config(name):
    """Each example config's task holds the trial it is given, and a
    second task built from the same config (the next trial's) leaves the
    config as the first left it."""
    from waveformml_tpu_torch.config import load_config, to_dict
    from waveformml_tpu_torch.registry import retrieve_class

    cfg = load_config(os.path.join(ROOT, "config", "examples", f"{name}.json"))
    cls = retrieve_class(cfg.run_config.run_class)
    trial = Trial(create_study(), 0)
    first = cls(cfg, "cpu", trial=trial)
    assert first.trial is trial
    after_first = copy.deepcopy(to_dict(cfg))
    second = cls(cfg, "cpu", trial=None)
    assert second.trial is None
    assert to_dict(cfg) == after_first
    assert [p.shape for p in first.model.parameters()] == \
        [p.shape for p in second.model.parameters()]
