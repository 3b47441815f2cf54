"""Hyperparameter optimization (the port's copy of
waveformml_tpu/optimization/hpo.py): an Optuna-API-compatible subset with
its own samplers, pruners and sqlite storage, and ``ModelOptimization``,
which trains one model per trial with the port's ``Trainer``.

``Study``/``Trial`` give the ``suggest_*`` API, sqlite persistence (a
``trials`` table keyed on (study_name, number), readable by ``OptunaDB``
and by the JAX package's reader; older single-key tables are migrated in
place), ``load_if_exists`` resume and race-free trial numbers across
processes; ``RandomSampler`` and ``TPESampler`` draw what the JAX package's
draw for the same seed and history; ``MedianPruner`` and ``NopPruner``.
``ModelOptimization`` addresses hyperparameters by config path
("/optimize_config/optimizer_params/lr"), writes each trial's
``config.json``, checkpoint and logger under ``trial_<n>/`` and the study's
``study.db`` and ``trial_results.json`` under
``<model folder>/studies/<exp_name>/``.

One rule differs from the JAX package: an objective's ``RuntimeError`` is
a failed trial (value None) there, but on the card a CUDA fault other than
running out of memory (``torch.AcceleratorError``) leaves the CUDA context
unusable, and a kernel that does not build or launch
(``ops.native.KernelError``) fails the same way in every trial, so every
later trial would fail too. The port counts ``torch.OutOfMemoryError`` as a
failed trial and raises any other CUDA error, which stops the study.
"""
from __future__ import annotations

import gc
import json
import logging
import math
import os
import random
import sqlite3
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)


class TrialPruned(Exception):
    """Raised inside an objective to end a trial early (optuna.TrialPruned)."""


# ---------------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------------

class RandomSampler:
    def __init__(self, seed: Optional[int] = None):
        self.rng = random.Random(seed)

    def suggest(self, study: "Study", name: str, dist: Dict[str, Any]) -> Any:
        kind = dist["kind"]
        if kind == "int":
            return self.rng.randint(dist["low"], dist["high"])
        if kind == "float":
            return self.rng.uniform(dist["low"], dist["high"])
        if kind == "logfloat":
            return math.exp(self.rng.uniform(math.log(dist["low"]),
                                             math.log(dist["high"])))
        if kind == "categorical":
            return self.rng.choice(dist["choices"])
        raise ValueError(kind)


class TPESampler(RandomSampler):
    """Lightweight Tree-structured Parzen Estimator.

    After ``n_startup_trials`` random trials, numeric parameters are sampled
    from a KDE over the best-γ fraction of completed trials, scored by the
    good/bad density ratio; categoricals use weighted frequencies.
    """

    def __init__(self, seed: Optional[int] = None, n_startup_trials: int = 10,
                 gamma: float = 0.25, n_candidates: int = 24):
        super().__init__(seed)
        self.n_startup_trials = n_startup_trials
        self.gamma = gamma
        self.n_candidates = n_candidates

    def suggest(self, study: "Study", name: str, dist: Dict[str, Any]) -> Any:
        history = [(t.params[name], t.value) for t in study.get_trials()
                   if t.state == "COMPLETE" and name in t.params
                   and t.value is not None]
        if len(history) < self.n_startup_trials:
            return super().suggest(study, name, dist)
        history.sort(key=lambda kv: kv[1] if study.direction == "minimize" else -kv[1])
        n_good = max(1, int(round(self.gamma * len(history))))
        good = [h[0] for h in history[:n_good]]
        bad = [h[0] for h in history[n_good:]] or good
        kind = dist["kind"]
        if kind == "categorical":
            choices = dist["choices"]
            weights = [1.0 + sum(1 for g in good if g == c) for c in choices]
            return self.rng.choices(choices, weights=weights, k=1)[0]
        logspace = kind == "logfloat"

        def to_x(v):
            return math.log(v) if logspace else float(v)

        lo, hi = to_x(dist["low"]), to_x(dist["high"])
        width = max(1e-12, (hi - lo))
        bw = max(width / 6.0, width * 1.06 * len(good) ** -0.2 / 4)

        def density(x, pts):
            return sum(math.exp(-0.5 * ((x - to_x(p)) / bw) ** 2) for p in pts) \
                / (len(pts) * bw) + 1e-12

        best_x, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            center = to_x(self.rng.choice(good))
            x = min(hi, max(lo, self.rng.gauss(center, bw)))
            score = density(x, good) / density(x, bad)
            if score > best_score:
                best_x, best_score = x, score
        v = math.exp(best_x) if logspace else best_x
        if kind == "int":
            v = int(round(v))
            v = min(dist["high"], max(dist["low"], v))
        return v


# ---------------------------------------------------------------------------------
# pruners
# ---------------------------------------------------------------------------------

class NopPruner:
    def prune(self, study: "Study", trial: "Trial") -> bool:
        return False


class MedianPruner:
    """Prune when the trial's intermediate value is worse than the median of
    completed trials at the same step (ref defaults: n_warmup_steps=10,
    interval_steps=3 — ModelOptimization.py:235-236)."""

    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 10,
                 interval_steps: int = 3):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps
        self.interval_steps = interval_steps

    def prune(self, study: "Study", trial: "Trial") -> bool:
        if not trial.intermediate_values:
            return False
        step = max(trial.intermediate_values)
        if step < self.n_warmup_steps:
            return False
        if (step - self.n_warmup_steps) % self.interval_steps != 0:
            return False
        completed = [t for t in study.get_trials()
                     if t.state in ("COMPLETE", "PRUNED") and t.number != trial.number]
        if len(completed) < self.n_startup_trials:
            return False
        peers = []
        for t in completed:
            vals = [v for s, v in t.intermediate_values.items() if s <= step]
            if vals:
                peers.append(min(vals) if study.direction == "minimize" else max(vals))
        if not peers:
            return False
        median = float(np.median(peers))
        current = trial.intermediate_values[step]
        return current > median if study.direction == "minimize" else current < median


# ---------------------------------------------------------------------------------
# trial / study / storage
# ---------------------------------------------------------------------------------

class Trial:
    def __init__(self, study: "Study", number: int):
        self.study = study
        self.number = number
        self.params: Dict[str, Any] = {}
        self.intermediate_values: Dict[int, float] = {}
        self.value: Optional[float] = None
        self.state = "RUNNING"

    # -- suggest API ---------------------------------------------------------------
    def _suggest(self, name: str, dist: Dict[str, Any]) -> Any:
        if name in self.params:
            return self.params[name]
        v = self.study.sampler.suggest(self.study, name, dist)
        self.params[name] = v
        return v

    def suggest_int(self, name: str, low: int, high: int) -> int:
        return self._suggest(name, {"kind": "int", "low": low, "high": high})

    def suggest_float(self, name: str, low: float, high: float,
                      log: bool = False) -> float:
        kind = "logfloat" if log else "float"
        return self._suggest(name, {"kind": kind, "low": low, "high": high})

    def suggest_loguniform(self, name: str, low: float, high: float) -> float:
        return self.suggest_float(name, low, high, log=True)

    def suggest_uniform(self, name: str, low: float, high: float) -> float:
        return self.suggest_float(name, low, high)

    def suggest_categorical(self, name: str, choices: Sequence[Any]) -> Any:
        return self._suggest(name, {"kind": "categorical", "choices": list(choices)})

    # -- pruning API ---------------------------------------------------------------
    def report(self, value: float, step: int) -> None:
        self.intermediate_values[int(step)] = float(value)
        self.study._persist_trial(self)

    def should_prune(self) -> bool:
        return self.study.pruner.prune(self.study, self)


class FrozenTrial:
    def __init__(self, number, state, value, params, intermediate_values):
        self.number = number
        self.state = state
        self.value = value
        self.params = params
        self.intermediate_values = intermediate_values


class Study:
    def __init__(self, study_name: str, storage: Optional[str] = None,
                 direction: str = "minimize", sampler=None, pruner=None,
                 load_if_exists: bool = True):
        self.study_name = study_name
        self.direction = direction
        self.sampler = sampler or TPESampler()
        self.pruner = pruner or NopPruner()
        self._conn: Optional[sqlite3.Connection] = None
        if storage:
            path = storage[len("sqlite:///"):] if storage.startswith("sqlite:///") else storage
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._conn = sqlite3.connect(path)
            self._init_db()
            if not load_if_exists and self._count() > 0:
                raise RuntimeError(f"study {study_name} already exists")
        self._mem_trials: List[FrozenTrial] = []

    def _init_db(self) -> None:
        # composite key: `number` alone would let two studies sharing one
        # sqlite file upsert over each other's trials
        self._conn.execute(
            """CREATE TABLE IF NOT EXISTS trials (
                   number INTEGER,
                   study_name TEXT,
                   state TEXT,
                   value REAL,
                   params TEXT,
                   intermediate TEXT,
                   datetime_start TEXT,
                   datetime_complete TEXT,
                   PRIMARY KEY (study_name, number))""")
        # migrate pre-composite-PK databases (number INTEGER PRIMARY KEY):
        # sqlite cannot alter a PK in place, so rebuild the table once
        cur = self._conn.execute(
            "SELECT sql FROM sqlite_master WHERE type='table' AND name='trials'")
        row = cur.fetchone()
        if row and "PRIMARY KEY (study_name, number)" not in (row[0] or ""):
            self._conn.executescript(
                """BEGIN;
                   ALTER TABLE trials RENAME TO trials_old;
                   CREATE TABLE trials (
                       number INTEGER,
                       study_name TEXT,
                       state TEXT,
                       value REAL,
                       params TEXT,
                       intermediate TEXT,
                       datetime_start TEXT,
                       datetime_complete TEXT,
                       PRIMARY KEY (study_name, number));
                   INSERT INTO trials SELECT * FROM trials_old;
                   DROP TABLE trials_old;
                   COMMIT;""")
        self._conn.commit()

    def _count(self) -> int:
        cur = self._conn.execute(
            "SELECT COUNT(*) FROM trials WHERE study_name=?", (self.study_name,))
        return cur.fetchone()[0]

    def _next_number(self) -> int:
        if self._conn is not None:
            cur = self._conn.execute(
                "SELECT COALESCE(MAX(number), -1) FROM trials WHERE study_name=?",
                (self.study_name,))
            return cur.fetchone()[0] + 1
        return len(self._mem_trials)

    def _reserve_trial(self) -> "Trial":
        """Atomically allocate the next trial number. MAX+1 followed by an
        upsert would let two processes resuming one study claim the same
        number and silently clobber each other's finished trials; inserting
        the RUNNING row (no upsert) inside an IMMEDIATE transaction makes
        the losing claimant retry with the next number."""
        if self._conn is None:
            trial = Trial(self, len(self._mem_trials))
            self._persist_trial(trial)
            return trial
        while True:
            try:
                self._conn.execute("BEGIN IMMEDIATE")
                cur = self._conn.execute(
                    "SELECT COALESCE(MAX(number), -1) FROM trials "
                    "WHERE study_name=?", (self.study_name,))
                number = cur.fetchone()[0] + 1
                self._conn.execute(
                    "INSERT INTO trials (number, study_name, state, value, "
                    "params, intermediate, datetime_start, datetime_complete) "
                    "VALUES (?,?,?,?,?,?,?,NULL)",
                    (number, self.study_name, "RUNNING", None, "{}", "{}",
                     time.strftime("%Y-%m-%dT%H:%M:%S")))
                self._conn.commit()
                return Trial(self, number)
            except sqlite3.IntegrityError:
                self._conn.rollback()  # another process claimed this number
            except sqlite3.OperationalError:
                self._conn.rollback()  # database locked: back off and retry
                time.sleep(0.05)

    def _persist_trial(self, trial: Trial) -> None:
        frozen = FrozenTrial(trial.number, trial.state, trial.value,
                             dict(trial.params), dict(trial.intermediate_values))
        if self._conn is None:
            for i, t in enumerate(self._mem_trials):
                if t.number == trial.number:
                    self._mem_trials[i] = frozen
                    return
            self._mem_trials.append(frozen)
            return
        self._conn.execute(
            """INSERT INTO trials (number, study_name, state, value, params,
                                   intermediate, datetime_start, datetime_complete)
               VALUES (?,?,?,?,?,?,?,?)
               ON CONFLICT(study_name, number) DO UPDATE SET
                   state=excluded.state, value=excluded.value,
                   params=excluded.params, intermediate=excluded.intermediate,
                   datetime_complete=excluded.datetime_complete""",
            (trial.number, self.study_name, trial.state, trial.value,
             json.dumps(trial.params), json.dumps(trial.intermediate_values),
             time.strftime("%Y-%m-%dT%H:%M:%S"),
             time.strftime("%Y-%m-%dT%H:%M:%S") if trial.state != "RUNNING" else None))
        self._conn.commit()

    def get_trials(self) -> List[FrozenTrial]:
        if self._conn is None:
            return list(self._mem_trials)
        cur = self._conn.execute(
            "SELECT number, state, value, params, intermediate FROM trials "
            "WHERE study_name=? ORDER BY number", (self.study_name,))
        out = []
        for number, state, value, params, inter in cur.fetchall():
            out.append(FrozenTrial(number, state, value,
                                   json.loads(params or "{}"),
                                   {int(k): v for k, v in json.loads(inter or "{}").items()}))
        return out

    @property
    def trials(self) -> List[FrozenTrial]:
        return self.get_trials()

    @property
    def best_trial(self) -> FrozenTrial:
        done = [t for t in self.get_trials() if t.state == "COMPLETE" and t.value is not None]
        if not done:
            raise ValueError("no completed trials")
        key = (lambda t: t.value) if self.direction == "minimize" else (lambda t: -t.value)
        return min(done, key=key)

    def optimize(self, objective: Callable[[Trial], Optional[float]],
                 n_trials: int = 10, timeout: Optional[float] = None,
                 catch: Tuple = (), **_ignored) -> None:
        t_start = time.time()
        for _ in range(n_trials):
            if timeout is not None and time.time() - t_start > timeout:
                break
            trial = self._reserve_trial()
            try:
                value = objective(trial)
                trial.value = None if value is None else float(value)
                trial.state = "COMPLETE" if trial.value is not None else "FAIL"
            except TrialPruned:
                trial.state = "PRUNED"
                if trial.intermediate_values:
                    trial.value = trial.intermediate_values[max(trial.intermediate_values)]
                log.info("trial %d pruned", trial.number)
            except catch as e:  # explicitly allowed exceptions
                trial.state = "FAIL"
                log.warning("trial %d failed: %s", trial.number, e)
            self._persist_trial(trial)


def create_study(study_name: str = "study", storage: Optional[str] = None,
                 direction: str = "minimize", sampler=None, pruner=None,
                 load_if_exists: bool = True) -> Study:
    return Study(study_name, storage, direction, sampler, pruner, load_if_exists)


# registry of pruner/sampler names for configs (ref: ModelOptimization.py:237-249)
PRUNERS = {"MedianPruner": MedianPruner, "NopPruner": NopPruner}
SAMPLERS = {"TPESampler": TPESampler, "RandomSampler": RandomSampler}


# ---------------------------------------------------------------------------------
# OptunaDB reader (ref: src/utils/SQLUtils.py:67-81)
# ---------------------------------------------------------------------------------

class OptunaDB:
    """Read a study.db and retrieve the best trial number."""

    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)

    def get_best_trial(self) -> Optional[int]:
        cur = self.conn.execute(
            "SELECT number FROM trials WHERE state='COMPLETE' AND value IS NOT NULL "
            "ORDER BY value ASC LIMIT 1")
        row = cur.fetchone()
        return row[0] if row else None

    def get_top_trials(self, n: int = 5) -> List[Tuple[int, float]]:
        cur = self.conn.execute(
            "SELECT number, value FROM trials WHERE state='COMPLETE' AND value "
            "IS NOT NULL ORDER BY value ASC LIMIT ?", (n,))
        return cur.fetchall()

    def close(self) -> None:
        self.conn.close()


# ---------------------------------------------------------------------------------
# ModelOptimization: one training run a trial (ref: ModelOptimization.py:98-273)
# ---------------------------------------------------------------------------------

def is_cuda_fault(error: BaseException) -> bool:
    """Whether an exception reports a CUDA fault other than running out of
    memory: a ``torch.AcceleratorError``, or a kernel that did not build or
    whose launch failed (``ops.native.KernelError``)."""
    import torch

    from waveformml_tpu_torch.ops.native import KernelError

    faults = (KernelError, getattr(torch, "AcceleratorError", KernelError))
    return isinstance(error, faults) and not isinstance(error, torch.OutOfMemoryError)


class ModelOptimization:
    """Config-path-addressed hyperparameter search over the train loop.

    ``trainer_args`` are the port's ``Trainer`` arguments (the CLI's
    ``Trainer.kwargs_from_args``; ``device`` also places each trial's
    task, None the card); the study sets its own early-stopping patience (5
    for ``LitZ``, else 4). ``data_module`` serves every trial where given;
    without it each trial builds the config's (``main.choose_data_module``).
    """

    def __init__(self, optuna_config, config, model_dir: str,
                 trainer_args: Optional[Dict[str, Any]] = None, data_module=None):
        from waveformml_tpu_torch.config import to_dict
        from waveformml_tpu_torch.utils.util import write_run_info

        self.optuna_config = optuna_config
        self.config = config
        self.model_dir = model_dir
        self.trainer_args = dict(trainer_args or {})
        self.data_module = data_module
        self.log = logging.getLogger(__name__)
        self.study_dir = os.path.join(model_dir, "studies",
                                      config.run_config.exp_name)
        os.makedirs(self.study_dir, exist_ok=True)
        self.study_name = getattr(optuna_config, "name", config.run_config.exp_name)
        self.connstr = "sqlite:///" + os.path.join(self.study_dir, "study.db")
        write_run_info(self.study_dir)
        if not hasattr(optuna_config, "hyperparameters"):
            raise IOError(
                "No hyperparameters found in optuna config. You must set the "
                "hyperparameters to a dictionary of key: value where key is the "
                "path to the hyperparameter in the config file, and value is an "
                "array of two elements bounding the range of the parameter")
        self.hyperparameters_bounds = to_dict(optuna_config.hyperparameters)
        self.hyperparameters: Dict[str, Any] = {}
        self._parse_config()

    def _parse_config(self) -> None:
        """Resolve each '/path/to/param' onto its parent config object
        (ref: ModelOptimization.py:125-148)."""
        for h in self.hyperparameters_bounds:
            parts = [p for p in h.split("/") if p]
            obj = self.config
            for name in parts[:-1]:
                if not hasattr(obj, name):
                    raise IOError(f"hyperparameter path not found: {name} in {h}")
                obj = getattr(obj, name)
            self.hyperparameters[h] = obj

    def modify_config(self, trial: Trial) -> None:
        """Apply suggest_* values onto the live config
        (ref: ModelOptimization.py:150-179)."""
        leaves = [h.split("/")[-1] for h in self.hyperparameters]
        for hp, parent in self.hyperparameters.items():
            leaf = hp.split("/")[-1]
            # the leaf names the parameter, as the reference does, unless two
            # paths share a leaf (/net_config/dropout and
            # /head_config/dropout): those are distinct parameters, each
            # named by its path (the reference collapses them into one)
            name = hp if leaves.count(leaf) > 1 else leaf
            bounds = self.hyperparameters_bounds[hp]
            if isinstance(bounds, bool):
                value = trial.suggest_int(name, 0, 1) == 1
            elif isinstance(bounds, dict):
                if "val" not in bounds:
                    raise ValueError(
                        f'Invalid format for hyperparameter key {hp}. Specify '
                        'category with "val":[list of values]')
                value = trial.suggest_categorical(name, bounds["val"])
            elif len(bounds) > 2:
                value = trial.suggest_categorical(name, bounds)
            elif isinstance(bounds[0], bool):
                value = trial.suggest_int(name, 0, 1) == 1
            elif isinstance(bounds[0], int) and isinstance(bounds[1], int):
                value = trial.suggest_int(name, bounds[0], bounds[1])
            else:
                lo, hi = float(bounds[0]), float(bounds[1])
                use_log = lo != 0 and hi != 0 and (hi / lo > 100 or lo / hi > 100)
                value = trial.suggest_float(name, lo, hi, log=use_log)
            setattr(parent, leaf, value)
            self.log.info("setting %s to %s", hp, value)

    def objective(self, trial: Trial) -> Optional[float]:
        """One training run (ref: ModelOptimization.py:181-232): the
        trial's config, task and ``Trainer`` under ``trial_<n>/``, fit, the
        best ``val_loss`` (None where it is not finite, or where the card
        ran out of memory). Any other CUDA error is raised. The trial's
        trainer, task and logger are released before it returns, so that
        device memory does not grow with the trials."""
        import torch

        from waveformml_tpu_torch.config import save_config
        from waveformml_tpu_torch.engineering.trainer import Trainer
        from waveformml_tpu_torch.main import _tb_logger, choose_data_module
        from waveformml_tpu_torch.registry import retrieve_class

        self.modify_config(trial)
        trial_dir = os.path.join(self.study_dir, f"trial_{trial.number}")
        os.makedirs(trial_dir, exist_ok=True)
        save_config(self.config, os.path.join(trial_dir, "config.json"))
        patience = 5 if self.config.run_config.run_class.endswith("LitZ") else 4
        args = dict(self.trainer_args)
        seed = args.pop("seed", 0) or 0
        # the study fixes its own per-task patience (ref :207-210)
        args.pop("early_stopping_patience", None)
        logger = _tb_logger(trial_dir, self.log)
        task = trainer = None
        loss, pruned = None, False
        try:
            task = retrieve_class(self.config.run_config.run_class)(
                self.config, args.get("device"), trial=trial)
            trainer = Trainer(self.config, task, logger=logger, checkpoint_dir=trial_dir,
                              early_stopping_patience=patience, seed=seed, **args)
            data_module = (self.data_module if self.data_module is not None
                           else choose_data_module(self.config))
            trainer.fit(data_module)
            loss = trainer.best_val_loss
        except TrialPruned:
            pruned = True
        except RuntimeError as e:
            if is_cuda_fault(e):
                raise
            self.log.info("Trial %d failed with error %s", trial.number, e)
        finally:
            if logger is not None:
                logger.close()
            device = trainer.device if trainer is not None else None
            task = trainer = None
            gc.collect()
            if device is not None and device.type == "cuda":
                torch.cuda.empty_cache()
        if pruned:
            # raised anew, so that no traceback keeps the trial's trainer
            raise TrialPruned()
        if loss is None or not math.isfinite(loss):
            return None
        self.log.info("best loss found for trial %d is %s", trial.number, loss)
        return loss

    def run_study(self, pruning: bool = False) -> Study:
        """(ref: ModelOptimization.py:234-273)"""
        from waveformml_tpu_torch.config import to_dict

        pruner = MedianPruner(n_warmup_steps=10, interval_steps=3) if pruning \
            else NopPruner()
        if hasattr(self.optuna_config, "pruner"):
            cls = PRUNERS[self.optuna_config.pruner]
            pruner = cls(**to_dict(getattr(self.optuna_config, "pruner_params", {}) or {}))
        sampler = None
        if hasattr(self.optuna_config, "sampler"):
            cls = SAMPLERS[self.optuna_config.sampler]
            sampler = cls(**to_dict(getattr(self.optuna_config, "sampler_params", {}) or {}))
        study = create_study(study_name=self.study_name, direction="minimize",
                             pruner=pruner, sampler=sampler, storage=self.connstr,
                             load_if_exists=True)
        optimize_args = to_dict(getattr(self.optuna_config, "optimize_args", {}) or {})
        study.optimize(self.objective, **optimize_args)
        out = {"n_finished_trials": len(study.trials)}
        try:
            best = study.best_trial
            out["best_trial"] = best.value
            out["best_trial_params"] = best.params
            self.log.info("Best trial: value=%s params=%s", best.value, best.params)
        except ValueError:
            self.log.warning("no completed trials")
        with open(os.path.join(self.study_dir, "trial_results.json"), "w") as f:
            json.dump(out, f, indent=2)
        return study
