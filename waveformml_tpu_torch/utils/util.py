"""Host helpers (the port's own copies of those of
waveformml_tpu/utils/util.py): logging, the model folder and the run
directories' names, file-name patterns, thread counts, the run's
provenance, checkpoint discovery, background prefetch, and the bins and
safe division of the evaluators."""
from __future__ import annotations

import getpass
import glob
import hashlib
import json
import logging
import os
import platform
import queue
import re
import subprocess
import sys
import threading
import time
from typing import Any, Dict, Iterable, Iterator, Optional, Sequence, TypeVar

import numpy as np

T = TypeVar("T")

#: CLI verbosity 0-5 → log level
_VERBOSITY_LEVELS = {0: logging.CRITICAL, 1: logging.ERROR, 2: logging.WARNING,
                     3: logging.INFO, 4: logging.DEBUG, 5: logging.DEBUG}


def setup_logger(verbosity: int = 3, logfile: Optional[str] = None,
                 name: str = "waveformml_tpu_torch") -> logging.Logger:
    """The package's logger at the level of ``verbosity``, writing to
    stdout and, with ``logfile``, to that file too; earlier handlers are
    dropped."""
    logger = logging.getLogger(name)
    logger.setLevel(_VERBOSITY_LEVELS.get(int(verbosity), logging.DEBUG))
    logger.handlers = []
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if logfile:
        os.makedirs(os.path.dirname(os.path.abspath(logfile)), exist_ok=True)
        fh = logging.FileHandler(logfile)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def get_logger(name: str = "waveformml_tpu_torch") -> logging.Logger:
    return logging.getLogger(name)


def get_model_folder(config) -> str:
    """``<model_base_path>/<model_name>`` (``./model`` without a base
    path), created where missing."""
    base = getattr(config.system_config, "model_base_path", "./model")
    folder = os.path.join(base, config.system_config.model_name)
    os.makedirs(folder, exist_ok=True)
    return folder


def next_experiment_name(model_folder: str, exp_name: str) -> str:
    """``exp_name``, or ``exp_name_<i>`` with the first free i where
    ``runs/<exp_name>`` exists under the model folder."""
    runs = os.path.join(model_folder, "runs")
    if not os.path.isdir(os.path.join(runs, exp_name)):
        return exp_name
    i = 1
    while os.path.isdir(os.path.join(runs, f"{exp_name}_{i}")):
        i += 1
    return f"{exp_name}_{i}"


def next_version_dir(run_dir: str) -> str:
    """``<run_dir>/version_<n>`` with the first free n."""
    n = 0
    while os.path.isdir(os.path.join(run_dir, f"version_{n}")):
        n += 1
    return os.path.join(run_dir, f"version_{n}")


def unique_path_combine(paths: Sequence[str]) -> str:
    """A name for a list of paths: their distinct parts after the common
    leading components, each joined by "_", the paths by "__" (one path:
    its base name)."""
    if not paths:
        return ""
    normed = [os.path.normpath(p) for p in paths]
    if len(normed) == 1:
        return os.path.basename(normed[0])
    parts = [p.split(os.sep) for p in normed]
    i = 0
    while all(len(p) > i for p in parts) and len({p[i] for p in parts}) == 1:
        i += 1
    distinct = ["_".join([c for c in p[i:] if c]) for p in parts]
    distinct = [d for d in distinct if d]
    if not distinct:
        return os.path.basename(normed[0])
    return "__".join(distinct)


def replace_file_pattern(path: str, pattern: str, replacement: str) -> str:
    """``path`` with the glob suffix ``pattern`` of its file name (its "*"
    dropped) replaced by ``replacement``'s; where the name does not end
    with it, its first occurrence is replaced."""
    base = os.path.basename(path)
    pat = pattern.replace("*", "")
    if base.endswith(pat):
        base = base[: -len(pat)] + replacement.replace("*", "")
    else:
        base = base.replace(pat, replacement.replace("*", ""))
    return os.path.join(os.path.dirname(path), base)


def apply_num_threads(n: Optional[int]) -> None:
    """Bound the host's CPU parallelism to ``n`` threads: torch's intra-op
    pool and, where not set yet, OpenMP's. Nothing without ``n``."""
    if not n:
        return
    import torch

    os.environ.setdefault("OMP_NUM_THREADS", str(n))
    torch.set_num_threads(int(n))


def _git_info(cwd: str) -> Dict[str, str]:
    info = {}
    for key, cmd in (("sha", ["git", "rev-parse", "HEAD"]),
                     ("tag", ["git", "describe", "--tags", "--always"])):
        try:
            info[key] = subprocess.check_output(cmd, cwd=cwd, stderr=subprocess.DEVNULL,
                                                timeout=30).decode().strip()
        except (OSError, subprocess.SubprocessError):
            info[key] = "unknown"
    return info


def _user() -> str:
    try:
        return getpass.getuser()
    except (KeyError, OSError):  # no login name and no passwd entry
        return "unknown"


def get_run_info() -> Dict[str, Any]:
    """The run's provenance: the checkout's git commit, the host, the user,
    Python, torch, CUDA and the card (or "cpu"), the command line and the
    time."""
    import torch

    cuda = torch.cuda.is_available()
    return {
        "git": _git_info(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))),
        "host": platform.node(),
        "user": _user(),
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 0,
        "argv": sys.argv,
        "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }


def get_file_md5(path: str) -> str:
    """The md5 of a file's content, or of a directory's (a checkpoint
    directory): then of each file's relative path and content, in sorted
    order."""
    h = hashlib.md5()
    files = ([os.path.join(root, name) for root, _, names in sorted(os.walk(path))
              for name in sorted(names)] if os.path.isdir(path) else [path])
    for fp in files:
        if fp != path:
            h.update(os.path.relpath(fp, path).encode())
        with open(fp, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
    return h.hexdigest()


def p2x_stem(path: str) -> str:
    """A file's basename without its P2X type suffix: 'run1_WFCal.h5' →
    'run1' (the prediction-writer CLIs' output stem)."""
    base = os.path.basename(path)
    return base[:base.rfind("_")] if "_" in base else base[:-3]


def write_run_info(log_dir: str) -> None:
    """``get_run_info()`` as ``<log_dir>/run_info.json``."""
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "run_info.json"), "w") as f:
        json.dump(get_run_info(), f, indent=2, default=str)

_CKPT_METRIC_RE = re.compile(r"val_loss[=\-]([0-9]*\.?[0-9]+)")


def retrieve_best_checkpoint(model_folder: str) -> Optional[str]:
    """The ``*.ckpt`` under ``model_folder`` (recursively) with the lowest
    ``val_loss`` in its name (the port's checkpoints are files named
    ``epoch=E-val_loss=V.ckpt``); where no name carries a metric, the newest
    one; None where there is none."""
    candidates = glob.glob(os.path.join(model_folder, "**", "*.ckpt"), recursive=True)
    best, best_metric = None, None
    fallback, fallback_mtime = None, -1.0
    for c in candidates:
        m = _CKPT_METRIC_RE.search(os.path.basename(c))
        if m:
            metric = float(m.group(1))
            if metric == metric and (best_metric is None or metric < best_metric):
                best, best_metric = c, metric
        else:
            mt = os.path.getmtime(c)
            if mt > fallback_mtime:
                fallback, fallback_mtime = c, mt
    return best if best is not None else fallback


def prefetch_iter(iterable: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Run an iterator in a background thread with a bounded queue of
    ``depth`` items, so that host work (decoding, collation) overlaps the
    consumer's. A worker's exception re-raises in the consumer; abandoning
    the generator (the consumer breaks or raises) stops the worker instead of
    leaving it blocked on a full queue."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def put_or_stop(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not put_or_stop(item):
                    return
            put_or_stop(end)
        except BaseException as e:  # noqa: BLE001 -- re-raised in the consumer
            put_or_stop(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def get_bins(low: float, high: float, n: int) -> np.ndarray:
    """n+1 bin edges from low to high."""
    return np.linspace(low, high, int(n) + 1)


def get_bin_midpoints(low: float, high: float, n: int) -> np.ndarray:
    """The n bins' centres from low to high."""
    edges = get_bins(low, high, n)
    return 0.5 * (edges[:-1] + edges[1:])


def safe_divide(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise a/b in float64, 0 where b == 0."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    out = np.zeros(np.broadcast(a, b).shape, dtype=np.float64)
    np.divide(a, b, out=out, where=(b != 0))
    return out
