"""Host helpers: background prefetch and checkpoint discovery (the port's
own copies of ``prefetch_iter`` and ``retrieve_best_checkpoint`` of
waveformml_tpu/utils/util.py)."""
from __future__ import annotations

import glob
import os
import queue
import re
import threading
from typing import Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")

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
