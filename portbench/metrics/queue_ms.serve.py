"""queue_ms.serve: how long a served chunk waits on the stream, in ms: the
device time of its first event (the begin of ``serve.device``) less the
host time that event was enqueued, both on the host clock through the
tracer's anchor; the 95th percentile over the window's chunks. It moves
``serve_chunk_ms_p95``."""
import numpy as np

from portbench.metrics._spans import device_spans, store


def read(r):
    spans = device_spans(store(r, "serve"), "serve.device")
    if not spans:
        return None
    return float(np.percentile([(d["begin_ns"] - d["enqueue_ns"]) * 1e-6 for d in spans], 95))
