"""captures.serve: the CUDA graphs the program captured in the window: its
counter ``serve.captures`` (0 where every layout was captured in set-up),
read where the window's dispatches traced themselves. It moves
``serve_chunk_ms_p95``."""
from portbench.metrics._spans import store


def read(r):
    rec = store(r, "serve")
    if rec is None or not any(s["name"] == "serve.dispatch" for s in rec["spans"]):
        return None
    return rec["counters"].get("serve.captures", 0)
