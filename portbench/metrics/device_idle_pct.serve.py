"""device_idle_pct.serve: the share of the traced window in which no kernel,
memcpy or memset ran on the card, in %, from the ``torch.profiler``
trace (``trace.py``). It moves ``serve_events_per_s``."""
from portbench.metrics._read import idle_pct


def read(r):
    return idle_pct(r, "serve")
