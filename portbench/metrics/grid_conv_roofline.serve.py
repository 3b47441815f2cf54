"""grid_conv_roofline.serve: the grid ops' share of their roofline in the
serve cells, in %: the least time the card could take over the operations and
bytes the chunks' sparse work needs (``work/<config>.py``: the grid convs'
forward, at the peak of ``peaks.json``), over the device time
of the modules the configuration names (``grid_modules``), timed by
CUDA events from hooks on them in an eager evaluation pass over the pool.
It moves ``serve_events_per_s``."""
from portbench.metrics._read import roofline_pct


def read(r):
    return roofline_pct(r, "serve")
