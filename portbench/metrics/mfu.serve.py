"""mfu.serve: the whole forward's share of the card's peak in the serve
cells, in %: the model's operations (``work/<config>.py``) over the
window's fetched chunks, over the window's wall at the peak rate of
``peaks.json`` for the configuration's precision. It moves
``serve_events_per_s``."""
from portbench.metrics._read import mfu_pct


def read(r):
    return mfu_pct(r, "serve")
