"""mfu.train: the whole step's share of the card's peak in the train
cells, in %: the model's operations (``work/<config>.py``) over the
window's steps, over the window's wall at the peak rate of
``peaks.json`` for the configuration's precision. It moves
``train_events_per_s``."""
from portbench.metrics._read import mfu_pct


def read(r):
    return mfu_pct(r, "train")
