"""grid_conv_roofline.train: the grid ops' share of their roofline in the
train cells, in %: the least time the card could take over the operations and
bytes the chunks' sparse work needs (``work/<config>.py``: the grid convs'
forward and backward, at the peak of ``peaks.json``), over the device time
of the modules the configuration names (``grid_modules``), timed by
CUDA events from hooks on them during the window's steps.
It moves ``train_events_per_s``."""
from portbench.metrics._read import roofline_pct


def read(r):
    return roofline_pct(r, "train")
