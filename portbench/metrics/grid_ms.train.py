"""grid_ms.train: the grid convs' device time in a training step, in ms:
the program's device spans ``grid.<class>.forward`` and
``grid.<class>.backward``, which each conv module of ``ops/sparse_conv.py``
records of itself, summed over the window and divided by its steps (its
``trainer.forward`` spans). It moves ``train_events_per_s``."""
from portbench.metrics._spans import device_spans, ms, store


def read(r):
    rec = store(r, "train")
    grid, steps = device_spans(rec, "grid."), device_spans(rec, "trainer.forward")
    if not grid or not steps:
        return None
    return sum(ms(d) for d in grid) / len(steps)
