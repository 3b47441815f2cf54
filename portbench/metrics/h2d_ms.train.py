"""h2d_ms.train: a training step's copy in, in ms: the program's device
span ``trainer.h2d`` (from the event before ``to_device`` to the one
before the step), a mean over the window's steps. It moves
``train_events_per_s``."""
from portbench.metrics._spans import mean_ms


def read(r):
    return mean_ms(r, "train", "trainer.h2d")
