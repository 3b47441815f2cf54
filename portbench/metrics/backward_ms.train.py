"""backward_ms.train: a training step's backward on the device, in ms: the
program's device span ``trainer.backward`` (from the event after the loss
to the one after ``loss.backward()``), a mean over the window's steps. It
moves ``train_events_per_s``."""
from portbench.metrics._spans import mean_ms


def read(r):
    return mean_ms(r, "train", "trainer.backward")
