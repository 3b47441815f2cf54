"""optimizer_ms.train: a training step's optimizer on the device, in ms:
the program's device span ``trainer.optimizer`` (from the event after the
backward to the one after the optimizer's step), a mean over the window's
steps. It moves ``train_events_per_s``."""
from portbench.metrics._spans import mean_ms


def read(r):
    return mean_ms(r, "train", "trainer.optimizer")
