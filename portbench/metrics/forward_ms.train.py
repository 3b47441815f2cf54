"""forward_ms.train: a training step's forward on the device, in ms: the
program's device span ``trainer.forward`` (from the event before the step
to the one after its loss; ``utils/tracing.py``), a mean over the window's
steps. It moves ``train_events_per_s``."""
from portbench.metrics._spans import mean_ms


def read(r):
    return mean_ms(r, "train", "trainer.forward")
