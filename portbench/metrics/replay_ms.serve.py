"""replay_ms.serve: a served chunk's device time, in ms: the program's
device span ``serve.device`` (from the event before the chunk's copy in to
the one after its outputs' copy out, around its graph replay), a mean over
the window's chunks. It moves ``serve_events_per_s``."""
from portbench.metrics._spans import mean_ms


def read(r):
    return mean_ms(r, "serve", "serve.device")
