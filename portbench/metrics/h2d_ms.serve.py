"""h2d_ms.serve: a served chunk's copy in, in ms: the program's device span
``serve.h2d`` (the packed pinned buffer into the graph's static input), a
mean over the window's chunks. It moves ``serve_events_per_s``."""
from portbench.metrics._spans import mean_ms


def read(r):
    return mean_ms(r, "serve", "serve.h2d")
