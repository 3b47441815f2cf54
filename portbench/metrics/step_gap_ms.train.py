"""step_gap_ms.train: the device's time between training steps, in ms: for
each step of the window whose step before it is in the window too, from
that step's last event (the end of ``trainer.optimizer``) to this step's
first (the begin of its copy in, ``trainer.h2d``), on the device clock; a
mean over those steps. Where the host keeps ahead of the card it is ~0; an
epoch's loss read, its end and the next ``fit``'s start show here. It
moves ``train_events_per_s``."""
from portbench.metrics._spans import device_spans, store


def read(r):
    rec = store(r, "train")
    ends = {d["id"]: d["end_ns"] for d in device_spans(rec, "trainer.optimizer")}
    begins = {d["id"]: d["begin_ns"] for d in device_spans(rec, "trainer.h2d")}
    gaps = [(b - ends[i - 1]) * 1e-6 for i, b in begins.items() if i - 1 in ends]
    if not gaps:
        return None
    return sum(gaps) / len(gaps)
