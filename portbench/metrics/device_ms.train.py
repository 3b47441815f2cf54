"""device_ms.train: a training step's device time, in ms:
``Trainer.step_phases[i]["device_ms"]`` (the program's CUDA events around
the forward, backward and optimizer step) summed over the window's steps,
over their count. It moves ``train_events_per_s``."""


def read(r):
    if r.get("mode") != "train" or not r.get("steps"):
        return None
    ms = [s["device_ms"] for s in r["steps"]]
    if any(m is None for m in ms):
        return None
    return sum(ms) / len(ms)
