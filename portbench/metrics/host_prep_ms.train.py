"""host_prep_ms.train: the host's preparation of a training step, in ms:
``Trainer.step_phases[i]["host_prep_s"]`` (``prepare_block``'s padding and
plans, on the host clock) summed over the window's steps, over their count.
It moves ``train_events_per_s``."""


def read(r):
    if r.get("mode") != "train" or not r.get("steps"):
        return None
    return 1e3 * sum(s["host_prep_s"] for s in r["steps"]) / len(r["steps"])
