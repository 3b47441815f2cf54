"""device_ms.serve: a served chunk's device time, in ms: the union of the
kernel, memcpy and memset intervals of the ``torch.profiler`` trace inside
the window (``trace.py``: its copies in, graph replays and copies out), over
the chunks fetched in it. It moves ``serve_events_per_s``."""


def read(r):
    t = r.get("trace")
    if r.get("mode") != "serve" or not t or not t.get("device_events") or not r.get("chunks"):
        return None
    return 1e3 * t["busy_s"] / r["chunks"]
