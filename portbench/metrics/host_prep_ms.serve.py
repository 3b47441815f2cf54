"""host_prep_ms.serve: the host's preparation of a served chunk, in ms:
``InferenceModel.dispatch_phases["host_prep_s"]`` (padding, plans, the pack
into pinned memory, on the host clock) over the window, over the chunks
fetched. It moves ``serve_events_per_s``."""


def read(r):
    if r.get("mode") != "serve" or not r.get("chunks"):
        return None
    return 1e3 * r["host_prep_s"] / r["chunks"]
