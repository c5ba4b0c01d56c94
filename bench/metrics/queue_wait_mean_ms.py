"""Mean time a request of the window's waves waited, admissible, for a
slot, in ms: the ``wait_ns`` of its instants ``serve.request.admit`` (one
an admission; a preempted request's waits summed), averaged over the
requests admitted."""


def read(run):
    waits: dict = {}
    for i, w in enumerate(run.waves):
        for e in w.spans:
            if e.name == "serve.request.admit":
                key = (i, e.args["rid"])
                waits[key] = waits.get(key, 0) + e.args["wait_ns"]
    return sum(waits.values()) / len(waits) / 1e6 if waits else None
