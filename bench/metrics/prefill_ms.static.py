"""Mean wall time of the static engine's prefill (span ``serve.prefill``:
the eager forward over the padded bucket, the first sample, the copy into
the decode step's caches), in ms, over the window's waves."""


def read(run):
    d = [e.dur_ns for w in run.waves for e in w.spans if e.name == "serve.prefill"]
    return sum(d) / len(d) / 1e6 if d else None
