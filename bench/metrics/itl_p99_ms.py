"""99th percentile of the gaps between consecutive output tokens of a
request, in ms, over every finished (``ok``) request of the window's waves
(``token_ns`` of the instant ``serve.request.finish``, as ``itl_p50_ms``)."""

import numpy as np


def read(run):
    gaps = [b - a for w in run.waves for e in w.spans
            if e.name == "serve.request.finish" and e.args["status"] == "ok"
            for a, b in zip(e.args["token_ns"], e.args["token_ns"][1:])]
    return float(np.percentile(gaps, 99)) / 1e6 if gaps else None
