"""Rows a non-empty expert group of the grouped products holds, on
average, over the window's waves: the sum of ``rows`` over the sum of
``groups`` of the engine's instants ``serve.moe`` (one a wave; pad
positions counted, as the kernel runs them). ``None`` where the program
records no ``serve.moe`` (a model without experts, or a program that does
not count them)."""


def read(run):
    rows = groups = 0
    for w in run.waves:
        for e in w.spans:
            if e.name == "serve.moe":
                rows += e.args["rows"]
                groups += e.args["groups"]
    return rows / groups if groups else None
