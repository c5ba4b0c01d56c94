"""Share of the positions the static engine's prefills compute that hold
no prompt token: 1 - the sum of ``tokens`` (the groups' own prompt tokens)
over the sum of ``positions`` (rows x bucket, pad rows included) of the
spans ``serve.prefill``, over the window's waves."""


def read(run):
    tokens = positions = 0
    for w in run.waves:
        for e in w.spans:
            a = e.args or {}
            if e.name == "serve.prefill" and "positions" in a:
                tokens += a["tokens"]
                positions += a["positions"]
    return 1.0 - tokens / positions if positions else None
