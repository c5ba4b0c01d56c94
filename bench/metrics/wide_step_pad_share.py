"""Share of the positions the continuous engine's wide mixed steps compute
that serve no planned token: 1 - the sum of ``tokens`` over the sum of
``positions`` (slots x width) of the spans ``serve.device_step`` with
``width`` > 1, over the window's waves."""


def read(run):
    tokens = positions = 0
    for w in run.waves:
        for e in w.spans:
            a = e.args or {}
            if e.name == "serve.device_step" and a.get("width", 1) > 1 and "positions" in a:
                tokens += a["tokens"]
                positions += a["positions"]
    return 1.0 - tokens / positions if positions else None
