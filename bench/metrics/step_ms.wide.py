"""Mean wall time of the continuous engine's wide mixed steps (span
``serve.device_step`` with ``width`` > 1: any prefill row), in ms, over the
window's waves. The span closes once the step's tokens are on the host."""


def read(run):
    d = [e.dur_ns for w in run.waves for e in w.spans
         if e.name == "serve.device_step" and (e.args or {}).get("width", 1) > 1]
    return sum(d) / len(d) / 1e6 if d else None
