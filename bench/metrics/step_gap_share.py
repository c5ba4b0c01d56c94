"""Share of the window's wall time in which the card waited between the
engine's steps: the sum of ``gap_ns`` over the step spans
(``serve.device_step``, ``serve.decode_step``, ``serve.prefill``; from the
CUDA event after the previous step's replay, or at ``generate()``'s entry,
to the one before this step's staged copy) over the sum of the untraced
waves' walls. ``None`` where the spans carry no ``gap_ns`` (off the card)."""

STEPS = ("serve.device_step", "serve.decode_step", "serve.prefill")


def read(run):
    gaps = [e.args["gap_ns"] for w in run.waves for e in w.spans
            if e.name in STEPS and "gap_ns" in (e.args or {})]
    if not gaps:
        return None
    return sum(gaps) / 1e9 / sum(w.end - w.start for w in run.waves)
