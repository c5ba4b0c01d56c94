"""Share of the continuous scheduler's mixed steps that run at the wide
width (``StepStats.wide_steps / mixed_steps``, summed over the window's
waves)."""


def read(run):
    stats = [w.stats for w in run.waves if w.stats is not None]
    steps = sum(s.mixed_steps for s in stats)
    return sum(s.wide_steps for s in stats) / steps if steps else None
