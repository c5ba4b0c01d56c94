"""Share of a wave's wall time in which no operation ran on the card:
1 - (union of device operation intervals in the traced wave) / the mean
wall time of the window's untraced waves. Every wave of a run has the same
sizes, so the untraced wall is the wave's own, free of whatever the
profiler adds on the host."""


def read(run):
    if run.profile is None:
        return None
    wall = sum(w.end - w.start for w in run.waves) / len(run.waves)
    return 1.0 - run.profile.busy_s / wall
