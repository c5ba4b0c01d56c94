"""B1's (``csrc/paged_decode.cu``) share of its roofline in the traced
wave, in %: the least time the paged attention those requests need could
take (``bench.counts.b1_need`` at the data-sheet peaks) over B1's device
time in the profiler's trace."""

from bench.counts import b1_need, roofline_seconds


def read(run):
    if run.profile is None:
        return None
    t = run.profile.seconds_of("paged_decode_kernel")
    if t <= 0:
        return None
    reqs = [(s.prompt_len, len(s.tokens)) for s in run.profiled.served]
    return 100.0 * roofline_seconds(*b1_need(run.shapes, reqs)) / t
