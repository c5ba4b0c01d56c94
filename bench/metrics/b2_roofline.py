"""B2's (``csrc/flash_fwd.cu``) share of its roofline in the traced wave,
in %: the least time causal attention over each prompt alone could take
(``bench.counts.b2_need``: no pads) over B2's device time in the
profiler's trace."""

from bench.counts import b2_need, roofline_seconds


def read(run):
    if run.profile is None:
        return None
    t = run.profile.seconds_of("flash_fwd_kernel")
    if t <= 0:
        return None
    prompts = [s.prompt_len for s in run.profiled.served]
    return 100.0 * roofline_seconds(*b2_need(run.shapes, prompts)) / t
