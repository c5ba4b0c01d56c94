"""``repro_torch.analysis`` — roofline terms for the dry-run, a port of
``repro.analysis``: the H100's constants (:mod:`constants`), the analytic
roofline and parameter counts (:mod:`roofline`), and a trace of one rank's
work in place of the compiled module's HLO (:mod:`trace`)."""

from repro_torch.analysis import constants, roofline, trace

__all__ = ["constants", "roofline", "trace"]
