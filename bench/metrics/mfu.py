"""The served work's share of the card's bf16 peak, in %: the FLOPs the
window's requests need (``bench.counts.served_flops``: every prompt and
generated token once, no pads) over the window's seconds times 989e12."""

from bench.constants import PEAK_BF16_FLOPS
from bench.counts import served_flops


def read(run):
    reqs = [(s.prompt_len, len(s.tokens)) for w in run.waves for s in w.served]
    return 100.0 * served_flops(run.shapes, reqs) / (run.window_s * PEAK_BF16_FLOPS)
