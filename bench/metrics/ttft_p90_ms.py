"""90th percentile, over every request of the window's waves, of the
engine's time to first token (``GenerationResult.ttft_s``: from the
wave's ``generate()`` call, so waiting behind the burst counts), in ms."""

import numpy as np


def read(run):
    v = [s.ttft_s for w in run.waves for s in w.served if s.status == "ok"]
    return float(np.percentile(v, 90)) * 1e3 if v else None
