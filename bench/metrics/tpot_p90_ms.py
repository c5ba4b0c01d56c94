"""90th percentile, over every request of the window's waves, of the
engine's mean time per output token after the first
(``GenerationResult.tpot_s``), in ms."""

import math

import numpy as np


def read(run):
    v = [s.tpot_s for w in run.waves for s in w.served
         if s.status == "ok" and not math.isnan(s.tpot_s)]
    return float(np.percentile(v, 90)) * 1e3 if v else None
