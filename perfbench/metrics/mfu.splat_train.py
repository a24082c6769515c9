"""The whole train step's share of the card's peak, in percent: the step's
floor (perfbench/floors.py splat_step: the slice's views' pairs, the live
Gaussians, the pixels) over the measured time of the untraced steps."""

import statistics

from perfbench import floors
from perfbench.metrics._trace import untraced_share


def read(r):
    w = r.get("work")
    if not w or not w["views"]:
        return None
    f = statistics.mean(floors.splat_step(p, w["gaussians"], w["pixels"], w["sh_degree"]) for p, _ in w["views"])
    return untraced_share(r, f)
