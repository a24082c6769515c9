"""The whole served view's share of the card's peak, in percent: the view's
floor (perfbench/floors.py splat_view) over the measured time of the
untraced views."""

import statistics

from perfbench import floors
from perfbench.metrics._trace import untraced_share


def read(r):
    w = r.get("work")
    if not w or not w["views"]:
        return None
    f = statistics.mean(floors.splat_view(p, w["gaussians"], w["pixels"], w["sh_degree"]) for p, _ in w["views"])
    return untraced_share(r, f)
