"""The whole step's share of the card's peak, in percent: its floor
(perfbench/floors.py, from the real lengths) over the measured time of the
traced run's untraced steps."""

from perfbench.metrics._trace import untraced_share


def read(r):
    return untraced_share(r, r.get("step_floor_s"))
