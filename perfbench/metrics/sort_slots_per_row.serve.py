"""Slots the binning sorts (``render.slots_sorted``: the instance budget)
per stream row the compositor reads (``render.rows_used``), over the traced
slice: the sort's attempts per useful outcome, near 1 where the budget
fits the view."""

from perfbench.metrics._spans import counter_ratio


def read(r):
    return counter_ratio(r, "render.slots_sorted", "render.rows_used")
