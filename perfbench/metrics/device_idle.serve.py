"""The card's idle share of the traced slice, in percent: 1 - (the union of
its device activity) / (the slice's host-clock length)."""

from perfbench.metrics._trace import idle_percent


def read(r):
    return idle_percent(r)
