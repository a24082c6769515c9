"""Host synchronisations a stacked step inside the program's spans (the
recorder's ``host.syncs``; the benchmark loop's own reads of each step's
results lie outside them), over the traced slice."""

from perfbench.metrics._spans import counter_per_unit


def read(r):
    return counter_per_unit(r, "host.syncs")
