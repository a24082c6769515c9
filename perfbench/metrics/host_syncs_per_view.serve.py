"""Host synchronisations a served view inside the program's spans (the
recorder's ``host.syncs``), over the traced slice."""

from perfbench.metrics._spans import counter_per_unit


def read(r):
    return counter_per_unit(r, "host.syncs")
