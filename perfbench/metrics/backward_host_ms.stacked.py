"""Host self milliseconds a stacked step in the span ``stacked.backward``
(``loss.backward()``), over the traced slice."""

from perfbench.metrics._spans import self_ms_per_unit


def read(r):
    return self_ms_per_unit(r, "stacked.backward")
