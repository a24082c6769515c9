"""Host self milliseconds a stacked step in the spans ``stacked.optimizer``
(the zeroing of the gradients and Adam's update), over the traced slice."""

from perfbench.metrics._spans import self_ms_per_unit


def read(r):
    return self_ms_per_unit(r, "stacked.optimizer")
