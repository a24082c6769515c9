"""Host self milliseconds a stacked step in the span ``stacked.loss`` (the
rest of the loss: unstack, Chamfer, the gate's read, the image loss when
it opens), over the traced slice."""

from perfbench.metrics._spans import self_ms_per_unit


def read(r):
    return self_ms_per_unit(r, "stacked.loss")
