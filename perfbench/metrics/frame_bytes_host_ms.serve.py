"""Host self milliseconds a served view in the span ``frame.bytes``
(``image_to_bytes``: the uint8 conversion and the copy to the host, where
the host waits for the view's device work), over the traced slice."""

from perfbench.metrics._spans import self_ms_per_unit


def read(r):
    return self_ms_per_unit(r, "frame.bytes")
