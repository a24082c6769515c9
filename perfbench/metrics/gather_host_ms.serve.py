"""Host self milliseconds a served view in the span ``render.gather``
(``used_stream``, ``pack_props``, ``stream_gather``), over the traced slice."""

from perfbench.metrics._spans import self_ms_per_unit


def read(r):
    return self_ms_per_unit(r, "render.gather")
