"""Host self milliseconds a served view in the span ``render.composite``
(K1 through ``composite_stream_tiles``, then ``tiles_to_image``), over the
traced slice."""

from perfbench.metrics._spans import self_ms_per_unit


def read(r):
    return self_ms_per_unit(r, "render.composite")
