"""Host self milliseconds a served view in the span ``render.bin``
(``tiles.bin_stream``: the instance expansion, the sort and the stream
layout), over the traced slice."""

from perfbench.metrics._spans import self_ms_per_unit


def read(r):
    return self_ms_per_unit(r, "render.bin")
