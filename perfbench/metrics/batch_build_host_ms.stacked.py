"""Host self milliseconds a stacked step in the span ``stacked.batch.build``
(``TrainingScene.make_batch``: visibility, fold, window and padding on the
host), over the traced slice."""

from perfbench.metrics._spans import self_ms_per_unit


def read(r):
    return self_ms_per_unit(r, "stacked.batch.build")
