"""Host self milliseconds a stacked step in the span ``stacked.batch.upload``
(``TrainingScene.make_batch``: the pageable copies to the card and the
masks), over the traced slice."""

from perfbench.metrics._spans import self_ms_per_unit


def read(r):
    return self_ms_per_unit(r, "stacked.batch.upload")
