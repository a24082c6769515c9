"""Host self milliseconds a served view in the span ``render.project``
(projection: ``_project_for_binning``), over the traced slice."""

from perfbench.metrics._spans import self_ms_per_unit


def read(r):
    return self_ms_per_unit(r, "render.project")
