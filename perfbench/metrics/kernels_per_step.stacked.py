"""Device kernels (copies and fills left out) per unit of the traced
slice's stacked train steps, from the profiler's trace."""

from perfbench.metrics._trace import kernels_per_unit


def read(r):
    return kernels_per_unit(r)
