"""Share of its floor (perfbench/floors.py) that K2, the backward stream compositor (csrc/stream_bwd.cu)
reaches over the traced train steps, in percent."""

from perfbench.metrics._roofline import k2


def read(r):
    return k2(r)
