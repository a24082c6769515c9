"""Share of its floor (perfbench/floors.py) that K1, the forward stream compositor (csrc/stream_fwd.cu)
reaches over the traced train steps, in percent."""

from perfbench.metrics._roofline import k1


def read(r):
    return k1(r)
