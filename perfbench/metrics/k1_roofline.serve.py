"""Share of its floor that K1 (csrc/stream_fwd.cu) reaches over the traced
served views, in percent."""

from perfbench.metrics._roofline import k1


def read(r):
    return k1(r)
