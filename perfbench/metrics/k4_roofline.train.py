"""Share of its floor (perfbench/floors.py) that K4, fused SSIM backward (csrc/ssim_bwd.cu)
reaches over the traced train steps, in percent."""

from perfbench.metrics._roofline import k4


def read(r):
    return k4(r)
