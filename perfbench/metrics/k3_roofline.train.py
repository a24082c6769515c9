"""Share of its floor (perfbench/floors.py) that K3, fused SSIM forward (csrc/ssim_fwd.cu)
reaches over the traced train steps, in percent."""

from perfbench.metrics._roofline import k3


def read(r):
    return k3(r)
