"""Shared by the roofline readers: a kernel's share of its floor over the
traced slice, from the kernel's device time by name."""

from perfbench import core, floors


def kernel_share(r, needles, floor_of_view):
    """100 x (the slice's floors summed over its views) / (the kernels'
    device seconds), or None where the slice ran no such kernel."""
    t, w = r.get("trace"), r.get("work")
    if not t or not w or not w["views"]:
        return None
    secs = core.kernel_seconds(t["kernels"], *needles)
    if secs <= 0:
        return None
    return 100.0 * sum(floor_of_view(p, i, w["pixels"]) for p, i in w["views"]) / secs


def k1(r):
    return kernel_share(r, ("stream_fwd_kernel",), floors.k1)


def k2(r):
    return kernel_share(r, ("stream_bwd_kernel",), floors.k2)


def k3(r):
    return kernel_share(r, ("ssim_fwd_kernel",), lambda p, i, px: floors.k3(px))


def k4(r):
    return kernel_share(r, ("ssim_bwd_kernel",), lambda p, i, px: floors.k4(px))
