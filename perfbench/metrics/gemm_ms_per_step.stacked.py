"""Device milliseconds of matrix-product kernels (cuBLAS and CUTLASS, by
name) per traced stacked train step."""

from perfbench import core


def read(r):
    t = r.get("trace")
    if not t or not r.get("trace_units"):
        return None
    s = core.kernel_seconds(t["kernels"], *core.GEMM_NAMES)
    return 1e3 * s / r["trace_units"] if s > 0 else None
