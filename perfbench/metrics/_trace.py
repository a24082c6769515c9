"""Shared by the readers of the traced slice: kernels per unit of work
(steps or views) and the device's idle share."""

from perfbench import core


def kernels_per_unit(r):
    t = r.get("trace")
    if not t or not r.get("trace_units"):
        return None
    return core.kernel_count(t["kernels"]) / r["trace_units"]


def idle_percent(r):
    t = r.get("trace")
    if not t or not r.get("trace_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / r["trace_s"])


def untraced_share(r, floor_per_unit):
    """100 x the floor of the untraced units / their measured seconds."""
    if floor_per_unit is None or not r.get("untraced_s") or not r.get("untraced_steps"):
        return None
    return 100.0 * floor_per_unit * r["untraced_steps"] / r["untraced_s"]
