"""Shared by the readers of the program's own spans and counters: the port's
recorder (``utils/profiling.py``), which records only while a profiler
session is active, so in a measured process it holds the traced slice
alone. Per unit of the slice (views or steps). A port without the recorder
reads nothing."""


def recorded(r):
    """The recorder's summary of the traced slice, or None."""
    if not r.get("trace_units"):
        return None
    from gaussian_transformer_tpu_torch.utils import profiling

    summary = getattr(profiling, "summary", None)
    return None if summary is None else summary()


def self_ms_per_unit(r, name):
    """Host self milliseconds of the span ``name`` per unit of the slice."""
    s = recorded(r)
    if s is None or name not in s["spans"]:
        return None
    return s["spans"][name]["self_ms"] / r["trace_units"]


def counter_per_unit(r, name):
    """The counter ``name`` per unit of the slice (0 where it never moved)."""
    s = recorded(r)
    return None if s is None else s["counters"].get(name, 0) / r["trace_units"]


def counter_ratio(r, num, den):
    """One counter over another, over the whole slice."""
    s = recorded(r)
    if s is None or not s["counters"].get(den):
        return None
    return s["counters"].get(num, 0) / s["counters"][den]
