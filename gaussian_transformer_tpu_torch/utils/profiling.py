"""Tracing and profiling utilities (port of
``gaussian_transformer_tpu/utils/profiling.py``).

  * ``StepTimer``: host wall-clock per step with the reference's EMA
    smoothing, in milliseconds (the train loop's CUDA-event phase marker is
    ``train/splat.py StepTimer``, a different tool);
  * ``trace``: a ``torch.profiler`` window (CPU and, where there is a card,
    CUDA activity) that writes a Chrome trace into a directory, loadable in
    TensorBoard's profile plugin or chrome://tracing;
  * ``annotate``: a named span inside a traced region;
  * ``device_memory_stats``: live and peak allocator bytes of each card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class StepTimer:
    """EMA-smoothed per-iteration wall timer (the reference's train loop
    smooths its progress bar 0.4 / 0.6)."""

    def __init__(self, ema: float = 0.4):
        self.ema_weight = ema
        self.ema_ms: Optional[float] = None
        self.last_ms: Optional[float] = None
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.last_ms = (time.perf_counter() - self._t0) * 1000.0
        if self.ema_ms is None:
            self.ema_ms = self.last_ms
        else:
            self.ema_ms = self.ema_weight * self.last_ms + (1 - self.ema_weight) * self.ema_ms
        return False


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` and write its Chrome trace
    into ``logdir`` (``<host>_<pid>.<ms>.pt.trace.json``). Yields the
    profiler (``key_averages()`` for sums by kernel). The card, where there
    is one, is synchronised before the window closes, so the trace holds
    every kernel the block launched."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()


def annotate(name: str):
    """Named span inside a traced region."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> dict:
    """{"cuda:<i>": {bytes_in_use, peak_bytes_in_use, bytes_limit}} for each
    visible card (PyTorch's caching allocator; the limit is the card's
    memory); {} without a card."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
