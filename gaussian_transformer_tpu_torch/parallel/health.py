"""Failure detection and crash containment across ranks (port of
``gaussian_transformer_tpu/parallel/health.py``).

  * ``heartbeat`` -- an asynchronous all-reduce over the world whose wait has
    a deadline: a stalled peer raises ``HeartbeatTimeout`` on every healthy
    rank instead of hanging the job;
  * ``CrashSaver`` -- runs a step; on an exception it writes the given
    checkpoint payload (the reference's crash save), then swallows or
    re-raises;
  * ``guard_nans`` -- the ``--detect_anomaly`` switch
    (``torch.autograd.set_detect_anomaly``).
"""

from __future__ import annotations

import datetime
from typing import Callable

import torch
import torch.distributed as dist

from gaussian_transformer_tpu_torch.parallel.collectives import _record
from gaussian_transformer_tpu_torch.parallel.mesh import world_device_type


class HeartbeatTimeout(RuntimeError):
    pass


def heartbeat(timeout_s: float = 60.0, group=None) -> bool:
    """Every rank adds 1; True when the sum is the group's size. Raises
    ``HeartbeatTimeout`` when the all-reduce does not complete within
    ``timeout_s`` (a peer is hung or gone)."""
    n = dist.get_world_size(group)
    one = torch.ones(1, device=world_device_type())
    work = dist.all_reduce(one, group=group, async_op=True)
    try:
        done = work.wait(timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError as e:
        raise HeartbeatTimeout(f"heartbeat did not complete within {timeout_s}s: {e}") from e
    if done is False:
        raise HeartbeatTimeout(f"heartbeat did not complete within {timeout_s}s")
    _record("all-reduce", one)
    return int(one.item()) == n


class CrashSaver:
    """Run a step; on exception, persist a checkpoint payload then re-raise or
    swallow (the reference swallows and continues)."""

    def __init__(self, save_fn: Callable[[], None], swallow: bool = True):
        self.save_fn = save_fn
        self.swallow = swallow
        self.crash_count = 0

    def __call__(self, step_fn: Callable, *args, **kwargs):
        try:
            return step_fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 -- crash containment by design
            self.crash_count += 1
            print(f"[crash-save] {type(e).__name__}: {e}")
            self.save_fn()
            if not self.swallow:
                raise
            return None


def guard_nans(enable: bool = True) -> None:
    """The --detect_anomaly analog: autograd checks every backward for NaN."""
    torch.autograd.set_detect_anomaly(enable)
