"""Tracing and profiling utilities of the port.

  * ``span(name)`` and ``count(name, n)``: the program's spans and counters,
    kept in memory by one recorder (``RECORDER``) while a ``torch.profiler``
    session is active in the process, and only then. ``summary()`` reduces
    them by name; ``reset()`` clears them. A span's times are
    ``time.time_ns()``, the clock of the profiler's events;
  * ``idle_by_span``: the device's idle gaps split between the innermost
    spans the host had open during them;
  * ``trace``: a ``torch.profiler`` window (CPU and, where there is a card,
    CUDA activity) that writes one Chrome trace holding the device's events
    and the program's spans, loadable in TensorBoard's profile plugin or
    chrome://tracing, and gives ``idle_by_span`` for the window;
  * ``device_memory_stats``: live and peak allocator bytes of each card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import socket
import threading
import time
import warnings
from typing import Dict, Iterable, List, Optional, Tuple

import torch

# Whether a profiler session is active in the process: the recorder's one
# switch, read on every span and count.
_profiling = torch.autograd._profiler_enabled

# The warning of a synchronising CUDA call under
# ``torch.cuda.set_sync_debug_mode("warn")``.
SYNC_WARNING = "called a synchronizing CUDA operation"
# What ``idle_by_span`` calls idle time under no span.
OUTSIDE = "(outside any span)"
# The counter of host synchronisations.
SYNCS = "host.syncs"


@dataclasses.dataclass(slots=True, eq=False)
class Span:
    """One closed span: ``parent`` and ``root`` are span ids (``root`` the
    request or step the span belongs to), ``thread`` the host thread it ran
    on, the times ns on the profiler's clock, ``syncs`` the host
    synchronisations charged to it (none of its children's)."""

    name: str
    id: int
    parent: Optional[int]
    root: int
    thread: int
    start_ns: int = 0
    end_ns: int = 0
    syncs: int = 0


class _Off:
    """The one object ``span`` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """A span being recorded: a ``record_function`` range inside, so the
    profiler's own trace shows it too."""

    __slots__ = ("rec", "name", "span", "range")

    def __init__(self, rec: "Recorder", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.span = self.rec._push(self.name)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.span.start_ns = time.time_ns()
        return self.span

    def __exit__(self, *exc):
        self.span.end_ns = time.time_ns()
        self.range.__exit__(*exc)
        self.rec._pop(self.span)
        return False


class Recorder:
    """Closed spans (in closing order) and counters. A stack of open spans
    per thread gives each span its parent: autograd runs the backward on a
    thread of its own. While any span is open the host's synchronisations
    are counted (``torch.cuda.set_sync_debug_mode("warn")``, where the mode
    was off, and the warning each one raises), each charged to the
    innermost span open on its thread, else to the last one opened."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._open: List[Span] = []
        self._restore = None

    def reset(self) -> None:
        with self._lock:
            self.spans.clear()
            self.counters.clear()

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _push(self, name: str) -> Span:
        """Open a span on this thread's stack."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        sid = next(self._ids)
        span = Span(name, sid, parent.id if parent else None, parent.root if parent else sid,
                    threading.get_ident())
        stack.append(span)
        with self._lock:
            if not self._open:
                self._restore = _watch_syncs(self._sync)
            self._open.append(span)
        return span

    def _pop(self, span: Span) -> None:
        self._stack().pop()
        with self._lock:
            self._open.remove(span)
            self.spans.append(span)
            if not self._open:
                restore, self._restore = self._restore, None
                restore()

    def _sync(self) -> None:
        stack = self._stack()
        with self._lock:
            target = stack[-1] if stack else (self._open[-1] if self._open else None)
            if target is not None:
                target.syncs += 1
            self.counters[SYNCS] = self.counters.get(SYNCS, 0) + 1

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def summary(self) -> dict:
        """{"spans": {name: {count, total_ms, self_ms, syncs}}, "counters":
        {name: total}}. Self time is a span's duration less the part of it
        its children cover."""
        with self._lock:
            spans, counters = list(self.spans), dict(self.counters)
        children: Dict[int, List[Tuple[int, int]]] = {}
        for s in spans:
            if s.parent is not None:
                children.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
        out: Dict[str, dict] = {}
        for s in spans:
            row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0, "syncs": 0})
            dur = s.end_ns - s.start_ns
            cover = _covered(children.get(s.id, ()), s.start_ns, s.end_ns)
            row["count"] += 1
            row["total_ms"] += dur * 1e-6
            row["self_ms"] += (dur - cover) * 1e-6
            row["syncs"] += s.syncs
        return {"spans": out, "counters": counters}


def _watch_syncs(charge):
    """Count every host synchronisation until the returned function is
    called: each one's warning calls ``charge()`` in place of being shown.
    The sync debug mode is set to "warn" only where it was off (a mode of
    "error" is left to raise)."""
    caught = warnings.catch_warnings()
    caught.__enter__()
    warnings.filterwarnings("always", message=SYNC_WARNING, category=UserWarning)
    show = warnings.showwarning

    def counted(message, category, filename, lineno, file=None, line=None):
        if issubclass(category, UserWarning) and str(message).startswith(SYNC_WARNING):
            charge()
        else:
            show(message, category, filename, lineno, file, line)

    warnings.showwarning = counted
    mode = torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() else None
    if mode == 0:
        torch.cuda.set_sync_debug_mode("warn")

    def restore():
        if mode == 0:
            torch.cuda.set_sync_debug_mode(0)
        caught.__exit__(None, None, None)

    return restore


RECORDER = Recorder()


def span(name: str):
    """A named span of the program, as a context manager. Off (no profiler
    session active): the one shared no-op object, with no clock read, no
    allocation, no tensor op and no CUDA call. On: the span is recorded
    (``Span``) and opens a ``record_function`` range of the same name."""
    if not _profiling():
        return _OFF
    return _Open(RECORDER, name)


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to the counter ``name`` while tracing is
    on. Never give it a device tensor: reading one would synchronise."""
    if _profiling():
        RECORDER.add(name, n)


def summary() -> dict:
    """The recorder's spans by name and its counters (``Recorder.summary``)."""
    return RECORDER.summary()


def reset() -> None:
    RECORDER.reset()


def _merged(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _covered(intervals, lo: int, hi: int) -> int:
    """ns of [lo, hi) that the union of ``intervals`` covers."""
    return sum(min(b, hi) - max(a, lo) for a, b in _merged(intervals) if min(b, hi) > max(a, lo))


def idle_by_span(device_intervals: Iterable[Tuple[int, int]], spans: Iterable[Span]) -> Dict[str, float]:
    """Seconds of device idle time by the span the host was in: the union of
    ``device_intervals`` (start, end ns) leaves gaps between its pieces, and
    each instant of a gap goes to the innermost span open then (the one
    opened last), else to ``OUTSIDE``. The values sum to the idle total.
    Largest first."""
    busy = _merged(device_intervals)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    # Pieces of the host's time line, each under one innermost span.
    events = sorted([(s.start_ns, 1, s.id, s) for s in spans] + [(s.end_ns, 0, s.id, s) for s in spans],
                    key=lambda e: e[:3])
    pieces, open_, last = [], [], None
    for t, opens, _, s in events:
        if last is not None and t > last and open_:
            top = max(open_, key=lambda o: (o.start_ns, o.id))
            pieces.append((last, t, top.name))
        if opens:
            open_.append(s)
        else:
            open_.remove(s)
        last = t
    out: Dict[str, float] = {}
    i = 0
    for g0, g1 in gaps:
        named = 0
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            a, b, name = pieces[j]
            ns = min(b, g1) - max(a, g0)
            out[name] = out.get(name, 0.0) + ns * 1e-9
            named += ns
            j += 1
        if g1 - g0 > named:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (g1 - g0 - named) * 1e-9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _device_intervals(prof) -> List[Tuple[int, int]]:
    """(start, end) ns of a finished profiler's device events: kernels,
    copies and fills, not the annotations it projects onto the device."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and not _annotation(e):
            out.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _annotation(event) -> bool:
    """A user annotation (a named range over other events); torch versions
    differ in which of these two accessors they have."""
    kind = getattr(event, "activity_type", None)
    if kind is not None:
        return "annotation" in str(kind())
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


class Window:
    """What ``trace`` yields: the profiler (``prof``, for ``key_averages()``
    and the like) and, once the window has closed, the program's spans in
    it, the device's busy intervals and the trace file's path."""

    def __init__(self, prof):
        self.prof = prof
        self.spans: List[Span] = []
        self.device: List[Tuple[int, int]] = []
        self.path: Optional[str] = None

    def idle_by_span(self) -> Dict[str, float]:
        return idle_by_span(self.device, self.spans)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` and write its Chrome trace
    into ``logdir`` (``<host>_<pid>.<ms>.pt.trace.json``), with the
    program's spans of the window added on their own row (``program
    spans``) on the trace's time base. Yields a ``Window``. The card, where
    there is one, is synchronised before the window closes, so the trace
    holds every kernel the block launched."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    first = len(RECORDER.spans)
    with profile(activities=activities) as prof:
        window = Window(prof)
        try:
            yield window
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    window.spans = RECORDER.spans[first:]
    window.device = _device_intervals(prof)
    window.path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}.{int(time.time() * 1000)}.pt.trace.json")
    prof.export_chrome_trace(window.path)
    with open(window.path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": "program spans",
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent, "root": s.root, "thread": s.thread, "syncs": s.syncs}}
        for s in window.spans)
    with open(window.path, "w") as f:
        json.dump(doc, f)


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
