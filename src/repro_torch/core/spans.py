"""Spans and counters of the port: one recorder, in memory, off by default.

``span(name)`` times a block, ``add(name, n)`` adds to a counter. Until a
recording is on, ``span`` returns one shared no-op after a single check of
a module global (no clock read, no allocation, no lock) and ``add``
returns at once. A recording keeps everything in memory and writes
nothing by itself::

    with spans.recording() as rec:
        ...             # rec.spans and rec.counters hold what closed

On, each span keeps its name, its thread's name, its start and end
(``time.perf_counter_ns``), its thread's CPU time at both ends
(``time.thread_time_ns``: wall time less CPU time is time off the CPU,
waiting on the GIL, a lock, the disk or a page fault; where that clock
counts in scheduler ticks, 10 ms on some hosts, read it summed over many
spans) and its parent, the innermost span its thread held open. A span's self time is its duration
less what its children cover (``self_ns``).

One clock with a profile: ``Recording.anchor``, called while a
``torch.profiler`` profile runs, reads ``perf_counter_ns`` inside
``record_function(ANCHOR)`` regions. ``Recording.offset`` then maps the
recording onto the host clock of the profile that holds those regions,
within an error it reports. Every thread's spans map alike:
``perf_counter_ns`` is the process's clock, so a thread the profile never
saw (the prefetch worker) maps too. ``add_to_chrome_trace`` writes a
recording into a profile's exported trace that way, a lane a thread.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from contextlib import contextmanager
from typing import Iterator, NamedTuple, Optional

import torch

ANCHOR = "repro_torch.spans.anchor"
# reads an anchor takes: a process's first record_function is slow
# (about a millisecond), later ones take microseconds, and the offset's
# error is the width where all their intervals meet
ANCHOR_READS = 16
# the first thread id of the lanes ``add_to_chrome_trace`` writes, far
# from any real one
LANE_BASE = 1 << 30


class Span(NamedTuple):
    """One closed span; ``parent`` is the ``id`` of the span its thread
    held open when it opened, None at the top."""

    name: str
    thread: str
    start_ns: int
    end_ns: int
    cpu_start_ns: int
    cpu_end_ns: int
    id: int
    parent: Optional[int]

    @property
    def wall_ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def cpu_ns(self) -> int:
        return self.cpu_end_ns - self.cpu_start_ns


class Recording:
    """What one recording kept: ``spans`` (in the order they closed) and
    ``counters`` (totals by name), and its last ``anchors``."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self.anchors: list = []
        self.closed = False
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def anchor(self) -> None:
        """Read ``perf_counter_ns`` inside ``ANCHOR_READS`` profiler regions
        named ``ANCHOR``; call it while the profile to map onto runs, after
        any earlier anchor of this recording."""
        reads = []
        for _ in range(ANCHOR_READS):
            with torch.profiler.record_function(ANCHOR):
                reads.append(time.perf_counter_ns())
        self.anchors = reads

    def offset(self, regions) -> tuple:
        """``(offset_ns, error_ns)``: a time ``t`` of this recording lies at
        ``t + offset_ns`` on a profile's clock, within ``error_ns``.
        ``regions`` are the ``(start_ns, end_ns)`` of the profile's
        ``ANCHOR`` regions; the last ``ANCHOR_READS`` of them bracket this
        recording's last anchor's reads, so the offset lies in each
        region's start and end less its read: the midpoint of where those
        intervals meet, their width the error. Raises ValueError when the
        regions are not this anchor's."""
        regions = sorted(regions)[-ANCHOR_READS:]
        if not self.anchors or len(regions) < len(self.anchors):
            raise ValueError(
                f"the profile holds {len(regions)} {ANCHOR} regions; this "
                "recording's anchor needs its "
                f"{len(self.anchors) or ANCHOR_READS}")
        lo = max(a - r for (a, _), r in zip(regions, self.anchors))
        hi = min(b - r for (_, b), r in zip(regions, self.anchors))
        if lo > hi:
            raise ValueError(
                f"the profile's {ANCHOR} regions do not bracket this "
                "recording's anchor")
        return (lo + hi) // 2, hi - lo

    def self_ns(self) -> dict:
        """Each span's self time by ``id``: its duration less its children's
        (a thread's spans nest, so its children do not overlap)."""
        out = {s.id: s.wall_ns for s in self.spans}
        for s in self.spans:
            if s.parent in out:
                out[s.parent] -= s.wall_ns
        return out

    def totals(self) -> dict:
        """``{name: (count, wall_ns, cpu_ns)}`` over the closed spans."""
        out: dict = {}
        for s in self.spans:
            n, wall, cpu = out.get(s.name, (0, 0, 0))
            out[s.name] = (n + 1, wall + s.wall_ns, cpu + s.cpu_ns)
        return out


class _NoOp:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoOp()
_recording: Optional[Recording] = None


class _Open:
    """A span while it is open."""

    __slots__ = ("rec", "name", "id", "parent", "t0", "c0")

    def __init__(self, rec: Recording, name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        stack = self.rec._stack()
        self.id = next(self.rec._ids)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        # the CPU reads inside the wall reads, so the CPU interval lies
        # within the wall one
        self.t0 = time.perf_counter_ns()
        self.c0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        c1 = time.thread_time_ns()
        t1 = time.perf_counter_ns()
        rec = self.rec
        rec._stack().pop()
        if not rec.closed:
            rec.spans.append(Span(self.name, threading.current_thread().name,
                                  self.t0, t1, self.c0, c1, self.id,
                                  self.parent))
        return False


def span(name: str):
    """A context manager that records the block as a span ``name`` while
    a recording is on, and does nothing otherwise."""
    if _recording is None:
        return _NOOP
    return _Open(_recording, name)


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a recording is on."""
    if _recording is not None:
        _recording.add(name, n)


@contextmanager
def recording() -> Iterator[Recording]:
    """Record spans and counters over the block; one recording at a
    time."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a span recording is already on")
    rec = _recording = Recording()
    try:
        yield rec
    finally:
        _recording = None
        rec.closed = True


def add_to_chrome_trace(rec: Recording, path: str) -> int:
    """Write ``rec``'s spans into the chrome trace at ``path`` (a profile's
    ``export_chrome_trace``, which holds ``rec``'s anchor) on its clock, a
    lane of their own a thread, and its counters and the anchor's error
    under the key ``repro_torch``. Returns the error in ns."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    anchors = [e for e in events
               if e.get("name") == ANCHOR and e.get("ph") == "X"]
    offset, error = rec.offset(
        (round(e["ts"] * 1000), round((e["ts"] + e["dur"]) * 1000))
        for e in anchors)
    pid = anchors[-1]["pid"]
    lanes: dict = {}
    for s in sorted(rec.spans, key=lambda s: s.start_ns):
        if s.thread not in lanes:
            lanes[s.thread] = LANE_BASE + len(lanes)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": lanes[s.thread],
                           "args": {"name": f"repro_torch spans: {s.thread}"}})
        events.append({"ph": "X", "cat": "repro_torch", "name": s.name,
                       "pid": pid, "tid": lanes[s.thread],
                       "ts": (s.start_ns + offset) / 1000,
                       "dur": s.wall_ns / 1000,
                       "args": {"cpu_us": s.cpu_ns / 1000}})
    trace["repro_torch"] = {"anchor_error_ns": error,
                            "counters": dict(rec.counters)}
    with open(path, "w") as f:
        json.dump(trace, f)
    return error
