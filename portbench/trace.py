"""The traced stretch of a run: ``torch.profiler`` over a few whole chunks
or steps inside the window, reduced to device events.

A profile drops the device records of its first few kernel launches, the
more the more profiles the process has taken (``chip_smoke.py``'s
``profiled``, which this copies). So the stretch first launches
``PROFILE_PREFIX`` spin kernels, which the reduction leaves out, and it
fails if a launch of the stretch itself, a kernel's or a CUDA graph's,
has no device record.

``Stretch`` is driven from the window's own hooks: ``begin`` before the
first chunk or step of the stretch and ``end`` after its last, each with
a synchronise, so the stretch's wall time holds exactly its work. Host
spans opened with ``span`` label what the host was doing, and the idle
gaps of the breakdown are named after them.
"""

from __future__ import annotations

import time

import torch

PROFILE_PREFIX = 1024
# seconds into the window at which the stretch starts
TRACE_AFTER_S = 5.0
# the runtime calls that launch one kernel, or one graph of kernels
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
SPAN_PREFIX = "portbench."
TOP = 10


class TraceLost(RuntimeError):
    """The profile has no device record of a launch of the stretch."""


class Stretch:
    """One profiled stretch. After ``end``: ``events`` (device events,
    ``(name, start_ns, end_ns)``, the spin kernels left out), ``spans``
    (the host spans, ``(name, start_ns, end_ns)``), ``wall_s`` and
    ``steps``."""

    def __init__(self):
        self.prof = None
        self.active = False
        self.done = False
        self.steps = 0
        self.events: list = []
        self.spans: list = []
        self.wall_s = 0.0
        self._t0 = 0.0
        self._open: list = []

    def begin(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        for _ in range(PROFILE_PREFIX):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        self.active = True
        self._t0 = time.perf_counter()

    def span(self, name: str):
        """Open a host span (closed by ``close_span``), when active."""
        if self.active:
            rf = torch.profiler.record_function(SPAN_PREFIX + name)
            rf.__enter__()
            self._open.append(rf)

    def close_span(self):
        if self._open:
            self._open.pop().__exit__(None, None, None)

    def end(self, steps: int):
        while self._open:
            self.close_span()
        torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()
        self.active = False
        self.done = True
        self.steps = steps
        self._reduce()
        self.prof = None

    def _reduce(self):
        events = list(self.prof.profiler.kineto_results.events())
        cuda = torch.autograd.DeviceType.CUDA
        calls = {e.correlation_id(): e.start_ns() for e in events
                 if e.name() in LAUNCH_CALLS}
        seen = {e.correlation_id() for e in events
                if e.device_type() == cuda}
        order = sorted(calls, key=calls.get)
        lost = [i for i, c in enumerate(order)
                if c not in seen and i >= PROFILE_PREFIX]
        if lost:
            raise TraceLost(
                f"the profile dropped the device records of {len(lost)} of "
                f"the stretch's {len(order) - PROFILE_PREFIX} launches")
        self.events = sorted(
            ((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in events
             if e.device_type() == cuda and e.duration_ns() > 0
             and "spin_kernel" not in e.name()
             and not e.name().startswith(SPAN_PREFIX)),
            key=lambda ev: ev[1])
        self.spans = sorted(
            ((e.name()[len(SPAN_PREFIX):], e.start_ns(),
              e.start_ns() + e.duration_ns()) for e in events
             if e.device_type() != cuda
             and e.name().startswith(SPAN_PREFIX)),
            key=lambda s: s[1])


def is_copy(name: str) -> bool:
    """A device copy or fill by the runtime, not a kernel."""
    return name.startswith(("Memcpy", "Memset"))


def kernels(events) -> list:
    """The kernel events of ``events``."""
    return [e for e in events if not is_copy(e[0])]


def kernels_and_fills(events) -> list:
    """``events`` without the copies (the prefetch's run on a stream of
    their own), in the order they started."""
    return [e for e in events if not e[0].startswith("Memcpy")]


def busy_s(events) -> float:
    """Seconds in which some device event ran: the union of their
    intervals (kernels on several streams, and copies, overlap)."""
    total, end = 0, None
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e9


def seconds_of(events, names) -> float:
    """Device seconds of the events whose name holds one of ``names``."""
    return sum(b - a for n, a, b in events
               if any(k in n for k in names)) / 1e9


def device_ops(events) -> list:
    """``[[name, seconds]]`` of the device operations that took most time
    in the stretch, summed by name."""
    totals: dict = {}
    for n, a, b in events:
        totals[n] = totals.get(n, 0) + (b - a)
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    return [[n[:200], t / 1e9] for n, t in top]


def idle_gaps(events, spans) -> list:
    """``[[what the host was doing, seconds]]`` of the longest gaps in
    which no device event ran, each named after the innermost host span
    that held the gap's start."""
    gaps, end = [], None
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:TOP]:
        held = [s for s in spans if s[1] <= a <= s[2]]
        name = (min(held, key=lambda s: s[2] - s[1])[0] if held
                else "outside the harness's spans")
        out.append([name, (b - a) / 1e9])
    return out
