"""The port's span and counter recorder (``repro_torch.core.spans``).

* Off (the default), ``span`` hands back one shared no-op and nothing is
  kept.
* On, spans nest by thread, carry their thread's CPU time, and counters
  add up across threads.
* A recording maps onto a ``torch.profiler`` profile's clock by its
  anchor: a span opened around a profiled region holds that region.
* A CPU epoch of the scan engine through the prefetch worker records the
  worker's and the consumer's spans on their own threads.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import spans
from repro_torch.data.synthetic import CTRDataset
from repro_torch.train import engine


def _busy(cpu_ns: int) -> None:
    """Spin until this thread has run ``cpu_ns`` on the CPU."""
    end = time.thread_time_ns() + cpu_ns
    while time.thread_time_ns() < end:
        pass


def test_off_hands_back_one_noop_and_keeps_nothing():
    first, second = spans.span("a"), spans.span("b")
    assert first is second
    with first:
        spans.add("c", 3)
    with spans.recording() as rec:
        pass
    with spans.span("after"):
        spans.add("after")
    assert rec.spans == [] and rec.counters == {}
    assert spans.span("a") is first


def test_one_recording_at_a_time():
    with spans.recording():
        with pytest.raises(RuntimeError, match="already on"):
            with spans.recording():
                pass


def test_nesting_by_thread_cpu_time_and_counters():
    both_open = threading.Barrier(2)

    def work():
        with spans.span("w.outer"):
            with spans.span("w.inner"):
                both_open.wait()
                time.sleep(0.02)
                spans.add("rows", 5)

    with spans.recording() as rec:
        worker = threading.Thread(target=work, name="span-worker")
        worker.start()
        with spans.span("m.outer"):
            with spans.span("m.inner"):
                both_open.wait()
                _busy(20_000_000)
                spans.add("rows", 2)
            spans.add("chunks")
        worker.join()

    by_name = {s.name: s for s in rec.spans}
    assert set(by_name) == {"w.outer", "w.inner", "m.outer", "m.inner"}
    assert by_name["m.inner"].parent == by_name["m.outer"].id
    assert by_name["w.inner"].parent == by_name["w.outer"].id
    assert by_name["m.outer"].parent is None
    assert by_name["w.outer"].parent is None
    assert {s.thread for n, s in by_name.items() if n[0] == "w"} == {
        "span-worker"}
    assert by_name["m.outer"].thread == threading.current_thread().name
    for s in rec.spans:
        assert 0 <= s.cpu_ns and s.start_ns <= s.end_ns
    # a busy loop is on the CPU, a sleep is not
    busy, sleep = by_name["m.inner"], by_name["w.inner"]
    assert busy.cpu_ns >= 20_000_000
    assert sleep.wall_ns >= 20_000_000 and sleep.cpu_ns < 10_000_000
    assert rec.counters == {"rows": 7, "chunks": 1}
    own = rec.self_ns()
    outer = by_name["m.outer"]
    assert own[outer.id] == outer.wall_ns - busy.wall_ns
    assert rec.totals()["m.inner"] == (1, busy.wall_ns, busy.cpu_ns)


def test_threads_lose_no_span_and_no_count():
    """More threads than cores, switching as often as the interpreter
    allows: every span and every count is kept, each span's id once."""
    n_threads, per_thread = max(8, 2 * (os.cpu_count() or 1)), 200
    interval = sys.getswitchinterval()

    def work():
        for _ in range(per_thread):
            with spans.span("s"):
                spans.add("n")

    sys.setswitchinterval(1e-6)
    try:
        with spans.recording() as rec:
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(rec.spans) == n_threads * per_thread
    assert len({s.id for s in rec.spans}) == len(rec.spans)
    assert rec.counters == {"n": n_threads * per_thread}


def test_anchor_maps_spans_onto_the_profile_clock():
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with spans.recording() as rec:
            rec.anchor()
            for _ in range(3):
                with spans.span("outer"):
                    with torch.profiler.record_function("region"):
                        time.sleep(0.001)
    events = list(prof.profiler.kineto_results.events())

    def regions(name):
        return sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                      for e in events if e.name() == name)

    offset, error = rec.offset(regions(spans.ANCHOR))
    assert 0 <= error < 1_000_000
    outers = sorted((s.start_ns + offset, s.end_ns + offset)
                    for s in rec.spans)
    inner = regions("region")
    assert len(inner) == len(outers) == 3
    for (a, b), (lo, hi) in zip(inner, outers):
        assert lo <= a and b <= hi
    with pytest.raises(ValueError):
        rec.offset(regions(spans.ANCHOR)[:1])


def test_cpu_epoch_records_worker_and_consumer_spans():
    rng = np.random.default_rng(0)
    n, batch = 96, 8
    ds = CTRDataset(rng.integers(0, 5, (n, 3)).astype(np.int32),
                    rng.random((n, 2), dtype=np.float32),
                    rng.integers(0, 2, n).astype(np.float32), (5, 5, 5))
    params = {"w": torch.zeros(1)}

    def step(p, s, b):
        p["w"] += b["labels"].sum()
        return p, s, {"loss": b["labels"].mean()}

    runner = engine.make_chunk_runner(step)
    with spans.recording() as rec:
        _, _, steps, _ = engine.run_epoch(runner, params, {}, ds, batch, 4,
                                          seed=3)
    assert steps == n // batch
    main = threading.current_thread().name
    threads = {}
    for s in rec.spans:
        threads.setdefault(s.name, set()).add(s.thread)
    assert threads["prefetch.shuffle"] == threads["prefetch.gather"] == {
        "repro-torch-prefetch"}
    for name in ("prefetch.wait_worker", "prefetch.close", "engine.chunk"):
        assert threads[name] == {main}
    counts = {name: c for name, (c, _, _) in rec.totals().items()}
    assert counts["prefetch.shuffle"] == 1
    assert counts["prefetch.gather"] == counts["engine.chunk"] == 3
    assert counts["prefetch.close"] == 1
    # the consumer's spans do not nest in one another; the worker's
    # gather and shuffle neither
    named = {"prefetch.shuffle", "prefetch.gather", "prefetch.wait_worker",
             "prefetch.close", "engine.chunk"}
    assert all(s.parent is None for s in rec.spans if s.name in named)
    assert params["w"].item() == ds.labels[:steps * batch].sum()
