"""Request micro-batcher: coalesce concurrent score requests into one
fixed-shape dispatch.

A port of ``repro.serve.batcher`` (NumPy and threads, nothing of either
framework). Serving traffic arrives as many small independent requests;
dispatching each one costs a whole graph replay and a copy each way, so
naive per-request serving pays O(requests) dispatch overheads. The batcher
turns that into O(requests / batch): a single worker thread drains a
bounded queue, concatenates requests until the batch is full **or** the
oldest waiting request hits its ``max_wait_ms`` deadline, dispatches once,
and slices the score vector back per caller. The fixed-shape padding of
the tail is the engine's job (``padded_score_loop``), so a partly filled
flush still replays the one captured graph.

Contract (the reference's, held by ``tests/test_torch_serve_ctr.py``):

* ``submit`` never blocks on compute: it enqueues and returns a
  ``Future``; backpressure appears only when ``max_pending`` requests are
  already queued (then ``submit`` blocks until the worker drains).
* Latency added by coalescing is bounded by ``max_wait_ms``: the window
  opens when the *first* request of a batch is picked up, and the batch
  dispatches no later than that deadline regardless of fill.
* Requests never split across dispatches: a request that would overflow the
  current batch is held back (whole) for the next one, so each caller's
  scores come from exactly one dispatch. Requests larger than ``max_batch``
  are rejected at ``submit``.
* A ``score_fn`` exception fails that batch's futures (each caller sees the
  original exception) but not the batcher: later batches serve normally.
  ``close()`` drains, then rejects further submits; any request racing a
  close is cancelled rather than left hanging.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable

import numpy as np

_CLOSE = object()


class _Request:
    __slots__ = ("ids", "dense", "future", "n")

    def __init__(self, ids: np.ndarray, dense: np.ndarray):
        self.ids = ids
        self.dense = dense
        self.future: Future = Future()
        self.n = ids.shape[0]


class MicroBatcher:
    """Coalesce concurrent ``(ids, dense)`` score requests into fixed-shape
    dispatches of at most ``max_batch`` rows under a ``max_wait_ms``
    deadline.

    ``score_fn(ids [n<=max_batch, F], dense [n, Dd]) -> [n] f32`` is any
    scorer with the engine contract — ``ServingEngine.score`` or
    ``HotEmbeddingCache.score``. Use as a context manager or call
    ``close()``.
    """

    def __init__(self, score_fn: Callable, *, max_batch: int = 256,
                 max_wait_ms: float = 2.0, max_pending: int = 4096):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._score_fn = score_fn
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._q: queue.Queue = queue.Queue(max_pending)
        self._closed = False
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "rows": 0, "dispatches": 0,
                       "full_dispatches": 0, "deadline_dispatches": 0,
                       "errors": 0}
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="micro-batcher")
        self._worker.start()

    # ---- client side ------------------------------------------------------

    def submit(self, ids, dense) -> Future:
        """Enqueue one request; the Future resolves to its [n] f32 scores."""
        ids = np.atleast_2d(np.asarray(ids, np.int32))
        dense = np.atleast_2d(np.asarray(dense, np.float32))
        if ids.shape[0] != dense.shape[0]:
            raise ValueError(
                f"ids rows {ids.shape[0]} != dense rows {dense.shape[0]}")
        if ids.shape[0] > self.max_batch:
            raise ValueError(
                f"request of {ids.shape[0]} rows exceeds max_batch "
                f"{self.max_batch}; score it through the engine directly")
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        req = _Request(ids, dense)
        with self._lock:
            self._stats["requests"] += 1
            self._stats["rows"] += req.n
        self._q.put(req)
        return req.future

    def score(self, ids, dense) -> np.ndarray:
        """Blocking convenience: ``submit(...).result()``."""
        return self.submit(ids, dense).result()

    def close(self) -> None:
        """Drain outstanding requests, stop the worker, reject new submits."""
        if self._closed:
            return
        self._closed = True
        self._q.put(_CLOSE)
        self._worker.join()
        # a submit that raced the close flag may have enqueued behind the
        # sentinel; cancel rather than hang its caller
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _CLOSE:
                item.future.set_exception(
                    RuntimeError("MicroBatcher closed before dispatch"))

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        """Counters plus the derived mean batch fill (rows / dispatch)."""
        with self._lock:
            s = dict(self._stats)
        s["mean_fill"] = s["rows"] / max(s["dispatches"], 1)
        return s

    # ---- worker side ------------------------------------------------------

    def _run(self) -> None:
        held = None          # request that would have overflowed last batch
        while True:
            first = held if held is not None else self._q.get()
            held = None
            if first is _CLOSE:
                return
            batch = [first]
            rows = first.n
            deadline = time.monotonic() + self.max_wait_s
            closing = False
            while rows < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is _CLOSE:
                    closing = True
                    break
                if rows + nxt.n > self.max_batch:
                    held = nxt
                    break
                batch.append(nxt)
                rows += nxt.n
            self._dispatch(batch, rows)
            if closing:
                return

    def _dispatch(self, batch, rows: int) -> None:
        ids = (batch[0].ids if len(batch) == 1
               else np.concatenate([r.ids for r in batch]))
        dense = (batch[0].dense if len(batch) == 1
                 else np.concatenate([r.dense for r in batch]))
        with self._lock:
            self._stats["dispatches"] += 1
            if rows >= self.max_batch:
                self._stats["full_dispatches"] += 1
            else:
                self._stats["deadline_dispatches"] += 1
        try:
            scores = np.asarray(self._score_fn(ids, dense))
        except Exception as exc:  # noqa: BLE001 — forwarded to callers
            with self._lock:
                self._stats["errors"] += 1
            for r in batch:
                r.future.set_exception(exc)
            return
        off = 0
        for r in batch:
            r.future.set_result(scores[off: off + r.n].copy())
            off += r.n
