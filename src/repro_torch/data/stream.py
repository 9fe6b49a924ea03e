"""Bounded host-side streaming source for online CTR training.

A port of ``repro.data.stream``, all of it NumPy on the host. The epoch
path trains over a static in-memory array; this module is the "data keeps
arriving" half: an unbounded sequence of *events* -- small ``{"ids",
"dense", "labels"}`` host arrays of any length, from a generator, a
growing file, or a replayed log -- is re-batched into exact
``batch_size`` batches, stacked into the same ``[k, batch, ...]`` chunks
``prefetch.chunk_epoch`` emits, and fed through a bounded worker queue so
the stacking overlaps training. ``train_ctr(mode="stream")`` consumes
these chunks with either engine (copying each to the card through
``data.prefetch``); there is no epoch, only a step budget (``max_steps``
/ the CLI's ``--steps``).

Shutdown and failure semantics mirror ``data.prefetch.prefetch``: the
worker is a daemon thread behind a bounded queue, closing the consumer
stops the worker promptly (0.1s put timeouts against a stop event), and a
worker exception re-raises in the consumer. Leftover rows smaller than a
batch at end-of-stream are dropped with the same one-time tail note the
epoch path uses (``synthetic.note_dropped_remainder`` -- once per process,
because a stream re-opens sources repeatedly).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

from .synthetic import CTRDataset, note_dropped_remainder

logger = logging.getLogger(__name__)

_DONE = object()
_KEYS = ("ids", "dense", "labels")


def skip_rows(events: Iterable[dict], n: int) -> Iterator[dict]:
    """Drop the first ``n`` rows of an event stream (slicing the partial
    event at the boundary) — the resume cursor for deterministic sources.

    ``batches_from_events`` concatenates rows across event boundaries, so
    the batch sequence after a skip depends only on the row sequence, not
    on where the original event boundaries fell: replaying a
    deterministic source and skipping ``steps * batch_size`` rows
    reproduces the exact batches an uninterrupted run would have seen
    from that step on (the stream cursor a snapshot records).
    """
    if n < 0:
        raise ValueError(f"cannot skip {n} rows")
    remaining = n
    it = iter(events)
    try:
        for ev in it:
            k = len(ev["labels"])
            if remaining >= k:
                remaining -= k
                continue
            if remaining:
                ev = {key: np.asarray(ev[key])[remaining:] for key in _KEYS}
                remaining = 0
            yield ev
            break
        else:
            return
        for ev in it:
            yield ev
    finally:
        close = getattr(events, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass


def batches_from_events(events: Iterable[dict], batch_size: int,
                        *, drop_remainder: bool = True) -> Iterator[dict]:
    """Re-batch variable-length events into exact ``batch_size`` batches.

    Rows carry over between events (an event is whatever arrived, not a
    batch), so no row is lost at event boundaries; only the final
    sub-batch tail at end-of-stream follows ``drop_remainder`` (noted via
    the shared one-time tail note). Static batch shapes keep every
    training step on one compiled executable, exactly as in the epoch
    path.
    """
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    buf: dict = {k: [] for k in _KEYS}
    buffered = 0
    total = 0
    for ev in events:
        n = len(ev["labels"])
        if n == 0:
            continue
        total += n
        buffered += n
        for k in _KEYS:
            buf[k].append(np.asarray(ev[k]))
        while buffered >= batch_size:
            cat = {k: part[0] if len(part) == 1 else np.concatenate(part)
                   for k, part in buf.items()}
            yield {k: cat[k][:batch_size] for k in _KEYS}
            for k in _KEYS:
                buf[k] = [cat[k][batch_size:]]
            buffered -= batch_size
    if buffered:
        if not drop_remainder:
            raise ValueError(
                "streaming requires drop_remainder=True (the compiled step "
                f"needs static batch shapes; {buffered} tail rows do not "
                "fill a batch)")
        note_dropped_remainder(total, batch_size)


def chunks_from_batches(batches: Iterable[dict], scan_steps: int
                        ) -> Iterator[dict]:
    """Stack batches into contiguous ``[k, batch, ...]`` chunks.

    ``k == scan_steps`` except possibly for the stream's final chunk,
    which carries the leftover ``k < scan_steps`` whole batches — same
    contract as ``prefetch.chunk_epoch``, so the scan engine's chunk
    runner consumes either source unchanged.
    """
    if scan_steps < 1:
        raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
    pend: list = []
    for b in batches:
        pend.append(b)
        if len(pend) == scan_steps:
            yield {k: np.stack([p[k] for p in pend]) for k in _KEYS}
            pend = []
    if pend:
        yield {k: np.stack([p[k] for p in pend]) for k in _KEYS}


class ChunkStream:
    """A thread-fed, bounded queue of training chunks from an event stream.

    The worker re-batches and stacks on its own thread (daemon, named
    ``repro-torch-stream``) while the training loop consumes; ``buffer_size``
    bounds host memory at that many staged chunks. Iterate it (or call
    ``close()`` / use as a context manager); closing stops the worker
    promptly and a worker error re-raises in the consumer — the
    ``data.prefetch`` contract, for a source with no epoch boundary.

    ``transform`` (optional) runs on the worker thread over each stacked
    chunk before it is queued — the hook the async hot/cold placement uses
    to plan row migrations one chunk ahead of the consumer. It may return
    a wrapped item (any object the consumer recognizes) or ``None`` to end
    the stream cleanly at a step budget.
    """

    def __init__(self, events: Iterable[dict], batch_size: int,
                 scan_steps: int = 1, *, buffer_size: int = 2,
                 transform: Optional[Callable] = None,
                 start_rows: int = 0):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, buffer_size))
        self._stop = threading.Event()
        self._failure: list = []
        self._events = events
        self._batch_size = batch_size
        self._scan_steps = scan_steps
        self._transform = transform
        # stream cursor: rows staged into chunks so far, counted from
        # ``start_rows`` (the resume offset of a replayed source). The
        # consumer-side cursor a snapshot records is steps * batch_size —
        # this worker-side count only ever runs *ahead* of it by the
        # queue depth, and ``cursor()`` reports both so tests can assert
        # the relationship.
        self.start_rows = int(start_rows)
        self.rows_staged = 0
        self._worker = threading.Thread(
            target=self._work, daemon=True, name="repro-torch-stream")
        self._worker.start()

    def cursor(self) -> dict:
        """Worker-side stream position: rows staged into queued chunks
        (counting from ``start_rows``) plus the chunk geometry a resume
        needs to translate steps back into rows."""
        return {"start_rows": self.start_rows,
                "rows_staged": self.rows_staged,
                "batch_size": self._batch_size,
                "scan_steps": self._scan_steps}

    def _work(self):
        try:
            chunks = chunks_from_batches(
                batches_from_events(self._events, self._batch_size),
                self._scan_steps)
            for chunk in chunks:
                if self._transform is not None:
                    chunk = self._transform(chunk)
                    if chunk is None:
                        return
                payload = getattr(chunk, "chunk", None)
                if payload is None and isinstance(chunk, dict):
                    payload = chunk
                if payload is not None:
                    self.rows_staged += int(
                        payload["labels"].shape[0]
                        * payload["labels"].shape[1])
                while not self._stop.is_set():
                    try:
                        self._q.put(chunk, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # re-raised in the consumer
            self._failure.append(e)
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_DONE, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[dict]:
        try:
            while True:
                item = self._q.get()
                if item is _DONE:
                    break
                yield item
            if self._failure:
                raise self._failure[0]
        finally:
            self.close()

    def close(self):
        """Stop the worker, drain staged chunks and join the worker
        (idempotent), so no thread of a closed stream runs on. The
        source's generator is closed after the join, when the worker no
        longer runs it, so a file-tail source releases its handle. A
        worker still blocked after 10 s (a transform that waits on work
        no one will do) is left to the daemon flag."""
        self._stop.set()
        self._drain()
        if threading.current_thread() is not self._worker:
            self._worker.join(10.0)
            self._drain()
        close = getattr(self._events, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass

    def _drain(self):
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def stream_chunks(events: Iterable[dict], batch_size: int,
                  scan_steps: int = 1, *, buffer_size: int = 2,
                  transform: Optional[Callable] = None,
                  start_rows: int = 0) -> ChunkStream:
    """The composition ``train_ctr(mode="stream")`` consumes: events ->
    exact batches -> ``[k, batch, ...]`` chunks, staged ``buffer_size``
    deep on a worker thread. ``transform`` runs per chunk on the worker
    (see ``ChunkStream``); ``start_rows`` stamps the cursor origin of a
    resumed (row-skipped) source."""
    return ChunkStream(events, batch_size, scan_steps,
                       buffer_size=buffer_size, transform=transform,
                       start_rows=start_rows)


def synthetic_event_stream(ds: CTRDataset, *, events: Optional[int] = None,
                           rows_per_event: int = 256, seed: int = 0
                           ) -> Iterator[dict]:
    """An endless (or ``events``-bounded) event source over a dataset:
    repeated reshuffled passes, sliced into ``rows_per_event`` events —
    the CLI/bench stand-in for a production log tail. Each pass reshuffles
    with a fresh sub-seed, so the stream never repeats batch composition.
    """
    n = len(ds)
    rng = np.random.default_rng(seed)
    emitted = 0
    while True:
        order = rng.permutation(n)
        for start in range(0, n, rows_per_event):
            if events is not None and emitted >= events:
                return
            idx = order[start:start + rows_per_event]
            yield {"ids": ds.ids[idx], "dense": ds.dense[idx],
                   "labels": ds.labels[idx]}
            emitted += 1


def follow_tsv_events(path: str, vocab_sizes, n_dense: int, *,
                      rows_per_event: int = 256, poll_s: float = 0.05,
                      idle_timeout_s: Optional[float] = None,
                      stop: Optional[Callable[[], bool]] = None,
                      start_offset: int = 0,
                      cursor: Optional[dict] = None,
                      quarantine_path: Optional[str] = None
                      ) -> Iterator[dict]:
    """Tail a growing TSV of ``label <tab> dense... <tab> ids...`` rows.

    Yields an event whenever ``rows_per_event`` complete lines have
    accumulated (partially written last lines are left for the next
    poll). The follow ends when ``stop()`` returns true or no new bytes
    arrive for ``idle_timeout_s`` (None tails forever); a final short
    event flushes whatever is pending. This is the file-tail flavor of
    the stream contract — same event dicts as ``synthetic_event_stream``.

    Malformed lines — wrong field count, cells that do not parse as
    numbers, non-integer ids, ids outside ``[0, vocab)`` — never crash
    the stream worker: each is appended verbatim to a quarantine side
    file (``quarantine_path``, default ``path + ".quarantine"``), counted
    in ``cursor["rows_quarantined"]``, and warned about once per
    malformation shape (field count x reason) so a burst of identical
    garbage logs one line, not a million.

    ``start_offset`` seeks before the first read (resume from a byte
    cursor); ``cursor`` — a caller-owned dict — is kept updated with
    ``offset`` (byte position after the last *consumed* line),
    ``rows_emitted`` and ``rows_quarantined``, so a snapshot can record
    exactly where in the file training had read to.
    """
    n_fields = len(vocab_sizes)
    vocab = [int(v) for v in vocab_sizes]
    n_cells = 1 + n_dense + n_fields
    pend: list = []
    idle = 0.0
    if cursor is None:
        cursor = {}
    cursor.setdefault("offset", int(start_offset))
    cursor.setdefault("rows_emitted", 0)
    cursor.setdefault("rows_quarantined", 0)
    warned_shapes: set = set()
    qfile = [None]
    qpath = quarantine_path or (path + ".quarantine")

    def quarantine(line: str, reason: str, shape):
        cursor["rows_quarantined"] += 1
        if qfile[0] is None:
            qfile[0] = open(qpath, "a")
        qfile[0].write(line + "\n")
        qfile[0].flush()
        if shape not in warned_shapes:
            warned_shapes.add(shape)
            logger.warning(
                "[stream] quarantined malformed TSV row (%s); further "
                "rows of this shape go to %s silently", reason, qpath)

    def parse(line: str):
        cells = line.split("\t")
        if len(cells) != n_cells:
            quarantine(line, f"{len(cells)} fields, expected {n_cells}",
                       ("nfields", len(cells)))
            return None
        try:
            head = [float(x) for x in cells[:1 + n_dense]]
        except ValueError:
            quarantine(line, "non-numeric label/dense cell",
                       ("float", n_cells))
            return None
        try:
            ids = [int(x) for x in cells[1 + n_dense:]]
        except ValueError:
            quarantine(line, "non-integer id cell", ("int", n_cells))
            return None
        for i, x in enumerate(ids):
            if not 0 <= x < vocab[i]:
                quarantine(line, f"id {x} outside [0, {vocab[i]}) for "
                           f"field {i}", ("range", i))
                return None
        return head + ids

    def flush():
        rows = np.asarray(pend, np.float64)
        ev = {
            "labels": rows[:, 0].astype(np.float32),
            "dense": rows[:, 1:1 + n_dense].astype(np.float32),
            "ids": rows[:, 1 + n_dense:1 + n_dense + n_fields].astype(
                np.int32),
        }
        cursor["rows_emitted"] += len(pend)
        pend.clear()
        return ev

    try:
        with open(path) as f:
            if start_offset:
                f.seek(start_offset)
            carry = ""
            while True:
                if stop is not None and stop():
                    break
                data = f.read()
                if not data:
                    if idle_timeout_s is not None:
                        idle += poll_s
                        if idle >= idle_timeout_s:
                            break
                    time.sleep(poll_s)
                    continue
                idle = 0.0
                lines = (carry + data).split("\n")
                carry = lines.pop()      # possibly incomplete last line
                for line in lines:
                    cursor["offset"] += len(line.encode()) + 1
                    if not line.strip():
                        continue
                    row = parse(line)
                    if row is None:
                        continue
                    pend.append(row)
                    if len(pend) >= rows_per_event:
                        yield flush()
            if pend:
                yield flush()
    finally:
        if qfile[0] is not None:
            qfile[0].close()


def write_tsv_rows(path: str, ds: CTRDataset, start: int, stop: int):
    """Append rows ``[start, stop)`` of a dataset in the TSV layout
    ``follow_tsv_events`` reads — the producer half for tests and the
    streaming smoke (os.fsync'd so a concurrent tailer sees the bytes)."""
    with open(path, "a") as f:
        for i in range(start, stop):
            cells = ([f"{ds.labels[i]:.0f}"]
                     + [f"{x:.6f}" for x in ds.dense[i]]
                     + [str(int(x)) for x in ds.ids[i]])
            f.write("\t".join(cells) + "\n")
        f.flush()
        os.fsync(f.fileno())
