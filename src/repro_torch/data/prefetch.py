"""Chunked epochs and double-buffered prefetch for the training engines.

A port of ``repro.data.prefetch``. The scan engine (``train.engine``)
consumes *chunks*, K batches stacked into one ``[K, batch, ...]`` array per
field, and one CUDA graph replay covers K optimizer steps:

* ``chunk_epoch``: one epoch of stacked chunks as contiguous NumPy arrays,
  in exactly ``iterate_batches``'s shuffle order and tail rule (same seed,
  same batches in the same order, so the scan engine equals the eager
  loop bit for bit).
* ``prefetch``: runs a host iterator on a worker thread behind a bounded
  queue. Given a CUDA ``device``, the consumer's side pins each item and
  copies it to the card on a side stream, item *i+1*'s copy issued before
  item *i* is yielded, so it overlaps item *i*'s compute. The worker
  makes no CUDA call, so it can never break a graph capture on the
  consumer's thread. The compute stream waits on the copy's event before
  it uses the tensors, and each device tensor records its use on the
  compute stream, so the allocator cannot hand its memory out again
  before that use is done (the pinned host buffer is held the same way
  by PyTorch's pinned allocator until its copy is done). Without a device
  it yields the host items as they come, the CPU path.
* ``prefetch_chunks``: the composition the scan engine uses.
* ``stage``: the card's half of ``prefetch`` alone, for a source that has
  its worker thread already (``data.stream.ChunkStream``).

Closing the generator early (``max_steps``, errors) stops the worker;
worker exceptions re-raise in the consumer.

While a ``core.spans`` recording is on, the worker records
``prefetch.shuffle``, ``prefetch.gather`` and ``prefetch.put_blocked``
(the queue full: the consumer sets the pace); the consumer records
``prefetch.wait_worker`` (counting in ``prefetch.queue_empty`` the gets
that found the queue empty), ``prefetch.pin`` and ``prefetch.copy`` (the
bytes in ``prefetch.bytes_pinned``) and ``prefetch.close``.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ..core import spans
from .synthetic import CTRDataset, note_dropped_remainder

_DONE = object()


def chunk_epoch(
    ds: CTRDataset,
    batch_size: int,
    scan_steps: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
) -> Iterator[dict]:
    """One epoch of ``[k, batch_size, ...]`` stacked chunks (host arrays).

    ``k == scan_steps`` except possibly for the epoch's final chunk, which
    carries the leftover ``k < scan_steps`` batches (never dropped: only
    the sub-``batch_size`` row tail follows ``drop_remainder``, exactly as
    in ``iterate_batches``). A row tail that would not fill a batch is
    rejected with ``drop_remainder=False``: a captured step needs static
    batch shapes. One fancy-index per chunk gathers all ``k`` batches.
    """
    if scan_steps < 1:
        raise ValueError(f"scan_steps must be >= 1, got {scan_steps}")
    n = len(ds)
    with spans.span("prefetch.shuffle"):
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
    if drop_remainder:
        note_dropped_remainder(n, batch_size)
    n_batches = n // batch_size if drop_remainder else -(-n // batch_size)
    if not drop_remainder and n % batch_size:
        raise ValueError(
            "chunk_epoch requires drop_remainder=True (the captured step "
            f"needs static batch shapes; {n % batch_size} tail rows do not "
            "fill a batch)")
    for start in range(0, n_batches, scan_steps):
        k = min(scan_steps, n_batches - start)
        idx = order[start * batch_size:(start + k) * batch_size]
        with spans.span("prefetch.gather"):
            chunk = {
                "ids": ds.ids[idx].reshape(k, batch_size, -1),
                "dense": ds.dense[idx].reshape(k, batch_size, -1),
                "labels": ds.labels[idx].reshape(k, batch_size),
            }
        yield chunk


class _Worker:
    """Runs ``host_iter`` on a daemon thread, up to ``buffer_size`` items
    ahead of the consumer. The thread makes no CUDA call, so it can run
    through a graph capture on the consumer's thread."""

    def __init__(self, host_iter, buffer_size: int):
        self.queue: queue.Queue = queue.Queue(maxsize=max(1, buffer_size))
        self.stop = threading.Event()
        self.failure: list = []

        def work():
            try:
                for item in host_iter:
                    if not self.put(item):
                        return
            except BaseException as e:  # re-raised in the consumer
                self.failure.append(e)
            finally:
                self.put(_DONE)

        self.thread = threading.Thread(target=work, daemon=True,
                                       name="repro-torch-prefetch")
        self.thread.start()

    def put(self, item) -> bool:
        if self.stop.is_set():
            return False
        try:
            self.queue.put_nowait(item)
            return True
        except queue.Full:
            pass
        with spans.span("prefetch.put_blocked"):
            while not self.stop.is_set():
                try:
                    self.queue.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
        return False

    def items(self):
        try:
            while True:
                with spans.span("prefetch.wait_worker"):
                    try:
                        item = self.queue.get_nowait()
                    except queue.Empty:
                        spans.add("prefetch.queue_empty")
                        item = self.queue.get()
                if item is _DONE:
                    break
                yield item
            if self.failure:
                raise self.failure[0]
        finally:
            with spans.span("prefetch.close"):
                self.stop.set()
                # unblock a worker stuck on a full queue, then wait for it:
                # no thread of a closed prefetch runs on (it stops within
                # its 0.1 s put timeout once its current item is made)
                self._drain()
                self.thread.join(timeout=10.0)
                self._drain()

    def _drain(self):
        while True:
            try:
                self.queue.get_nowait()
            except queue.Empty:
                break


class _Staged:
    """One item pinned and copied to the card on ``copy_stream``, and the
    event its copy ends with. The pinned buffers stay referenced here
    until that event has completed (``done``)."""

    __slots__ = ("tensors", "event", "pinned")

    def __init__(self, item: dict, device, copy_stream):
        with spans.span("prefetch.pin"):
            self.pinned = [
                torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for v in item.values()]
        spans.add("prefetch.bytes_pinned", sum(p.nbytes for p in self.pinned))
        with spans.span("prefetch.copy"), torch.cuda.stream(copy_stream):
            self.tensors = {k: p.to(device, non_blocking=True)
                            for k, p in zip(item, self.pinned)}
            self.event = torch.cuda.Event()
            self.event.record(copy_stream)

    def done(self) -> bool:
        """The copy has finished (its pinned buffers may go)."""
        return self.event.query()

    def ready(self) -> dict:
        """The tensors, once the current stream has waited for the copy;
        each records its use on that stream."""
        stream = torch.cuda.current_stream()
        stream.wait_event(self.event)
        for t in self.tensors.values():
            t.record_stream(stream)
        return self.tensors


def stage(items, device: torch.device):
    """Yield ``items`` (dicts of NumPy arrays) as dicts of tensors on the
    CUDA ``device``, each pinned and copied on a side stream one item
    ahead of the consumer, on the consumer's thread."""
    stream = torch.cuda.Stream(device)
    pending = None
    in_flight = []        # staged items whose copies may still run
    for item in items:
        staged = _Staged(item, device, stream)
        in_flight = [s for s in in_flight if not s.done()] + [staged]
        if pending is not None:
            yield pending.ready()
        pending = staged
    if pending is not None:
        yield pending.ready()


def prefetch(host_iter, *, buffer_size: int = 2,
             device: Optional[torch.device] = None):
    """Drive ``host_iter`` (items: dicts of NumPy arrays when ``device`` is
    a CUDA device) on a worker thread, yielding its items in order; on a
    CUDA ``device``, as dicts of tensors on it, each pinned and copied on a
    side stream one item ahead of the consumer (``stage``)."""
    if device is None or torch.device(device).type != "cuda":
        yield from _Worker(host_iter, buffer_size).items()
        return
    items = _Worker(host_iter, buffer_size).items()
    try:
        yield from stage(items, torch.device(device))
    finally:
        items.close()


def prefetch_chunks(
    ds: CTRDataset,
    batch_size: int,
    scan_steps: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    buffer_size: int = 2,
    device: Optional[torch.device] = None,
) -> Iterator[dict]:
    """One epoch of ``[k, batch, ...]`` chunks, stacked on a background
    thread and, on a CUDA ``device``, copied to it ahead of consumption
    (the scan engine's input pipeline)."""
    return prefetch(
        chunk_epoch(ds, batch_size, scan_steps, shuffle=shuffle, seed=seed,
                    drop_remainder=drop_remainder),
        buffer_size=buffer_size, device=device)
