"""Background prefetch of host batches on a worker thread.

A port of ``repro.data.prefetch.prefetch``, host side only: ``prefetch``
runs any host iterator on a daemon thread behind a bounded queue, so the
NumPy slicing of item *i+1* overlaps the consumer's work on item *i*.
Closing the generator early stops the worker; worker exceptions re-raise in
the consumer. Pinned staging buffers and side-stream copies come with the
CUDA-graph engine (ROADMAP queue 1 item 3).
"""

from __future__ import annotations

import queue
import threading

_DONE = object()


def prefetch(host_iter, *, buffer_size: int = 2):
    """Drive ``host_iter`` on a worker thread, yielding its items in order."""
    q: queue.Queue = queue.Queue(maxsize=max(1, buffer_size))
    stop = threading.Event()
    failure: list = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def work():
        try:
            for item in host_iter:
                if not put(item):
                    return
        except BaseException as e:  # re-raised in the consumer
            failure.append(e)
        finally:
            put(_DONE)

    worker = threading.Thread(target=work, daemon=True,
                              name="repro-torch-prefetch")
    worker.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                break
            yield item
        if failure:
            raise failure[0]
    finally:
        stop.set()
        # unblock a worker stuck on a full queue
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
