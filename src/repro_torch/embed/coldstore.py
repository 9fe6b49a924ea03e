"""Out-of-core cold tier for the hot/cold streaming placement.

A port of ``repro.embed.coldstore``, host NumPy like the reference. The
synchronous ``hotcold`` placement keeps the cold tier inside the step, on
the card: every miss-gather and eviction write-back sits on the step's
critical path, and vocab is bounded by device memory. This module takes
the cold tier out of the step -- the shape of a hierarchical HBM/MEM/SSD
parameter server (arXiv:2201.05500):

* ``ColdStore`` -- the host-side backing store holding, per embedding
  group and field, the full ``(w, m, v)`` tables plus one ``last_step``
  column per field. Two backends: ``"mem"`` (plain numpy, host RAM) and
  ``"mmap"`` (``np.memmap`` files in a directory -- vocab is then bounded
  by *disk*, not RAM, and a training run can flush, exit, reopen the
  directory and resume bit-exactly). The on-disk layout is the JAX
  package's own (one ``.npy`` per array plus ``meta.json``), so a
  directory written by either package opens in the other.
* ``StoreBuffer`` -- the store-buffer between the training step's eviction
  stream and the cold store. Evicted rows leave the card *lazily* (the
  step's eviction banks come back through an asynchronous copy into
  pinned host memory, ``EvictionHandle``); the buffer holds one pending
  entry per (field, id) -- the newest write wins -- and every cold-tier
  read goes through ``read``, which consults the buffer *first*
  (read-your-writes: step ``i+1``'s miss-gather observes step ``i``'s
  evictions even though neither has reached the store's arrays yet).
  ``drain`` settles ready entries into the store; correctness never
  depends on when, because reads hit the buffer until the pop, and the pop
  happens only after the store write completes.

Why a single newest entry per id suffices: an id evicted at step ``s1``
and again at ``s2 > s1`` had to be *re-admitted* (miss-gathered) in
between, and that gather read the ``s1`` entry -- so the ``s2`` value
already incorporates it and the superseded entry can be dropped
unwritten.

``save_sidecar``/``load_sidecar`` persist the planner/optimizer leaves a
resume needs. ``advise_dontneed`` drops the resident pages of a flushed
mmap store (``MADV_DONTNEED`` on a shared file mapping is safe -- the data
lives in the files), which keeps peak RSS bounded on a vocab larger than
RAM.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np

from ..core import durable

logger = logging.getLogger(__name__)

__all__ = ["ColdStore", "StoreBuffer", "EvictionHandle", "COLD_BACKENDS"]

COLD_BACKENDS = ("mem", "mmap")

_META = "meta.json"
_SIDECAR = "resume.npz"


def _npy_name(kind: str, g: Optional[str], f: str) -> str:
    return f"{kind}__{g}__{f}.npy" if g is not None else f"{kind}__{f}.npy"


class ColdStore:
    """Full-table host/disk tier: ``w/m/v`` per (group, field), ``ls`` per
    field (groups see the same ids at the same steps, so one last-step
    column serves both). Construct via ``from_params`` (copy an existing
    ``params["embed"]`` tree), ``create`` + ``initialize_random`` (chunked
    init for tables too big to materialize), or ``open`` (reattach to an
    existing mmap directory)."""

    def __init__(self, backend: str, directory: Optional[str] = None):
        if backend not in COLD_BACKENDS:
            raise ValueError(f"unknown cold-store backend {backend!r}; "
                             f"expected one of {COLD_BACKENDS}")
        if backend == "mmap" and not directory:
            raise ValueError("mmap cold store needs a directory")
        self.backend = backend
        self.directory = directory
        self.groups: list = []
        self.fields: list = []
        self.vocab: Dict[str, int] = {}
        self.w: Dict[str, dict] = {}
        self.m: Dict[str, dict] = {}
        self.v: Dict[str, dict] = {}
        self.ls: Dict[str, np.ndarray] = {}
        self.populated = False   # tables hold real rows
        self.resumed = False     # reattached to an existing directory
        self.gather_bytes = 0
        self.scatter_bytes = 0
        # transient-I/O retry policy: every row-traffic entry point
        # (gather/scatter/flush_files) retries an OSError up to
        # ``io_retries`` times with exponential backoff starting at
        # ``io_backoff`` seconds. The operations are idempotent (pure
        # reads / full-row overwrites), so a retry after a partial
        # failure rewrites the same values. ``fault_hook``, when set, is
        # called with the op name at the top of each attempt; raising
        # OSError there takes the retry path a real I/O error takes.
        self.io_retries = 3
        self.io_backoff = 0.01
        self.faults_retried = 0
        self.fault_hook: Optional[Callable[[str], None]] = None

    def _io(self, op: str, fn: Callable):
        """Run one idempotent I/O operation under the bounded-retry /
        exponential-backoff policy; re-raise after ``io_retries``
        failed retries."""
        delay = self.io_backoff
        for attempt in range(self.io_retries + 1):
            try:
                if self.fault_hook is not None:
                    self.fault_hook(op)
                return fn()
            except OSError as e:
                if attempt == self.io_retries:
                    raise
                self.faults_retried += 1
                logger.warning(
                    "[coldstore] transient %s error (%s); retry %d/%d "
                    "after %.3fs", op, e, attempt + 1, self.io_retries,
                    delay)
                time.sleep(delay)
                delay *= 2

    # -- construction -------------------------------------------------------

    @classmethod
    def from_params(cls, embed_params, *, backend: str = "mem",
                    directory: Optional[str] = None) -> "ColdStore":
        """Copy a ``params["embed"]`` tree ({group: {field: [V, d]}}) into a
        fresh store; m/v/ls start at zero (a fresh optimizer)."""
        spec = {g: {f: (int(t.shape[0]), int(t.shape[1]),
                        str(np.asarray(t[:0]).dtype))
                    for f, t in tables.items()}
                for g, tables in embed_params.items()}
        store = cls.create(spec, backend=backend, directory=directory)
        for g, tables in embed_params.items():
            for f, t in tables.items():
                store.w[g][f][...] = np.asarray(t)
        store.populated = True
        store.flush_files()
        return store

    @classmethod
    def create(cls, spec: Dict[str, Dict[str, tuple]], *, backend: str = "mem",
               directory: Optional[str] = None) -> "ColdStore":
        """Allocate empty tables from ``{group: {field: (vocab, dim,
        dtype)}}`` without materializing any data in RAM (mmap backend)."""
        store = cls(backend, directory)
        store.groups = list(spec.keys())
        first = spec[store.groups[0]]
        store.fields = list(first.keys())
        store.vocab = {f: int(first[f][0]) for f in store.fields}
        if backend == "mmap":
            os.makedirs(directory, exist_ok=True)
            # atomic + fsync'd: ``open`` keys resumability off this file,
            # so a crash mid-create must leave either no meta.json or a
            # complete one — never a torn prefix
            durable.atomic_write_bytes(
                os.path.join(directory, _META),
                json.dumps({"version": 1, "spec": spec}).encode())
        for g in store.groups:
            store.w[g], store.m[g], store.v[g] = {}, {}, {}
            for f, (vocab, dim, dtype) in spec[g].items():
                store.w[g][f] = store._alloc("w", g, f, (vocab, dim), dtype)
                store.m[g][f] = store._alloc("m", g, f, (vocab, dim),
                                             "float32")
                store.v[g][f] = store._alloc("v", g, f, (vocab, dim),
                                             "float32")
        for f in store.fields:
            store.ls[f] = store._alloc("ls", None, f, (store.vocab[f],),
                                       "int32")
        return store

    @classmethod
    def open(cls, directory: str) -> "ColdStore":
        """Reattach to an existing mmap store directory (flushed earlier).
        ``load_sidecar`` returns whatever resume state the flush saved."""
        with open(os.path.join(directory, _META)) as fp:
            meta = json.load(fp)
        spec = {g: {f: tuple(s) for f, s in tables.items()}
                for g, tables in meta["spec"].items()}
        store = cls(directory=directory, backend="mmap")
        store.groups = list(spec.keys())
        first = spec[store.groups[0]]
        store.fields = list(first.keys())
        store.vocab = {f: int(first[f][0]) for f in store.fields}
        for g in store.groups:
            store.w[g], store.m[g], store.v[g] = {}, {}, {}
            for f in store.fields:
                store.w[g][f] = store._attach("w", g, f)
                store.m[g][f] = store._attach("m", g, f)
                store.v[g][f] = store._attach("v", g, f)
        for f in store.fields:
            store.ls[f] = store._attach("ls", None, f)
        store.populated = True
        store.resumed = True
        return store

    def _alloc(self, kind, g, f, shape, dtype):
        if self.backend == "mem":
            return np.zeros(shape, dtype)
        return np.lib.format.open_memmap(
            os.path.join(self.directory, _npy_name(kind, g, f)),
            mode="w+", dtype=np.dtype(dtype), shape=shape)

    def _attach(self, kind, g, f):
        return np.load(os.path.join(self.directory, _npy_name(kind, g, f)),
                       mmap_mode="r+")

    def initialize_random(self, sigma: Dict[str, float], *, seed: int = 0,
                          chunk_rows: int = 1 << 18):
        """Chunked N(0, sigma_g) init of the weight tables — never holds
        more than ``chunk_rows`` rows in RAM, so a >RAM vocab initializes
        with bounded peak RSS (pages are flushed and dropped per chunk)."""
        rng = np.random.default_rng(seed)
        for g in self.groups:
            for f in self.fields:
                tbl = self.w[g][f]
                for lo in range(0, tbl.shape[0], chunk_rows):
                    hi = min(lo + chunk_rows, tbl.shape[0])
                    tbl[lo:hi] = rng.normal(
                        0.0, sigma[g], size=(hi - lo, tbl.shape[1])
                    ).astype(tbl.dtype)
                self.flush_files()
                self.advise_dontneed()
        self.populated = True

    # -- row traffic --------------------------------------------------------

    def gather(self, f: str, ids: np.ndarray) -> dict:
        """Rows ``{"w"|"m"|"v": {group: [n, d]}, "ls": [n]}`` for one
        field's ids (host fancy-indexing; mmap pages fault in on demand).
        Retries transient OSErrors (a faulted-in page can fail on a
        flaky disk) under the bounded-backoff policy."""
        ids = np.asarray(ids, np.int64)

        def read():
            out = {"w": {}, "m": {}, "v": {},
                   "ls": np.asarray(self.ls[f][ids])}
            nbytes = out["ls"].nbytes
            for g in self.groups:
                out["w"][g] = np.asarray(self.w[g][f][ids])
                out["m"][g] = np.asarray(self.m[g][f][ids])
                out["v"][g] = np.asarray(self.v[g][f][ids])
                nbytes += (out["w"][g].nbytes + out["m"][g].nbytes
                           + out["v"][g].nbytes)
            return out, nbytes

        out, nbytes = self._io("gather", read)
        self.gather_bytes += nbytes
        return out

    def scatter(self, f: str, ids: np.ndarray, rows: dict):
        """Write rows back (the drain side of the store-buffer). Full-row
        overwrites are idempotent, so the transient-OSError retry simply
        rewrites the same values."""
        ids = np.asarray(ids, np.int64)

        def write():
            nbytes = 0
            for g in self.groups:
                self.w[g][f][ids] = rows["w"][g]
                self.m[g][f][ids] = rows["m"][g]
                self.v[g][f][ids] = rows["v"][g]
                nbytes += (rows["w"][g].nbytes + rows["m"][g].nbytes
                           + rows["v"][g].nbytes)
            self.ls[f][ids] = rows["ls"]
            return nbytes

        nbytes = self._io("scatter", write)
        self.scatter_bytes += nbytes + np.asarray(rows["ls"]).nbytes
        return nbytes

    def param_views(self) -> dict:
        """The ``params["embed"]``-shaped tree of live weight tables —
        zero-copy views (mmap: pages fault in only where read)."""
        return {g: {f: self.w[g][f] for f in self.fields}
                for g in self.groups}

    def table_bytes(self) -> int:
        total = sum(a.size * a.dtype.itemsize
                    for g in self.groups for a in
                    (*self.w[g].values(), *self.m[g].values(),
                     *self.v[g].values()))
        return total + sum(a.size * a.dtype.itemsize
                           for a in self.ls.values())

    # -- persistence / paging -----------------------------------------------

    def flush_files(self):
        """msync every memmap (no-op for the mem backend); transient
        OSErrors retry under the bounded-backoff policy (msync is
        idempotent)."""
        if self.backend != "mmap":
            return

        def sync():
            for arr in self._arrays():
                if isinstance(arr, np.memmap):
                    arr.flush()

        self._io("flush_files", sync)

    def advise_dontneed(self):
        """Drop resident pages of a *flushed* mmap store (MADV_DONTNEED on
        a shared file mapping re-reads from the file, losing nothing).
        This is the RSS bound for >RAM vocabs; no-op for mem."""
        if self.backend != "mmap":
            return
        import mmap as mmap_mod

        for arr in self._arrays():
            mm = getattr(arr, "_mmap", None)
            if mm is not None:
                try:
                    mm.madvise(mmap_mod.MADV_DONTNEED)
                except (AttributeError, OSError):  # non-linux: best effort
                    return

    def close(self):
        self.flush_files()
        self.w.clear(), self.m.clear(), self.v.clear(), self.ls.clear()
        self.populated = False

    def _arrays(self) -> Iterable[np.ndarray]:
        for g in self.groups:
            yield from self.w[g].values()
            yield from self.m[g].values()
            yield from self.v[g].values()
        yield from self.ls.values()

    def save_sidecar(self, leaves: Dict[str, np.ndarray]):
        """Persist resume leaves (planner state + dense params/opt) next to
        the tables. Keys are caller-defined; ``load_sidecar`` returns them
        verbatim. No-op for the mem backend (nothing outlives the
        process)."""
        if self.backend != "mmap":
            return
        # atomic + fsync'd: a crash mid-save leaves the previous complete
        # sidecar, so a reopened store always resumes from *some*
        # flush-consistent state
        durable.atomic_write_via(
            os.path.join(self.directory, _SIDECAR),
            lambda f: np.savez(
                f, **{k: np.asarray(v) for k, v in leaves.items()}))

    def load_sidecar(self) -> Optional[Dict[str, np.ndarray]]:
        if self.backend != "mmap":
            return None
        path = os.path.join(self.directory, _SIDECAR)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return {k: z[k] for k in z.files}


class EvictionHandle:
    """A step's eviction banks, filled *after* the step is dispatched.

    The planner registers write-backs at plan time -- before the card has
    computed (or even been asked to compute) the evicted values -- so
    buffer entries point at a handle the consumer later ``fill``s with
    the step's ``[U, d]`` host eviction banks: on the card, views of
    pinned buffers that an asynchronous copy is still filling, with the
    CUDA event that copy ends with. ``rows`` blocks until filled, then
    waits on that event, on the calling thread (the planner's: the
    consumer never blocks on the card for it)."""

    __slots__ = ("_filled", "_arrays", "_event")

    def __init__(self):
        self._filled = threading.Event()
        self._arrays = None
        self._event = None

    def fill(self, arrays: dict, event=None):
        """``arrays``: {"w"|"m"|"v": {group: {field: [U, d] host array}}},
        final once ``event`` (a ``torch.cuda.Event``; None when they are
        final already) has completed."""
        self._arrays = arrays
        self._event = event
        self._filled.set()

    def ready(self) -> bool:
        """Filled, and its copy off the card done: ``rows`` will not
        block."""
        return self._filled.is_set() and (self._event is None
                                          or self._event.query())

    def rows(self, f: str, timeout: Optional[float] = None) -> dict:
        if not self._filled.wait(timeout):
            raise TimeoutError(
                "eviction handle never filled -- the step that evicts these "
                "rows was planned but not dispatched")
        if self._event is not None:
            self._event.synchronize()
        return {k: {g: self._arrays[k][g][f] for g in self._arrays[k]}
                for k in ("w", "m", "v")}


class StoreBuffer:
    """Pending write-backs between eviction and the cold store, newest
    entry per (field, id). ``read`` = read-your-writes lookup (buffer
    first, then store); ``drain`` writes ready entries to the store and
    pops them (write before pop, so a concurrent read never misses).
    Rows move in one fancy-indexed copy per (field, handle)."""

    def __init__(self, store: ColdStore):
        self.store = store
        self._lock = threading.Lock()
        self._entries: Dict[str, dict] = {f: {} for f in store.fields}
        self.hits = 0          # reads served from the buffer

    def pending(self) -> int:
        with self._lock:
            return sum(len(d) for d in self._entries.values())

    def register(self, f: str, ids: np.ndarray, ls: np.ndarray,
                 row_idx: np.ndarray, step: int, handle: EvictionHandle):
        """Record this step's write-backs for one field: ``ids[k]``'s raw
        row will be row ``row_idx[k]`` of the step's eviction bank
        (``handle``), with last-step ``ls[k]``. Newest registration for an
        id supersedes an older pending one (see the module docstring)."""
        entries = [(step, handle, k, s) for k, s in zip(
            np.asarray(row_idx).tolist(), np.asarray(ls).tolist())]
        with self._lock:
            self._entries[f].update(zip(np.asarray(ids).tolist(), entries))

    def _copy_rows(self, f: str, items, out: dict):
        """``out[key][g][k] = `` its bank row, for every ``(k, entry)`` of
        ``items``: one fancy-indexed copy per handle."""
        by_handle: Dict[int, list] = {}
        for k, e in items:
            by_handle.setdefault(id(e[1]), []).append((k, e))
        for group in by_handle.values():
            rows = group[0][1][1].rows(f)
            ks = np.asarray([k for k, _ in group], np.int64)
            src = np.asarray([e[2] for _, e in group], np.int64)
            for key in ("w", "m", "v"):
                for g in self.store.groups:
                    out[key][g][ks] = rows[key][g][src]

    def read(self, f: str, ids: np.ndarray) -> dict:
        """Gather rows for ids, observing every pending write (blocking on
        unfilled handles -- they belong to an already-planned step the
        consumer is about to dispatch)."""
        ids = np.asarray(ids, np.int64)
        out = self.store.gather(f, ids)
        ent = self._entries[f]
        with self._lock:
            pend = [(k, ent[i]) for k, i in enumerate(ids.tolist())
                    if i in ent]
        if pend:
            self._copy_rows(f, pend, out)
            out["ls"][[k for k, _ in pend]] = [e[3] for _, e in pend]
            self.hits += len(pend)
        return out

    def drain(self, *, upto_step: Optional[int] = None,
              ready_only: bool = True) -> int:
        """Settle pending entries into the store. ``ready_only`` skips
        entries whose handle is not ready (their step, or its copy off the
        card, is still in flight); ``upto_step`` bounds how fresh an entry
        may be. Each entry is written to the store *before* it is popped,
        and popped only if still current (a racing re-registration
        wins)."""
        ready: Dict[int, bool] = {}

        def take(e):
            if upto_step is not None and e[0] > upto_step:
                return False
            if not ready_only:
                return True
            if id(e[1]) not in ready:
                ready[id(e[1])] = e[1].ready()
            return ready[id(e[1])]

        with self._lock:
            work = {f: [(i, e) for i, e in ent.items() if take(e)]
                    for f, ent in self._entries.items()}
        n = 0
        for f, items in work.items():
            if not items:
                continue
            ids = np.asarray([i for i, _ in items], np.int64)
            rows = {"w": {}, "m": {}, "v": {},
                    "ls": np.asarray([e[3] for _, e in items], np.int32)}
            for key, tables in (("w", self.store.w), ("m", self.store.m),
                                ("v", self.store.v)):
                for g in self.store.groups:
                    rows[key][g] = np.empty(
                        (len(items), tables[g][f].shape[1]),
                        tables[g][f].dtype)
            self._copy_rows(f, list(enumerate(e for _, e in items)), rows)
            self.store.scatter(f, ids, rows)
            with self._lock:
                ent = self._entries[f]
                for i, e in items:
                    if ent.get(i) is e:      # not superseded meanwhile
                        del ent[i]
            n += len(items)
        return n

    def drain_all(self) -> int:
        """Blocking full drain (flush/teardown): waits on every handle."""
        return self.drain(ready_only=False)
