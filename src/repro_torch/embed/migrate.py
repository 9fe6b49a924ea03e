"""Host-side migration planning for the out-of-core hot/cold placement.

A port of ``repro.embed.migrate``. The synchronous ``hotcold`` step
resolves residency on the card: the O(vocab) ``slot_of``/``freq`` maps
ride in its state, admission is ranked on the card, and every cold gather
and scatter sits in the step. Residency, admission and eviction depend
only on the id stream, never on row values, so a host-side
``MigrationPlanner`` replays the same decision procedure in NumPy one step
ahead of the card, on the ``ChunkStream`` worker thread that is already
queueing batches ahead of the consumer:

    worker thread:   batch t+1 -> plan residency -> gather miss rows
                     (store-buffer first, then cold store)      | overlapped
    consumer:        dispatch device step t  <- plan t's arrays | in time

The device step (``hotcold.make_migrate_device_step``) takes fixed-shape
inputs -- ``hit``/``src``/``ls`` assembly vectors, pre-gathered miss rows,
bank-gather indices -- packed per step into one int32 array and one f32
array per group (pinned host memory on the card, copied on a side stream),
and keeps only the math whose values matter, in the same op order and
through the same kernels as the synchronous step. NumPy and the card agree
bitwise on the f32 frequency arithmetic (a multiply, then an add) and the
selection is integer and compare logic, so async runs export params
bitwise-identical to the synchronous placement.

Eviction values flow the other way with the same one-step slack: the
planner registers each write-back in the ``StoreBuffer`` at plan time
(value not yet computed), the consumer fills the step's ``EvictionHandle``
right after dispatching it (the banks copied into pinned host memory on a
side stream, with a CUDA event), and a later miss-gather of that id waits
on the handle -- on the planner's thread, never the consumer's.

Deadlock freedom: a plan may block only on handles of already emitted
steps (the transform emits one planned batch per stream item, so the
consumer can always dispatch everything a later plan waits on). That is
why ``make_transform`` requires chunks of one batch; lookahead depth is the
stream's ``buffer_size``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.builders import TrainStepBundle, dense_tower_tx
from ..core.optim import decay_catchup_rows
from ..core.tree import flatten_with_paths, tree_leaves, tree_map
from . import hotcold as hotcold_lib
from .coldstore import ColdStore, EvictionHandle, StoreBuffer

__all__ = ["MigrationPlanner", "StepPlan", "PlannedChunk",
           "make_async_hotcold_bundle", "AsyncHotCold"]

class PlanLayout:
    """Where each field's plan arrays sit in a step's packed buffers: the
    int32 array holds ``t`` and then, a field at a time, ``hit``, ``src``,
    ``ls`` (``[U]`` each), ``sel`` (``[C]``) and ``wb`` (``[U]``); each
    group's f32 array is ``[3, sum U, d]`` (miss ``w, m, v``), a field's
    rows at ``rows[f]``. The eviction banks share the row layout."""

    _INTS = ("hit", "src", "ls", "sel", "wb")

    def __init__(self, fields, caps: dict, uniq: dict):
        self.fields = list(fields)
        self.ints, self.rows = {}, {}
        off = 1
        for f in self.fields:
            for name in self._INTS:
                n = caps[f] if name == "sel" else uniq[f]
                self.ints[f, name] = slice(off, off + n)
                off += n
        self.n_ints = off
        off = 0
        for f in self.fields:
            self.rows[f] = slice(off, off + uniq[f])
            off += uniq[f]
        self.n_rows = off


class StepPlan:
    """One planned step: the device step's inputs packed in ``ints`` and
    ``floats`` (host tensors laid out by ``layout``), the eviction handle
    the consumer must ``fill`` right after dispatching, and the step's
    residency counts."""

    __slots__ = ("t", "handle", "hit_rows", "lookup_rows", "evictions",
                 "depth", "ints", "floats", "layout")

    def __init__(self, t, handle, hit_rows, lookup_rows, evictions, depth,
                 ints, floats, layout):
        self.t = t
        self.handle = handle
        self.hit_rows = hit_rows
        self.lookup_rows = lookup_rows
        self.evictions = evictions
        self.depth = depth
        self.ints = ints
        self.floats = floats
        self.layout = layout

    def fill(self, arrays: dict, event=None):
        """Hand the step's eviction banks to every store-buffer entry
        registered for this step (``EvictionHandle.fill``)."""
        self.handle.fill(arrays, event)

    def nbytes(self) -> int:
        """Bytes of the packed buffers (a step's copy to the card)."""
        return sum(x.numel() * x.element_size()
                   for x in [self.ints, *self.floats.values()])


class PlannedChunk(NamedTuple):
    """A stream item that already carries its migration plans."""

    chunk: dict
    plans: list


class MigrationPlanner:
    """Host replica of the synchronous step's residency/admission logic.

    State per field (all NumPy, all host): ``slot_ids [C]`` (id per slot,
    vocab = empty), ``slot_of [V]`` (id -> slot, -1 = cold), ``slot_ls
    [C]`` (resident rows' last-touched step -- the device hot tier carries
    no ``ls``), and ``freq [V]`` f32 under either admission policy.
    ``plan_batch`` advances this state exactly as the synchronous step
    would and emits the step's fixed-shape inputs, written into packed
    buffers (pinned host memory with ``pin``).
    """

    def __init__(self, cfg, store: ColdStore, *, capacity: int = 4096,
                 admission: str = "cumulative", half_life: int = 0,
                 pin: bool = False):
        self.cfg = cfg
        self.store = store
        self.buffer = StoreBuffer(store)
        self.caps = hotcold_lib._field_caps(cfg.vocab_sizes, capacity)
        self.vocab = {f"field_{i}": int(v)
                      for i, v in enumerate(cfg.vocab_sizes)}
        self.fields = list(self.vocab)
        self.alpha = hotcold_lib.admission_alpha(admission, half_life)
        self.pin = pin
        self.slot_ids = {f: np.full((self.caps[f],), self.vocab[f], np.int32)
                         for f in self.fields}
        self.slot_of = {f: np.full((self.vocab[f],), -1, np.int32)
                        for f in self.fields}
        self.slot_ls = {f: np.zeros((self.caps[f],), np.int32)
                        for f in self.fields}
        self.freq = {f: np.zeros((self.vocab[f],), np.float32)
                     for f in self.fields}
        self.t = 0                    # steps planned so far
        self.plan_seconds = 0.0       # planner busy time (overlap metric)
        self.hit_rows = 0.0
        self.lookup_rows = 0.0
        self.evictions = 0
        self._layouts: dict = {}

    def _unique_cap(self, f: str, batch: int) -> int:
        """Replicates models.embedding.batch_unique's capacity rule."""
        ucap = getattr(self.cfg, "unique_capacity", 0)
        v = self.vocab[f]
        return min(batch, v) if ucap <= 0 else min(int(ucap), v)

    def layout(self, batch: int) -> PlanLayout:
        if batch not in self._layouts:
            self._layouts[batch] = PlanLayout(
                self.fields, self.caps,
                {f: self._unique_cap(f, batch) for f in self.fields})
        return self._layouts[batch]

    def _buffer(self, shape, dtype):
        out = torch.empty(shape, dtype=dtype, pin_memory=self.pin)
        return out.zero_()

    def plan_batch(self, ids: np.ndarray) -> StepPlan:
        """Plan one step from its ``[batch, n_fields]`` id matrix."""
        t0 = time.perf_counter()
        ids = np.asarray(ids)
        t = self.t + 1
        lay = self.layout(ids.shape[0])
        ints = self._buffer((lay.n_ints,), torch.int32)
        floats = {g: self._buffer(
            (3, lay.n_rows, self.store.w[g][self.fields[0]].shape[1]),
            torch.float32) for g in self.store.groups}
        ints_np = ints.numpy()
        ints_np[0] = t
        handle = EvictionHandle()
        dev = {k: {} for k in ("hit", "src", "ls", "sel", "wb")}
        for i, k in enumerate(("miss_w", "miss_m", "miss_v")):
            dev[k] = {g: {f: floats[g].numpy()[i, lay.rows[f]]
                          for f in self.fields} for g in self.store.groups}
        hit_rows = lookup_rows = 0.0
        evictions = depth = 0
        for i, f in enumerate(self.fields):
            h, l, e, d = self._plan_field(f, np.asarray(ids[:, i]), t,
                                          handle, dev)
            hit_rows += h
            lookup_rows += l
            evictions += e
            depth = max(depth, d)
            for name in PlanLayout._INTS:
                ints_np[lay.ints[f, name]] = dev[name][f]
        self.t = t
        self.hit_rows += hit_rows
        self.lookup_rows += lookup_rows
        self.evictions += evictions
        # opportunistically settle evictions whose step has completed
        self.buffer.drain(ready_only=True)
        self.plan_seconds += time.perf_counter() - t0
        return StepPlan(t, handle, hit_rows, lookup_rows, evictions, depth,
                        ints, floats, lay)

    def _plan_field(self, f, col, t, handle, dev):
        V, C = self.vocab[f], self.caps[f]
        U = self._unique_cap(f, col.shape[0])

        # dedup -- np.unique and the step's dedup agree: sorted ascending
        # uids, pads hold V with count 0
        uids_r, counts_r = np.unique(col, return_counts=True)
        if uids_r.shape[0] > U:
            raise ValueError(
                f"{f}: {uids_r.shape[0]} distinct ids exceed the unique "
                f"capacity {U}; the async hotcold path needs "
                "cfg.unique_capacity <= 0 (per-batch dedup)")
        n = uids_r.shape[0]
        uids = np.full((U,), V, np.int32)
        counts = np.zeros((U,), np.float32)
        uids[:n] = uids_r
        counts[:n] = counts_r
        touched = counts > 0

        # residency lookup against the host maps
        slot = self.slot_of[f][np.minimum(uids, V - 1)]
        hit = touched & (slot >= 0)
        src = np.maximum(slot, 0).astype(np.int32)

        # frequency update -- f32 in place, a multiply and then an add, so
        # it rounds as the synchronous step does on the card
        freq = self.freq[f]
        if self.alpha is not None:
            np.multiply(freq, self.alpha, out=freq)
        freq[uids[:n]] += counts[:n]

        # assembly ls (rows caught up through t-1): hits from the live
        # slot_ls, misses filled below from the gather
        ls_rows = np.zeros((U,), np.int32)
        ls_rows[hit] = self.slot_ls[f][src[hit]]

        # candidate ranking -- the synchronous step's selection: top-C
        # valid candidates under (freq desc, id asc); valid ids are unique
        # so the order is strict. lexsort's secondary key breaks f32-equal
        # priorities by ascending id, as the step's int64 keys do
        # (non-negative f32: value order == bit order).
        tslot = np.zeros((C,), bool)
        tslot[src[hit]] = True
        res_cand = np.where(tslot, V, self.slot_ids[f]).astype(np.int32)
        fresh = np.where(touched, uids, V).astype(np.int32)
        cand = np.concatenate([res_cand, fresh])
        valid = cand < V
        prio = np.where(valid, freq[np.minimum(cand, V - 1)],
                        np.float32(0.0)).astype(np.float32)
        n_cand = cand.shape[0]
        order = np.lexsort((cand, -prio))
        order = order[valid[order]]
        take = min(C, int(valid.sum()))
        kept = np.zeros((n_cand,), bool)
        kept[order[:take]] = True

        # slot order is ascending candidate position; an empty slot (and
        # an unused eviction row) gathers bank row 0, as on the card
        sel = np.flatnonzero(kept).astype(np.int32)
        sel_c = np.zeros((C,), np.int32)
        sel_c[:sel.shape[0]] = sel
        slot_new = np.full((C,), V, np.int32)
        slot_new[:sel.shape[0]] = cand[sel]

        wb = valid & ~kept
        wb_pos = np.flatnonzero(wb).astype(np.int32)
        # every write-back is a dropped candidate: <= U of them (if all C
        # survivors are residents, the dropped set is exactly the touched
        # misses) -- the same bound that sizes the step's compaction
        assert wb_pos.shape[0] <= U, (f, wb_pos.shape[0], U)
        wb_c = np.zeros((U,), np.int32)
        wb_c[:wb_pos.shape[0]] = wb_pos
        wb_ids = cand[wb_pos]
        evics = int(wb[:C].sum()) + int((wb[C:] & hit).sum())

        # eviction last-steps come off the same host bank the card gathers
        # rows from: old resident ls first, then t for fresh rows
        bank_ls = np.concatenate(
            [self.slot_ls[f], np.full((U,), t, np.int32)])
        wb_ls = bank_ls[wb_pos]
        new_slot_ls = np.zeros((C,), np.int32)
        new_slot_ls[:sel.shape[0]] = bank_ls[sel]

        # miss rows: store-buffer first (read-your-writes), then store.
        # Read *before* registering this step's write-backs -- a row both
        # missed and rejected this step must gather its pre-step value.
        miss_pos = np.flatnonzero(touched & ~hit)
        rows = self.buffer.read(f, uids[miss_pos])
        ls_rows[miss_pos] = rows["ls"]
        for g in self.store.groups:
            for k in ("w", "m", "v"):
                dev[f"miss_{k}"][g][f][miss_pos] = rows[k][g]

        self.buffer.register(f, wb_ids, wb_ls,
                             np.arange(wb_pos.shape[0], dtype=np.int32),
                             t, handle)

        # advance the residency maps exactly as the step would
        so = self.slot_of[f]
        old = self.slot_ids[f]
        so[old[old < V]] = -1
        so[cand[sel]] = np.arange(sel.shape[0], dtype=np.int32)
        self.slot_ids[f] = slot_new
        self.slot_ls[f] = new_slot_ls

        dev["hit"][f] = hit
        dev["src"][f] = src
        dev["ls"][f] = ls_rows
        dev["sel"][f] = sel_c
        dev["wb"][f] = wb_c

        d = int(np.max(np.where(touched, (t - 1) - ls_rows, 0), initial=0))
        return (float(counts[hit].sum()), float(counts.sum()), evics, d)


def _device_plan(ints, floats, lay: PlanLayout) -> dict:
    """The device step's ``plan``: views of a step's packed buffers (on
    the card, after their copy)."""
    plan = {"t": ints[0]}
    for name in PlanLayout._INTS:
        plan[name] = {}
        for f in lay.fields:
            x = ints[lay.ints[f, name]]
            plan[name][f] = (x != 0 if name == "hit" else
                             x if name == "ls" else x.long())
    for i, k in enumerate(("w", "m", "v")):
        plan[f"miss_{k}"] = {g: {f: x[i, lay.rows[f]] for f in lay.fields}
                             for g, x in floats.items()}
    return plan


class AsyncHotCold:
    """Controller behind the async hotcold ``TrainStepBundle``.

    Owns the cold store, the planner, and the split device step; the
    bundle's step/init/flush/prepare/export plus the stream transform
    factory and the stream driver are its bound methods (tests reach the
    store and planner through ``bundle.stream_driver.__self__``). The
    dense tower and the hot tier live on ``device``; the cold tables and
    the residency maps on the host.
    """

    def __init__(self, cfg, hp, *, backend: str = "mem",
                 directory: Optional[str] = None,
                 store: Optional[ColdStore] = None, capacity: int = 4096,
                 admission: str = "cumulative", half_life: int = 0,
                 r: float = 1.0, zeta: float = 1e-5, dense_tx=None,
                 clip: bool = True, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        if callable(hp.emb_lr) or callable(hp.emb_l2):
            raise ValueError(
                "async hotcold migration requires constant embedding "
                "lr/l2 (the flush settle uses the closed-form decay)")
        self.cfg = cfg
        self.backend = backend
        self.directory = directory
        self.capacity = capacity
        self.admission = admission
        self.half_life = half_life
        if dense_tx is None:
            dense_tx = dense_tower_tx(hp)
        self.dense_tx = dense_tx
        self.adam_kw = dict(lr=hp.emb_lr, l2=hp.emb_l2, b1=b1, b2=b2,
                            eps=eps)
        self.device_step = hotcold_lib.make_migrate_device_step(
            cfg, hp, r=r, zeta=zeta, dense_tx=dense_tx, clip=clip,
            b1=b1, b2=b2, eps=eps)
        self.store = store
        self.planner: Optional[MigrationPlanner] = None
        self.device: Optional[torch.device] = None
        self._prepared = threading.Event()
        self._sidecar = None
        self._copy_stream = None
        # (event, host tensors) of asynchronous copies through pinned
        # memory not yet known to have finished: each buffer stays
        # referenced here until its copy's event has completed
        self._in_flight: list = []
        self.last_stream_stats: Optional[dict] = None
        # rows a flush settles (and moves to and from the device) at once
        self.settle_chunk_rows = 1 << 21

    # -- bundle hooks -------------------------------------------------------

    def bundle(self) -> TrainStepBundle:
        return TrainStepBundle(
            step=self.step, init=self.init, flush=self.flush,
            prepare=self.prepare, export=self.export,
            stream_transform=self.make_transform,
            stream_driver=self.drive)

    def prepare(self, params):
        """Attach (or create) the cold store and the planner on the
        device of ``params["dense"]``; return the params tree with the
        embed leaves replaced by zero-copy CPU views of the store."""
        self.device = tree_leaves(params["dense"])[0].device
        if self.store is None:
            meta = (os.path.join(self.directory, "meta.json")
                    if self.directory else None)
            if (self.backend == "mmap" and meta is not None
                    and os.path.exists(meta)):
                self.store = ColdStore.open(self.directory)
            else:
                self.store = ColdStore.from_params(
                    tree_map(lambda t: t.detach().cpu().numpy(),
                             params["embed"]),
                    backend=self.backend, directory=self.directory)
        elif not self.store.populated:
            for g, tables in params["embed"].items():
                for f, tbl in tables.items():
                    self.store.w[g][f][...] = tbl.detach().cpu().numpy()
            self.store.populated = True
        self.planner = MigrationPlanner(
            self.cfg, self.store, capacity=self.capacity,
            admission=self.admission, half_life=self.half_life,
            pin=self.device.type == "cuda")
        dense = params["dense"]
        if self.store.resumed:
            self._sidecar = self.store.load_sidecar()
            if self._sidecar is not None:
                pl = self.planner
                pl.t = int(self._sidecar["t"])
                for f in pl.fields:
                    pl.slot_ids[f][...] = self._sidecar[f"slot_ids/{f}"]
                    pl.slot_of[f][...] = self._sidecar[f"slot_of/{f}"]
                    pl.slot_ls[f][...] = self._sidecar[f"slot_ls/{f}"]
                    pl.freq[f][...] = self._sidecar[f"freq/{f}"]
                dense = self._from_sidecar("dense_param", dense)
        self._prepared.set()
        return {"embed": self._views(), "dense": dense}

    def _views(self) -> dict:
        return tree_map(torch.from_numpy, self.store.param_views())

    def _from_sidecar(self, prefix: str, template):
        from ..train.checkpoint import _fill_like

        flat = {k[len(prefix) + 1:]: v for k, v in self._sidecar.items()
                if k.startswith(prefix + "/")}
        return _fill_like(template, flat, "the cold store's resume sidecar")

    def _hot_from_store(self, hot=None):
        """The hot tier gathered from the store's tables at the planner's
        slot ids (empty slots read row ``vocab - 1``): new tensors on the
        device, or copied into ``hot``'s."""
        pl, store = self.planner, self.store
        out = {k: {g: {} for g in store.groups} for k in ("w", "m", "v")}
        for k, tables in (("w", store.w), ("m", store.m), ("v", store.v)):
            for g in store.groups:
                for f in store.fields:
                    sid_c = np.minimum(pl.slot_ids[f], pl.vocab[f] - 1)
                    rows = torch.from_numpy(np.asarray(tables[g][f][sid_c]))
                    if hot is None:
                        out[k][g][f] = rows.to(self.device)
                    else:
                        hot[k][g][f].copy_(rows)
        return out if hot is None else hot

    def init(self, params):
        dense_opt = self.dense_tx.init(params["dense"])
        if self._sidecar is not None:
            dense_opt = self._from_sidecar("dense_opt", dense_opt)
        pl, store = self.planner, self.store
        if store.resumed:
            hot = self._hot_from_store()
        else:
            hot = {k: {g: {f: torch.zeros(
                (pl.caps[f], store.w[g][f].shape[1]), device=self.device)
                for f in store.fields} for g in store.groups}
                for k in ("w", "m", "v")}
        return {"step": pl.t, "hot": hot, "dense": dense_opt}

    def _hold(self, event, tensors):
        """Keep the host buffers of an asynchronous copy alive until the
        copy's ``event`` has completed (dropping those of finished
        copies)."""
        self._in_flight = [(e, t) for e, t in self._in_flight
                           if not e.query()]
        self._in_flight.append((event, tensors))

    def _stage(self, plan: StepPlan, chunk: dict, i: int = 0):
        """The plan's packed buffers and batch ``i`` of ``chunk`` on the
        device: on the card copied from pinned memory on a side stream,
        which the current stream then waits for; the pinned buffers are
        held until that copy's event. Returns ``(plan views, batch)``."""
        batch = {k: torch.as_tensor(np.ascontiguousarray(v[i]))
                 for k, v in chunk.items()}
        if self.device.type != "cuda":
            return _device_plan(plan.ints, plan.floats, plan.layout), batch
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        host = {"ints": plan.ints, **{f"floats/{g}": x
                                      for g, x in plan.floats.items()},
                **{f"batch/{k}": v.pin_memory() for k, v in batch.items()}}
        with torch.cuda.stream(self._copy_stream):
            on_card = {k: v.to(self.device, non_blocking=True)
                       for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        self._hold(event, list(host.values()))
        current = torch.cuda.current_stream(self.device)
        current.wait_event(event)
        for x in on_card.values():
            x.record_stream(current)
        floats = {g: on_card[f"floats/{g}"] for g in plan.floats}
        return (_device_plan(on_card["ints"], floats, plan.layout),
                {k: on_card[f"batch/{k}"] for k in batch})

    def _dispatch(self, dense_params, state, plan: StepPlan, chunk: dict,
                  i: int = 0):
        """Run one planned step on the device and fill its eviction handle
        (on the card through an asynchronous copy into pinned memory);
        nothing here waits for the card. Returns the step's loss (on the
        device) and the bytes of its eviction banks."""
        dplan, batch = self._stage(plan, chunk, i)
        evict, aux = self.device_step(dense_params, state["dense"],
                                      state["hot"], batch, dplan)
        lay = plan.layout
        if self.device.type == "cuda":
            current = torch.cuda.current_stream(self.device)
            host = {g: torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    for g, x in evict.items()}
            self._copy_stream.wait_stream(current)
            with torch.cuda.stream(self._copy_stream):
                for g, x in evict.items():
                    host[g].copy_(x, non_blocking=True)
                    x.record_stream(self._copy_stream)
                event = torch.cuda.Event()
                event.record(self._copy_stream)
            self._hold(event, list(host.values()))
        else:
            host, event = evict, None
        plan.fill({k: {g: {f: x.numpy()[i_k, lay.rows[f]]
                           for f in lay.fields} for g, x in host.items()}
                   for i_k, k in enumerate(("w", "m", "v"))}, event)
        return aux["loss"], sum(x.numel() * x.element_size()
                                for x in evict.values())

    def step(self, params, state, batch):
        """Inline (plan-then-dispatch) step -- the overlap-off path, and
        what the epoch driver calls. Bitwise identical to the overlapped
        driver: planning order is the same, only the timing differs. The
        batch's ids are read on the host for the planner."""
        host = {k: v.cpu().numpy()[None] for k, v in batch.items()}
        plan = self.planner.plan_batch(host["ids"][0])
        loss, _ = self._dispatch(params["dense"], state, plan, host)
        aux = {"loss": loss,
               "catchup_depth_max": torch.tensor(plan.depth,
                                                 dtype=torch.int32),
               "hot_hit_rows": torch.tensor(plan.hit_rows,
                                            dtype=torch.float32),
               "hot_lookup_rows": torch.tensor(plan.lookup_rows,
                                               dtype=torch.float32),
               "evictions": torch.tensor(plan.evictions, dtype=torch.int32)}
        return params, dict(state, step=plan.t), aux

    def make_transform(self, max_steps: Optional[int] = None) -> Callable:
        """The ChunkStream worker-thread hook: plan each chunk's batch
        before it is queued (that *is* the lookahead), and enforce the
        step budget at the source -- returning None ends the stream, so
        every planned step is consumed and every registered write-back
        gets its handle filled."""

        def transform(chunk):
            # the stream worker may reach the first chunk before the
            # consumer has called bundle.prepare(); wait for it (the
            # worker is a daemon thread, so an abandoned stream cannot
            # hang interpreter shutdown)
            self._prepared.wait()
            if self.planner is None:
                raise RuntimeError("bundle.prepare() must run before the "
                                   "stream transform plans batches")
            k = chunk["labels"].shape[0]
            if max_steps is not None:
                rem = max_steps - self.planner.t
                if rem <= 0:
                    return None
                if k > rem:
                    k = rem
                    chunk = {kk: v[:k] for kk, v in chunk.items()}
            if k != 1:
                raise ValueError(
                    "the async hotcold stream plans one batch per chunk "
                    f"(got a {k}-batch chunk): build the stream with "
                    "scan_steps=1; lookahead depth is buffer_size")
            plans = [self.planner.plan_batch(np.asarray(chunk["ids"][0]))]
            return PlannedChunk(chunk, plans)

        return transform

    def drive(self, params, state, stream, *, max_steps=None):
        """Consume a (planned or raw) chunk stream: dispatch each step,
        fill its eviction handle, keep the losses on the device. Returns
        ``(params, state, steps, stats)`` with the migration stats
        (``plan_seconds``, ``stall_seconds``,
        ``migration_overlap_fraction``, the bytes a run copies to and from
        the device, the residency counts) and the run's losses, read once
        at its end."""
        from ..train import engine as engine_lib

        pl = self.planner
        last_t = [int(state.get("step", pl.t))]
        base = (pl.plan_seconds, self.store.gather_bytes, pl.hit_rows,
                pl.lookup_rows, pl.evictions)
        losses, moved = [], [0, 0]

        def plan(batch):
            return pl.plan_batch(np.asarray(batch["ids"]))

        def dispatch(p, batch):
            loss, evict_bytes = self._dispatch(
                params["dense"], state, p,
                {k: v[None] for k, v in batch.items()})
            losses.append(loss)
            moved[0] += p.nbytes()
            moved[1] += evict_bytes
            last_t[0] = p.t

        res = engine_lib.drive_planned_stream(
            stream, plan=plan, dispatch=dispatch, max_steps=max_steps)
        losses = torch.stack(losses).tolist() if losses else []
        plan_s = pl.plan_seconds - base[0]
        overlap = 0.0
        if res.planned_ahead and plan_s > 0:
            overlap = max(0.0, min(1.0, 1.0 - res.stall_seconds / plan_s))
        stats = {
            "steps": res.steps,
            "stall_seconds": res.stall_seconds,
            "plan_seconds": plan_s,
            "migration_overlap_fraction": overlap,
            "plan_bytes_to_device": moved[0],
            "evict_bytes_from_device": moved[1],
            "cold_gather_bytes": self.store.gather_bytes - base[1],
            "hot_hit_rows": pl.hit_rows - base[2],
            "hot_lookup_rows": pl.lookup_rows - base[3],
            "evictions": pl.evictions - base[4],
            "store_buffer_pending": self.buffer_pending(),
            "losses": losses,
        }
        self.last_stream_stats = stats
        return ({"embed": params["embed"], "dense": params["dense"]},
                {"step": last_t[0], "hot": state["hot"],
                 "dense": state["dense"]}, res.steps, stats)

    def flush(self, params, state):
        """Reconcile every tier and settle all pending decay -- the async
        counterpart of the synchronous flush, bitwise identical to it:
        drain the store-buffer, scatter the hot tier home, run the
        closed-form decay over the full tables through ``t`` (on the
        device, as the synchronous flush does), re-gather the hot tier
        from the settled tables, persist the resume sidecar (mmap).
        Idempotent."""
        pl = self.planner
        store = self.store
        t = pl.t
        self.buffer.drain_all()
        for f in pl.fields:
            sid = pl.slot_ids[f]
            valid = sid < pl.vocab[f]
            rows = {"w": {}, "m": {}, "v": {},
                    "ls": pl.slot_ls[f][valid]}
            for k in ("w", "m", "v"):
                for g in store.groups:
                    rows[k][g] = state["hot"][k][g][f].cpu().numpy()[valid]
            store.scatter(f, sid[valid], rows)
        self._settle_decay(t)
        for f in pl.fields:
            store.ls[f][...] = t
            pl.slot_ls[f][...] = t
        self._hot_from_store(state["hot"])
        self._save_sidecar(params["dense"], state["dense"])
        store.flush_files()
        return ({"embed": self._views(), "dense": params["dense"]},
                {"step": t, "hot": state["hot"], "dense": state["dense"]})

    def export(self, params):
        """Canonical (placement-independent) params: copies of the
        settled cold tables on the device, and the dense tower. Export a
        *flushed* tree."""
        return {"embed": {g: {f: torch.from_numpy(
            np.array(self.store.w[g][f])).to(self.device)
            for f in self.store.fields} for g in self.store.groups},
            "dense": params["dense"]}

    # -- crash-safe snapshots ----------------------------------------------

    def export_snapshot(self, params, state) -> dict:
        """Flat NumPy leaves capturing the complete *flushed* controller
        state for the ``mem`` backend: the settled cold tables (w/m/v),
        each field's ``ls`` vector, the planner's residency and frequency
        maps, ``t``, and the dense tower's params and optimizer state
        (copied to the host synchronously), under the reference's keys.
        Call only right after ``flush`` (buffer drained, hot tier
        scattered home, ``ls`` uniform at ``t``), which makes the hot tier
        redundant: a resume regathers it from the tables, as ``flush``
        did.

        The ``mmap`` backend needs none of this: its snapshot is a copy
        of the store directory itself, whose resume sidecar ``flush``
        already persisted (``prepare``/``init`` replay it on open)."""
        from ..train.checkpoint import _to_numpy

        pl, store = self.planner, self.store
        leaves = {"t": np.int64(pl.t)}
        for f in pl.fields:
            leaves[f"slot_ids/{f}"] = np.array(pl.slot_ids[f])
            leaves[f"slot_of/{f}"] = np.array(pl.slot_of[f])
            leaves[f"slot_ls/{f}"] = np.array(pl.slot_ls[f])
            leaves[f"freq/{f}"] = np.array(pl.freq[f])
            leaves[f"ls/{f}"] = np.array(store.ls[f])
        for g in store.groups:
            for f in store.fields:
                leaves[f"cold_w/{g}/{f}"] = np.array(store.w[g][f])
                leaves[f"cold_m/{g}/{f}"] = np.array(store.m[g][f])
                leaves[f"cold_v/{g}/{f}"] = np.array(store.v[g][f])
        for prefix, tree in (("dense_param", params["dense"]),
                             ("dense_opt", state["dense"])):
            for i, leaf in enumerate(tree_leaves(tree)):
                leaves[f"{prefix}/{i}"] = np.array(_to_numpy(leaf))
        return leaves

    def import_snapshot(self, leaves, params):
        """Rebuild (params, state) from ``export_snapshot`` leaves.
        ``params`` is the freshly *prepared* tree (it supplies the dense
        tower's structure; its embed views point at this controller's
        store, whose tables are overwritten here). Returns the (params,
        state) pair the trainer resumes from: bitwise the post-flush
        state the snapshot captured, the hot tier regathered on the
        device."""
        from ..train.checkpoint import _fill_like

        pl, store = self.planner, self.store
        pl.t = int(leaves["t"])
        for f in pl.fields:
            pl.slot_ids[f][...] = leaves[f"slot_ids/{f}"]
            pl.slot_of[f][...] = leaves[f"slot_of/{f}"]
            pl.slot_ls[f][...] = leaves[f"slot_ls/{f}"]
            pl.freq[f][...] = leaves[f"freq/{f}"]
            store.ls[f][...] = leaves[f"ls/{f}"]
        for g in store.groups:
            for f in store.fields:
                store.w[g][f][...] = leaves[f"cold_w/{g}/{f}"]
                store.m[g][f][...] = leaves[f"cold_m/{g}/{f}"]
                store.v[g][f][...] = leaves[f"cold_v/{g}/{f}"]
        store.populated = True

        def from_leaves(prefix, template):
            paths = flatten_with_paths(template)
            return _fill_like(template, {
                k: leaves[f"{prefix}/{i}"] for i, k in enumerate(paths)},
                "the snapshot")

        dense = from_leaves("dense_param", params["dense"])
        dense_opt = from_leaves("dense_opt", self.dense_tx.init(dense))
        return ({"embed": self._views(), "dense": dense},
                {"step": pl.t, "hot": self._hot_from_store(),
                 "dense": dense_opt})

    # -- internals ----------------------------------------------------------

    @property
    def buffer(self) -> StoreBuffer:
        return self.planner.buffer

    def buffer_pending(self) -> int:
        return self.planner.buffer.pending() if self.planner else 0

    def _settle_decay(self, t: int):
        """``w *= (1 - lr*l2)^k`` over the full tables through step ``t``:
        ``decay_catchup_rows``, the synchronous flush's expression, on the
        device (so the two round alike), chunked by rows so a table larger
        than the device's memory settles under a bounded footprint."""
        R = self.settle_chunk_rows
        step = torch.tensor(t, dtype=torch.int32, device=self.device)
        for g in self.store.groups:
            for f in self.store.fields:
                tbl = self.store.w[g][f]
                ls = self.store.ls[f]
                for lo in range(0, tbl.shape[0], R):
                    hi = min(lo + R, tbl.shape[0])
                    w = torch.from_numpy(np.asarray(tbl[lo:hi])).to(
                        self.device)
                    caught = decay_catchup_rows(
                        w, w, w, torch.from_numpy(np.asarray(
                            ls[lo:hi])).to(self.device), step,
                        **self.adam_kw)[0]
                    tbl[lo:hi] = caught.to(w.dtype).cpu().numpy()
        self.store.flush_files()

    def _save_sidecar(self, dense_params, dense_opt):
        if self.store.backend != "mmap":
            return
        pl = self.planner
        leaves = {"t": np.int64(pl.t)}
        for f in pl.fields:
            leaves[f"slot_ids/{f}"] = pl.slot_ids[f]
            leaves[f"slot_of/{f}"] = pl.slot_of[f]
            leaves[f"slot_ls/{f}"] = pl.slot_ls[f]
            leaves[f"freq/{f}"] = pl.freq[f]
        for prefix, tree in (("dense_param", dense_params),
                             ("dense_opt", dense_opt)):
            for k, v in flatten_with_paths(tree).items():
                leaves[f"{prefix}/{k}"] = (v.detach().cpu().numpy()
                                           if isinstance(v, torch.Tensor)
                                           else np.asarray(v))
        self.store.save_sidecar(leaves)


def make_async_hotcold_bundle(cfg, hp, **kwargs) -> TrainStepBundle:
    """The async hotcold placement as a ``TrainStepBundle`` (see
    ``AsyncHotCold`` for the knobs: backend/directory/store, capacity,
    admission/half_life, and the shared clip/optimizer hypers)."""
    return AsyncHotCold(cfg, hp, **kwargs).bundle()
