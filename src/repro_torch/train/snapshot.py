"""Crash-safe training snapshots: atomic capture, checksummed manifests,
exact resume.

A port of ``repro.train.snapshot``, in the reference's on-disk format, so
a snapshot written by either package resumes in the other. A snapshot is
a *directory* ``snap-NNNNNNNN/`` under the snapshot root, holding the
complete state a trainer needs to continue as if the process had never
died:

* ``canonical.npz`` — the placement-independent exported params
  (``bundle.export`` of a *flushed* tree), restorable under any placement.
* ``state.npz`` — the raw, flushed optimizer state of the placement that
  wrote it, keyed by ``/``-joined tree paths like ``train.checkpoint``.
  Same-placement resume overlays it for bitwise continuation;
  cross-placement resume skips it (params-only, fresh optimizer) with a
  warning.
* ``async_hotcold.npz`` *or* ``cold_store/`` — the async hot/cold
  placement's controller state: flat leaves from
  ``AsyncHotCold.export_snapshot`` (``mem`` backend) or a verbatim copy of
  the mmap store directory, whose resume sidecar ``flush`` persisted
  (``mmap`` backend).
* ``manifest.json`` — written **last**: step, stream cursor, placement
  token, and a sha256 per payload file. A snapshot without a readable
  manifest whose checksums all verify does not exist as far as resume is
  concerned.

Atomicity is the checkpoint protocol lifted to directories: payloads are
written (and fsynced) into ``snap-NNNNNNNN.tmp/``, the manifest lands
last, the directory is fsynced, then one ``os.rename`` publishes it and
the parent directory is fsynced. A SIGKILL at any instant leaves either
the previous snapshots untouched, or a ``*.tmp`` directory (ignored and
garbage-collected), or the complete new snapshot — never a half-snapshot
that validates. ``latest_valid`` walks newest-to-oldest and skips
anything torn or bit-rotted (checksum mismatch), so a corrupted latest
snapshot falls back to the previous good one.

Exactness contract: ``capture`` flushes before exporting, and the flush
*is part of the trajectory* for the lazily-decayed placements (it settles
pending coupled-L2 decay, changing where later decay multiplications
round). Two runs therefore give bit-identical params only if they flush
at the same steps — which is why resume keeps the original
``snapshot_every`` cadence, and why the bitwise tests compare an
interrupted run against an *uninterrupted run with the same cadence*.

The port's steps write their tensors in place, and the flushes of the
sparse and hot/cold placements do too, so a captured CUDA graph stays
valid across a snapshot. The export to the host is a synchronous copy of
each tensor into pageable NumPy memory: nothing of a snapshot is read on
the host before its copy has finished.

On the sharded placements a rank holds only its row blocks. ``capture``
runs on every rank (the flush, ``export`` and the bundle's
``export_state``, which gathers m, v and ``last_step`` to the
reference's padded logical layout, are collectives, called in the same
order on every rank); only the rank that writes (``write=True``, rank 0)
copies to the host and calls ``SnapshotManager.save``, so one process
writes, rotates and collects ``*.tmp`` directories. ``resume`` runs on
every rank over the same directory: each reads the same latest valid
snapshot, ``prepare`` keeps its blocks of the canonical tables, and the
bundle's ``import_state`` keeps its blocks of the state.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from ..core import durable
from ..core.tree import flatten_with_paths, tree_leaves
from . import checkpoint

logger = logging.getLogger(__name__)

__all__ = ["SnapshotManager", "capture", "controller_of", "overlay",
           "placement_token", "resume"]

_SNAP_RE = re.compile(r"^snap-(\d{8})$")
_MANIFEST = "manifest.json"


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 22), b""):
            h.update(block)
    return h.hexdigest()


def _sha256_all(paths: list) -> list:
    """The sha256 of each file, hashed in parallel (``hashlib`` releases
    the GIL over large buffers)."""
    if len(paths) < 2:
        return [_sha256(p) for p in paths]
    with ThreadPoolExecutor(max_workers=min(8, len(paths))) as pool:
        return list(pool.map(_sha256, paths))


def _fsync_file(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _flat_numpy(tree) -> dict:
    """A tree's leaves by ``/`` path as NumPy arrays in pageable host
    memory (a tensor on the card copied synchronously; one on the CPU
    viewed, and written to disk before training goes on)."""
    return {k: checkpoint._to_numpy(v)
            for k, v in flatten_with_paths(tree).items()}


class SnapshotManager:
    """Rotating, checksummed, atomically-published snapshot directory.

    ``fault_plan`` (``repro_torch.testing.FaultPlan``) arms the one
    injection point durability tests need: a SIGKILL *between* writing
    the payload temp files and the rename that publishes them — the
    torn-write window every claim in this module is about.

    ``last_timings`` holds the wall seconds of the latest ``save``:
    ``write`` (payloads, each fsynced), ``sha256`` and ``manifest``
    (manifest, rename, directory fsyncs and rotation), and its payload
    ``bytes``; ``capture`` adds ``flush`` and ``export``.
    """

    def __init__(self, directory: str, *, retain: int = 3,
                 fault_plan=None):
        if retain < 1:
            raise ValueError(f"retain must be >= 1, got {retain}")
        self.directory = directory
        self.retain = retain
        self.fault_plan = fault_plan
        self.last_timings: dict = {}
        os.makedirs(directory, exist_ok=True)

    # -- write side ----------------------------------------------------------

    def save(self, step: int, arrays: dict, meta: dict,
             copy_dirs: Optional[dict] = None) -> str:
        """Publish one snapshot: ``arrays`` maps payload name -> flat
        ``{key: ndarray}`` dict (written as ``<name>.npz``), ``copy_dirs``
        maps subdir name -> source directory copied verbatim (the mmap
        cold store). Returns the published snapshot path."""
        name = f"snap-{step:08d}"
        final = os.path.join(self.directory, name)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        timings = {"write": 0.0, "sha256": 0.0, "manifest": 0.0,
                   "bytes": 0}
        try:
            t0 = time.perf_counter()
            written = []
            for pname, flat in arrays.items():
                fname = pname + ".npz"
                fpath = os.path.join(tmp, fname)
                with open(fpath, "wb") as f:
                    np.savez(f, **flat)
                    f.flush()
                    os.fsync(f.fileno())
                written.append(fname)
            for sub, src in (copy_dirs or {}).items():
                dst = os.path.join(tmp, sub)
                shutil.copytree(src, dst)
                for root, _, names in os.walk(dst):
                    for n in sorted(names):
                        p = os.path.join(root, n)
                        _fsync_file(p)
                        written.append(os.path.relpath(p, tmp))
                durable.fsync_dir(dst)
            t1 = time.perf_counter()
            paths = [os.path.join(tmp, rel) for rel in written]
            files = dict(zip(written, _sha256_all(paths)))
            timings["bytes"] = sum(os.path.getsize(p) for p in paths)
            t2 = time.perf_counter()
            timings["write"], timings["sha256"] = t1 - t0, t2 - t1
            if self.fault_plan is not None:
                # the torn-write window: payloads exist, nothing published
                self.fault_plan.maybe_kill(step, in_snapshot=True)
            manifest = {"version": 1, "step": int(step), "meta": meta,
                        "files": files}
            durable.atomic_write_bytes(
                os.path.join(tmp, _MANIFEST),
                json.dumps(manifest, indent=1, sort_keys=True).encode())
            durable.fsync_dir(tmp)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if os.path.exists(final):      # stale same-step snapshot (re-run)
            shutil.rmtree(final)
        os.rename(tmp, final)
        durable.fsync_dir(self.directory)
        self._rotate()
        timings["manifest"] = time.perf_counter() - t2
        self.last_timings = timings
        return final

    def _rotate(self):
        """Keep the newest ``retain`` published snapshots; drop the rest
        plus any abandoned ``*.tmp`` from a previous crash."""
        steps = self.list_steps()
        for s in steps[:-self.retain]:
            shutil.rmtree(os.path.join(self.directory, f"snap-{s:08d}"),
                          ignore_errors=True)
        for entry in os.listdir(self.directory):
            if entry.endswith(".tmp") and _SNAP_RE.match(entry[:-4]):
                shutil.rmtree(os.path.join(self.directory, entry),
                              ignore_errors=True)

    # -- read side -----------------------------------------------------------

    def list_steps(self) -> list:
        """Published snapshot steps, ascending (validity not checked)."""
        steps = []
        if not os.path.isdir(self.directory):
            return steps
        for entry in os.listdir(self.directory):
            m = _SNAP_RE.match(entry)
            if m and os.path.isdir(os.path.join(self.directory, entry)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def validate(self, path: str) -> bool:
        """True iff the snapshot's manifest parses and every payload file
        exists with its recorded sha256."""
        mpath = os.path.join(path, _MANIFEST)
        try:
            with open(mpath, "rb") as f:
                manifest = json.loads(f.read())
            rels = list(manifest["files"])
            got = _sha256_all([os.path.join(path, rel) for rel in rels])
            return all(g == manifest["files"][rel]
                       for rel, g in zip(rels, got))
        except (OSError, ValueError, KeyError, TypeError):
            return False

    def latest_valid(self) -> Optional[tuple]:
        """Newest snapshot that validates, as ``(step, path)`` — walking
        past torn or corrupted ones (with a warning) to the previous good
        snapshot; None when no valid snapshot exists."""
        for s in reversed(self.list_steps()):
            path = os.path.join(self.directory, f"snap-{s:08d}")
            if self.validate(path):
                return s, path
            logger.warning("snapshot %s is torn or corrupt; falling back",
                           path)
        return None

    def read_manifest(self, path: str) -> dict:
        with open(os.path.join(path, _MANIFEST), "rb") as f:
            return json.loads(f.read())

    def load_arrays(self, path: str, name: str) -> dict:
        """A payload's arrays, read whole into memory (no view of the
        file outlives this call)."""
        with np.load(os.path.join(path, name + ".npz")) as data:
            return {k: data[k] for k in data.files}


# -- capture / resume helpers -----------------------------------------------


def controller_of(bundle):
    """The ``AsyncHotCold`` controller behind a bundle, or None for every
    other placement (the async bundle's driver is a bound method)."""
    driver = getattr(bundle, "stream_driver", None)
    return getattr(driver, "__self__", None) if driver is not None else None


def placement_token(store) -> str:
    """The identity under which a snapshot's raw state is reusable: same
    placement, same dense kernel, same cold-store backend (the
    reference's tokens, so snapshots interchange)."""
    return f"{store.placement}:{store.kernel}:{store.cold_store}"


def capture(manager: SnapshotManager, bundle, params, state, *, step: int,
            cursor: dict, meta: Optional[dict] = None, write: bool = True):
    """Flush, export, and publish one snapshot; returns the *flushed*
    ``(params, state)`` the trainer must continue from (the flush is part
    of the trajectory — see the module docstring). The phases' wall
    seconds land in ``manager.last_timings``. ``write=False`` is a rank
    of a sharded world that does not write: it runs the flush and the
    collectives of the export and the state's gather with the writer, and
    nothing else."""
    t0 = time.perf_counter()
    params, state = bundle.flush(params, state)
    dev = tree_leaves(params["dense"])[0].device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    canonical = bundle.export(params)
    copy_dirs, raw = None, None
    ctrl = controller_of(bundle)
    if ctrl is None:
        raw = (state if bundle.export_state is None
               else bundle.export_state(state))
    if not write:
        return params, state
    arrays = {"canonical": _flat_numpy(canonical)}
    if ctrl is not None:
        if ctrl.store.backend == "mmap":
            # flush just persisted the sidecar and msynced the tables; the
            # directory copy is the snapshot (resume reopens it in place)
            copy_dirs = {"cold_store": ctrl.directory}
        else:
            arrays["async_hotcold"] = ctrl.export_snapshot(params, state)
    else:
        arrays["state"] = _flat_numpy(raw)
    del canonical, raw
    t2 = time.perf_counter()
    manager.save(step, arrays,
                 {"step": int(step), "cursor": dict(cursor),
                  **(meta or {})}, copy_dirs=copy_dirs)
    manager.last_timings.update(flush=t1 - t0, export=t2 - t1)
    return params, state


def overlay(template, flat: dict):
    """Rebuild ``template``'s tree from path-keyed arrays (the tolerant
    sibling of ``checkpoint.restore``): a tensor leaf becomes a new tensor
    of its dtype on its device (a 0-dim int32 step counter on the card
    stays there), a Python int leaf (the async placement's step) an int
    from a 0-dim array."""
    return checkpoint._fill_like(template, flat, "snapshot state")


def resume(manager: SnapshotManager, bundle, init_params, *,
           token: str, cold_dir: Optional[str] = None,
           warn: Callable[[str], None] = logger.warning):
    """Restore the latest valid snapshot into a live (params, state) pair.

    ``init_params`` is a freshly-initialized *canonical* tree (before
    ``prepare``, on the device to train on); it supplies the template
    structure. Same-``token`` resume is bitwise (raw state overlay /
    controller import / store-dir restore); a different token downgrades
    to params-only with a fresh optimizer, warned. Returns ``(params,
    state, step, cursor)`` or None when no valid snapshot exists. For the
    async mmap placement, ``cold_dir`` (the live store directory) is
    replaced by the snapshot's copy *before* ``bundle.prepare`` opens it:
    the bundle must not have opened a store there yet.
    """
    found = manager.latest_valid()
    if found is None:
        return None
    step, path = found
    meta = manager.read_manifest(path)["meta"]
    saved_token = meta.get("placement", "")
    same = saved_token == token
    ctrl = controller_of(bundle)
    if ctrl is not None:
        if not same:
            raise ValueError(
                f"snapshot {path} was written by {saved_token!r}; the "
                f"async hotcold placement ({token!r}) cannot resume "
                "cross-placement (its state lives in the cold store)")
        if ctrl.backend == "mmap":
            if ctrl.store is not None:
                # its memory maps would outlive the directory they map
                raise ValueError("resume of the async mmap placement needs "
                                 "a bundle that has not opened its cold "
                                 "store yet")
            src = os.path.join(path, "cold_store")
            if os.path.isdir(cold_dir):
                shutil.rmtree(cold_dir)
            shutil.copytree(src, cold_dir)
            params = bundle.prepare(init_params)
            state = bundle.init(params)
        else:
            params = bundle.prepare(init_params)
            bundle.init(params)  # allocs planner-shaped state; discarded
            params, state = ctrl.import_snapshot(
                manager.load_arrays(path, "async_hotcold"), params)
    else:
        canonical = overlay(init_params,
                            manager.load_arrays(path, "canonical"))
        params = bundle.prepare(canonical)
        state = bundle.init(params)
        if same:
            flat = manager.load_arrays(path, "state")
            state = (overlay(state, flat) if bundle.import_state is None
                     else bundle.import_state(state, flat))
        else:
            warn(f"snapshot {path} was written by {saved_token!r}, "
                 f"resuming under {token!r}: params-only restore, fresh "
                 "optimizer state (training continues but is not bitwise "
                 "continuous)")
    return params, state, step, dict(meta.get("cursor", {}))
