"""Crash-safe file writes: write-temp + fsync + rename, shared by every
writer that must never leave a torn file behind (``train.checkpoint``,
the cold store's ``meta.json`` and resume sidecar).

A port of ``repro.core.durable``. The protocol is the standard POSIX one:

1. write the bytes to a temp file *in the same directory* as the target
   (rename is atomic only within a filesystem),
2. ``fsync`` the temp file (the data is on disk, not just in page cache),
3. ``os.replace`` onto the final name (atomic: readers see the old file
   or the new one, never a prefix),
4. ``fsync`` the directory (the rename itself is durable).

A crash at any point leaves either the old file intact or the new file
complete, plus at worst an orphaned ``*.tmp`` the next writer ignores.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable

__all__ = ["fsync_dir", "atomic_write_bytes", "atomic_write_via"]


def fsync_dir(path: str) -> None:
    """fsync a directory so renames/creates inside it are durable.

    Best-effort on filesystems that refuse O_RDONLY dir fsync (some
    network mounts): the rename already happened, only its durability
    ordering is weakened there.
    """
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_via(path: str, write: Callable) -> None:
    """Atomically replace ``path`` with content produced by
    ``write(file_object)`` (binary mode), following the full
    temp + fsync + rename + dir-fsync protocol."""
    path = os.path.abspath(path)
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    fsync_dir(d)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Atomically replace ``path`` with ``data`` (durable on return)."""
    atomic_write_via(path, lambda f: f.write(data))
