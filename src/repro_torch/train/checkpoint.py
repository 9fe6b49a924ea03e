"""Checkpoints in the JAX package's format, and the weight carry.

``save``/``restore`` write and read one ``.npz`` keyed by ``/``-joined tree
paths (dict keys, sequence indices, NamedTuple field names), the format of
``repro.train.checkpoint``, so checkpoints interchange between the two
packages. Saves are atomic: temp file, fsync, rename, directory fsync.

``params_from_numpy`` carries params trained or initialised by the JAX
package (a tree of arrays, a flat ``/``-keyed dict, or a checkpoint
``.npz`` path) into the port's tensor params; ``params_to_numpy`` is the
reverse.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any

import numpy as np
import torch

from ..core.tree import flatten_with_paths, tree_map, unflatten_dict

PyTree = Any


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _atomic_write(path: str, write) -> None:
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
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
    dfd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(dfd)
    except OSError:   # some filesystems refuse a directory fsync
        pass
    finally:
        os.close(dfd)


def save(path: str, tree: PyTree) -> None:
    """Atomic, durable save of a tree of tensors / arrays / numbers."""
    flat = {k: _to_numpy(v) for k, v in flatten_with_paths(tree).items()}
    _atomic_write(path, lambda f: np.savez(f, **flat))


def restore(path: str, template: PyTree) -> PyTree:
    """Restore into the structure, dtypes and devices of ``template``: a
    tree of tensors and Python ints (step counters), as the port's
    optimizer states hold them. A JAX state's 0-dim int arrays load into
    the int leaves."""
    with np.load(path) as data:
        flat = dict(data)
    keys = iter(flatten_with_paths(template))

    def leaf(t):
        key = next(keys)
        if key not in flat:
            raise KeyError(f"checkpoint {path} missing leaf {key!r}")
        arr = flat[key]
        if isinstance(t, int):
            if arr.shape != ():
                raise ValueError(f"leaf {key!r}: checkpoint shape "
                                 f"{arr.shape} for an int counter")
            return int(arr)
        if arr.shape != tuple(t.shape):
            raise ValueError(f"leaf {key!r}: checkpoint shape {arr.shape} "
                             f"!= template {tuple(t.shape)}")
        return torch.as_tensor(arr, dtype=t.dtype).to(t.device)

    return tree_map(leaf, template)


def params_from_numpy(tree_or_flat, device="cuda") -> dict:
    """JAX params -> the port's params on ``device``.

    Accepts a nested tree of arrays (``jax.tree.map(np.asarray, params)``),
    a flat ``{"embed/fm/field_0": array}`` dict, or the path of a checkpoint
    ``.npz`` from either package. A tree with a top-level ``"params"`` entry
    (what ``run_ctr --checkpoint`` saves) yields that entry. The layouts are
    the same on both sides, so every leaf carries over as it is.
    """
    tree = tree_or_flat
    if isinstance(tree, (str, os.PathLike)):
        with np.load(tree) as data:
            tree = dict(data)
    if any("/" in k for k in tree):
        tree = unflatten_dict(dict(tree))
    if "params" in tree:
        tree = tree["params"]
    device = torch.device(device)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def params_to_numpy(params: PyTree) -> PyTree:
    """The port's params -> the same tree of NumPy arrays."""
    return tree_map(_to_numpy, params)
