"""Sharding rules: param / state / cache tree -> a spec a leaf, by path and
shape, as in ``repro.sharding.specs``.

A spec is a tuple with one entry a tensor dim: ``None`` (replicated), a
mesh axis name, or a tuple of axis names (the dim split over their
product, the first outermost) — the reference's ``PartitionSpec``.
``to_placements`` turns it into DTensor placements on a ``DeviceMesh``.
A mesh here is a ``DeviceMesh`` with named dims, or a dict of axis name
-> size in mesh order (what the rules read; no process group needed).

Strategy (the reference's, rule for rule):

* Embedding tables shard **row-wise (id-wise)** as aggressively as
  divisibility allows — ("model", data...) then "model" then the data
  axes — because CowClip's per-row threshold makes the whole optimizer
  update collective-free under row sharding.
* Dense 2D weights use Megatron TP over "model" + FSDP over "data":
  ``w_in [D, F] -> ("data", "model")``, ``w_out [F, D] -> ("model",
  "data")``.
* Attention shards heads over "model" (then nothing: head_dim, the score
  contraction, is never sharded); MoE shards experts over "model"
  (expert-parallel), falling back to FFN-dim TP when E % model != 0.
* Every rule is a *candidate list*; the first candidate whose sharded
  dims all divide evenly is used. One engine covers params, grads and
  Adam moments (they share tree paths) plus decode caches.
* Leaves under ``blocks/`` (stacked ``[n_repeats, ...]``) get a leading
  replicated dim; the "pod" axis folds into the batch / FSDP group as
  ``("pod", "data")``.

CTR models use the port's ``embed.sharded.ctr_param_spec`` (re-exported
here): field tables row-sharded over "model" only, the tower replicated.
"""

from __future__ import annotations

import re

from ..core.tree import _is_namedtuple, tree_map
from ..embed.sharded import ctr_param_spec  # noqa: F401  (re-export)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh`` or of such
    a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        out = 1
        for a in axis:
            out *= sizes[a]
        return out
    return sizes[axis]


def _fits(shape, spec, sizes: dict) -> bool:
    return all(axis is None or dim % _axis_size(sizes, axis) == 0
               for dim, axis in zip(shape, spec))


def pick(shape, candidates, mesh) -> tuple:
    """The first candidate spec whose sharded dims divide evenly, else
    replicated."""
    sizes = axis_sizes(mesh)
    for cand in candidates:
        if len(cand) == len(shape) and _fits(shape, cand, sizes):
            return tuple(cand)
    return (None,) * len(shape)


def _data_axes(mesh) -> tuple:
    """Batch / FSDP axis group: ("pod", "data") on multi-pod meshes."""
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


def _data(mesh):
    dfsdp = _data_axes(mesh)
    return dfsdp if len(dfsdp) > 1 else dfsdp[0]


def param_spec(path: str, shape: tuple, mesh) -> tuple:
    """The spec of one parameter / gradient / Adam-moment leaf."""
    dfsdp, d = _data_axes(mesh), _data(mesh)
    shape = tuple(shape)

    # stacked superblock leaves get a leading replicated repeat dim
    lead: tuple = ()
    if "blocks/" in path:
        lead, shape = (None,), shape[1:]

    def out(cands):
        return lead + pick(shape, cands, mesh)

    name = path.split("/")[-1]

    # embedding tables (CowClip group): rows = ids, shard rows hard (by
    # leaf name, so the Adam moments' paths hit the same rule)
    if (name == "tokens" or re.match(r"field_\d+$", name)) \
            and len(shape) == 2:
        return out([(("model",) + dfsdp, None), (("model",), None),
                    (d, None), (None, None)])
    if name == "head":
        return out([(d, "model"), (None, "model"), (d, None), (None, None)])
    # attention: head_dim is the score contraction, never sharded
    if name in ("wq", "wk", "wv") and len(shape) == 3:
        return out([(d, "model", None), (None, "model", None),
                    (d, None, None), (None, None, None)])
    if name == "wo" and len(shape) == 3:
        return out([("model", None, d), (None, "model", d),
                    (None, None, d), (None, None, None)])
    # MoE experts [E, D, F] / [E, F, D]; the router stays replicated
    if re.search(r"ffn/(w_in|w_gate)$", path) and len(shape) == 3:
        return out([("model", d, None), (None, d, "model"),
                    (None, None, "model"), (None, None, None)])
    if re.search(r"ffn/w_out$", path) and len(shape) == 3:
        return out([("model", None, d), (None, "model", d),
                    (None, "model", None), (None, None, None)])
    if name == "router":
        return out([(None, None)])
    # dense 2D mats: in-proj style [D, F] vs out-proj style [F, D]
    if name in ("w_in", "w_gate", "wk", "wr", "wg") and len(shape) == 2:
        return out([(d, "model"), (None, "model"), (d, None), (None, None)])
    if name in ("w_out", "wo", "wv") and len(shape) == 2:
        return out([("model", d), ("model", None), (None, d), (None, None)])
    if name == "conv_w" and len(shape) == 2:
        return out([(None, "model"), (None, None)])
    if name == "wA" and len(shape) == 2:
        return out([(d, None), (None, None)])
    if name == "wB" and len(shape) == 2:
        return out([(None, "model"), (None, None)])
    if name == "ln_scale" and len(shape) == 2:   # rwkv [H, N]
        return out([("model", None), (None, None)])
    # CTR dense tower [in, out] mats
    if re.match(r"w\d+$", name) and len(shape) == 2:
        return out([(d, "model"), (None, "model"), (None, None)])
    # everything else (norm scales, biases, vectors, scalars): replicated
    return lead + (None,) * len(shape)


def cache_spec(path: str, shape: tuple, mesh) -> tuple:
    """The spec of one decode-cache leaf (stacked ``[n_repeats, ...]``)."""
    dfsdp, d = _data_axes(mesh), _data(mesh)
    lead, shape = (None,), tuple(shape)[1:]

    def out(cands):
        return lead + pick(shape, cands, mesh)

    name = path.split("/")[-1]
    if name in ("k", "v") and len(shape) == 4:         # [B, S, K, hd]
        # head_dim never sharded; when kv heads don't divide the model
        # axis, split the sequence (flash-decoding style)
        all_axes = (dfsdp + ("model",)) if len(dfsdp) > 1 \
            else ("data", "model")
        return out([(d, None, "model", None), (d, "model", None, None),
                    (d, None, None, None), (None, all_axes, None, None),
                    (None, "model", None, None), (None, d, None, None),
                    (None, None, None, None)])
    if name == "s" and len(shape) == 4:                # rwkv/mamba [B, H, ., .]
        return out([(d, "model", None, None), (None, "model", None, None),
                    (d, None, None, None), (None, None, None, None)])
    if name in ("x_prev", "x_prev_ffn") and len(shape) == 2:
        return out([(d, "model"), (d, None), (None, "model"), (None, None)])
    if name == "conv" and len(shape) == 3:             # [B, K-1, conv_dim]
        return out([(d, None, "model"), (d, None, None),
                    (None, None, "model"), (None, None, None)])
    return out([(None,) * len(shape)])


def _paths_tree(tree, prefix: str = ""):
    """A tree of ``"a/b/c"`` path strings shaped like ``tree``: dict keys,
    NamedTuple field names and sequence indices, as the reference's
    ``tree_flatten_with_path`` names them (``core.tree.
    flatten_with_paths``' keys)."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _paths_tree(v, join(k)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_paths_tree(v, join(k))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_paths_tree(v, join(i)) for i, v in enumerate(tree))
    return prefix


def _infer(tree, mesh, spec_fn):
    return tree_map(lambda path, leaf: spec_fn(path, tuple(leaf.shape), mesh),
                    _paths_tree(tree), tree)


def infer_param_shardings(tree, mesh):
    """A spec tree (``param_spec``) for params / grads / optimizer states."""
    return _infer(tree, mesh, param_spec)


def infer_cache_shardings(tree, mesh):
    """A spec tree (``cache_spec``) for a decode cache."""
    return _infer(tree, mesh, cache_spec)


def batch_spec(mesh) -> tuple:
    """The batch dim's spec: over the data axes."""
    return (_data(mesh),)


def to_placements(spec, mesh) -> list:
    """DTensor placements (one a mesh dim, in mesh order) of ``spec``: a
    tensor dim split over several mesh axes is ``Shard(d)`` on each of
    them. DTensor nests such a dim's shards in mesh order, so a dim split
    over ``("pod", "data")`` is laid out as the reference lays it, pod
    outermost; one over ``("model", "pod", "data")`` has the same local
    shape as the reference's but its blocks in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, axis in enumerate(spec):
        for a in (() if axis is None else
                  axis if isinstance(axis, (tuple, list)) else (axis,)):
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"mesh axis {a!r} used twice in {spec}")
            out[names.index(a)] = Shard(d)
    return out


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's block of a ``shape`` tensor under ``spec``
    (every sharded dim divides evenly, as ``pick`` guarantees)."""
    sizes = axis_sizes(mesh)
    return tuple(dim // _axis_size(sizes, axis)
                 for dim, axis in zip(shape, spec))
