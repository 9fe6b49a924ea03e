"""Fixed-shape CTR scoring on a captured CUDA graph: the serving half of
the training loop.

A port of ``repro.serve.engine``. Two ideas, as in the reference:

* **One capture per engine.** Every dispatch scores exactly
  ``[batch_size]`` rows: smaller requests are zero-padded and the pad
  scores discarded on the host, larger ones cut into fixed slices
  (``padded_score_loop``, which ``train.loop.make_eval_fn`` shares). The
  reference's jit compiles that shape once; here ``TracedFn`` captures the
  forward at that shape once as a CUDA graph and replays it for every
  dispatch, whatever the request sizes.
* **Placement-independent snapshots.** An engine scores a canonical dense
  ``{"embed", "dense"}`` params tree. Any training placement gives one
  through its bundle's ``flush`` and ``export``
  (``embed.store.serving_snapshot``); a raw sparse checkpoint without a
  live bundle goes through ``collapse_pending_decay``.

``compute_dtype="bfloat16"`` scores through the training side's cast
points (``models/ctr.py``); logits come back f32.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from ..core.optim import decay_factor, f32
from ..core.tree import tree_leaves, tree_map
from ..data import prefetch as prefetch_lib
from ..models import ctr


def _leaf_key(x):
    """A leaf's part of a call's signature: a tensor on the card by its
    storage too (a graph reads the memory of its capture), a host value
    by shape and dtype."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        return ("cuda", tuple(x.shape), x.dtype, x.data_ptr())
    x = np.asarray(x) if not isinstance(x, torch.Tensor) else x
    return ("host", tuple(x.shape), x.dtype)


class TracedFn:
    """A function of trees of tensors and host arrays, run on the card as
    one captured CUDA graph per call signature, that counts its captures.

    The counterpart of the reference's jitted ``TracedFn``: ``n_traces``
    is the number of captures (on the CPU, of distinct signatures), the
    number the serving engine's "one compile per shape" contract is held
    to. A signature is every leaf's shape and dtype, and for a tensor on
    the card its storage: such tensors (the params) are read in place at
    every replay, host leaves (the request's padded ids and features) are
    copied into the graph's static buffers. The first call with a
    signature warms the body up on a side stream, then captures it (a
    capture that fails raises); every call returns a copy of the output,
    so calls from several threads are safe (they take turns).
    """

    def __init__(self, body):
        self._body = body
        self._graphs: dict = {}
        self._signatures: set = set()
        self._lock = threading.Lock()

    @property
    def n_traces(self) -> int:
        return len(self._signatures)

    def __call__(self, *args):
        leaves = tree_leaves(args)
        key = tuple(_leaf_key(x) for x in leaves)
        device = next((x.device for x in leaves
                       if isinstance(x, torch.Tensor)
                       and x.device.type == "cuda"), None)
        with self._lock:
            self._signatures.add(key)
            if device is None:
                with torch.inference_mode():
                    return self._body(*tree_map(torch.as_tensor, args))
            entry = self._graphs.get(key)
            if entry is None:
                entry = self._graphs[key] = self._capture(args, device)
            graph, static, out = entry
            with torch.inference_mode():   # the static buffers' mode
                for dst, src in zip(tree_leaves(static), leaves):
                    if dst is not src:
                        dst.copy_(torch.as_tensor(src), non_blocking=True)
                graph.replay()
                return out.clone()

    def _capture(self, args, device):
        def static_leaf(x):
            if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                return x
            return torch.as_tensor(x).to(device)

        with torch.inference_mode():
            static = tree_map(static_leaf, args)
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                self._body(*static)
            torch.cuda.current_stream(device).wait_stream(stream)
            torch.cuda.synchronize(device)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                out = self._body(*static)
        return graph, static, out


def make_logits_fn(cfg: ctr.CTRConfig) -> TracedFn:
    """The scoring forward ``(params, ids, dense) -> logits [B]`` as a
    ``TracedFn``: params on their device, ids and dense as host arrays.
    Shared by ``ServingEngine`` and ``train.loop.make_eval_fn``, so both
    score through the same captured forward."""
    return TracedFn(lambda params, ids, dense: ctr.apply(params, cfg, ids,
                                                         dense))


def _pad_rows(arr: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad a host array along axis 0 up to ``n`` rows."""
    if arr.shape[0] == n:
        return arr
    pad = np.zeros((n - arr.shape[0],) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad])


def padded_score_loop(
    logits_fn,
    params,
    ids: np.ndarray,
    dense: np.ndarray,
    batch_size: int,
    *,
    overlap: bool = True,
) -> np.ndarray:
    """Score ``n`` rows through fixed ``[batch_size]`` zero-padded slices;
    returns ``[n]`` f32 logits on the host. Every dispatch, the short tail
    and inputs smaller than ``batch_size`` included, has the one
    ``[batch_size]`` shape, so ``logits_fn`` captures once. With
    ``overlap`` (multi-slice inputs only) the host slicing runs on the
    prefetch worker thread."""
    ids = np.asarray(ids)
    dense = np.asarray(dense)
    n = ids.shape[0]
    if n <= batch_size:
        s = logits_fn(params, _pad_rows(ids, batch_size),
                      _pad_rows(dense, batch_size))
        return s.cpu().numpy()[:n].astype(np.float32, copy=True)

    def host_slices():
        for start in range(0, n, batch_size):
            end = min(start + batch_size, n)
            yield {"ids": _pad_rows(ids[start:end], batch_size),
                   "dense": _pad_rows(dense[start:end], batch_size)}

    slices = (prefetch_lib.prefetch(host_slices()) if overlap
              else host_slices())
    scores = np.empty(n, np.float32)
    start = 0
    for b in slices:
        s = logits_fn(params, b["ids"], b["dense"])
        end = min(start + batch_size, n)
        scores[start:end] = s.cpu().numpy()[: end - start]
        start = end
    return scores


def collapse_pending_decay(embed: dict, last_step: dict, step, *,
                           lr: float, l2: float) -> dict:
    """Apply pending lazy coupled-L2 decay to raw sparse-placement tables.

    The closed form ``w * (1 - lr*l2)**k``, ``k = step - last_step[row]``
    (``decay_factor`` rounding, O(1) in depth): what a bundle's ``flush``
    does, for a checkpoint that has no live bundle to flush through.
    ``embed`` and ``last_step`` are ``{group: {field: leaf}}`` trees; rows
    already caught up (k == 0) multiply by exactly 1.0. Returns new tables.
    """
    f = f32(decay_factor(lr, l2))

    def catch_up(w, ls):
        k = torch.clamp_min(int(step) - ls.to(torch.int32), 0)
        k = k.to(torch.float32)
        scale = torch.where(k > 0, f.to(w.device) ** k,
                            f32(1.0).to(w.device))
        return (w.to(torch.float32) * scale[:, None]).to(w.dtype)

    return {g: {name: catch_up(w, last_step[g][name])
                for name, w in tables.items()}
            for g, tables in embed.items()}


class ServingEngine:
    """Fixed-shape scoring over a dense, flush-applied snapshot, one
    captured CUDA graph per engine.

    Construct from canonical dense params (``__init__``, tensors on the
    device to serve from) or straight from a live training bundle and
    state (``from_training``, through ``embed.store
    .serving_snapshot``, so fused and sparse checkpoints serve alike).
    ``score`` may be called from several threads (they take turns on the
    graph); a ``MicroBatcher`` in front coalesces them.
    """

    def __init__(self, cfg: ctr.CTRConfig, params: dict, *,
                 batch_size: int = 256,
                 compute_dtype: Optional[str] = None):
        if compute_dtype is not None:
            cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
        self.cfg = cfg
        self.batch_size = int(batch_size)
        # the snapshot stays where it lives; serving never shards, so no
        # dispatch pays a collective
        self.params = params
        self._logits_fn = make_logits_fn(cfg)
        self._rows = 0
        self._dispatches = 0

    @classmethod
    def from_training(cls, bundle, params, state, cfg: ctr.CTRConfig,
                      **kwargs) -> "ServingEngine":
        """Snapshot a live (or restored) training bundle and serve it."""
        from ..embed.store import serving_snapshot

        snapshot = serving_snapshot(bundle, params, state)
        # a copy: the engine's tables stay as they were when training goes
        # on in place
        return cls(cfg, tree_map(torch.clone, snapshot), **kwargs)

    def score(self, ids, dense) -> np.ndarray:
        """Score [n, F] ids + [n, Dd] dense feats -> [n] f32 logits."""
        ids = np.atleast_2d(np.asarray(ids, np.int32))
        dense = np.atleast_2d(np.asarray(dense, np.float32))
        self._rows += ids.shape[0]
        self._dispatches += -(-ids.shape[0] // self.batch_size)
        return padded_score_loop(self._logits_fn, self.params, ids, dense,
                                 self.batch_size)

    @property
    def n_traces(self) -> int:
        """Captures so far: 1 after the first dispatch."""
        return self._logits_fn.n_traces

    def stats(self) -> dict:
        return {"rows": self._rows, "dispatches": self._dispatches,
                "n_traces": self.n_traces, "batch_size": self.batch_size,
                "compute_dtype": self.cfg.compute_dtype}
