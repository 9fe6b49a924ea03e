"""The multi-step training engine: K steps captured as one CUDA graph.

A port of ``repro.train.engine``. Its answer to the per-step overheads
around the large-batch update (dispatch, the host-to-device copy, fresh
buffers) is one compiled ``lax.scan`` over K steps a dispatch; PyTorch's
counterpart of one compiled dispatch is one captured CUDA graph:

* ``make_chunk_runner`` wraps a placement's capturable step
  (``StepFn.scan_step``: no host read, scalars on the device, the
  params and the state written in place) in a runner over ``[k, batch,
  ...]`` chunks. On the card it captures K copies of the step, forward,
  ``torch.autograd.grad`` and every kernel included, into one graph over
  static chunk buffers, and each call copies the chunk into those buffers
  and replays the graph: one launch for K steps, where an eager step costs
  some 1,500. Each distinct k (an epoch's tail chunk, a ``max_steps``
  cut) is captured once, as the reference re-jits once per distinct k. A
  capture that fails raises: there is no fallback to eager steps. On the
  CPU the runner runs the K bodies in turn (the path the tests hold to the
  JAX package).
* ``run_epoch`` drives one epoch of chunks from ``data.prefetch``: a
  worker thread stacks the next K batches while the current chunk runs,
  and on the card their copy, through pinned memory on a side stream,
  overlaps the replay.

Equivalence: ``chunk_epoch`` replays ``iterate_batches``'s shuffle order
and a replay runs the kernels the eager step launches, in the same order,
on the same tensors, so the scan engine equals the eager one bit for bit
(params, state and per-step aux).

``drive_planned_stream`` is the consume loop of a stream whose items may
carry migration plans (the async hot/cold placement, ``embed.migrate``).

While a ``core.spans`` recording is on, a chunk is the span
``engine.chunk`` (its self time: the copy into the static buffers and the
aux clones), around ``engine.capture`` (counted by ``engine.captures``)
and ``engine.replay``, the graph's launch on the host.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..core import spans
from ..core.tree import tree_leaves, tree_map
from ..data import prefetch as prefetch_lib

ENGINES = ("eager", "scan")

_STREAM_END = object()


class StreamDriveStats(NamedTuple):
    """What ``drive_planned_stream`` measured: steps dispatched, consumer
    time spent blocked waiting on the stream (the un-hidden migration and
    data-staging cost), and whether every chunk arrived pre-planned (the
    overlap-on path) or had to be planned inline."""

    steps: int
    stall_seconds: float
    planned_ahead: bool


def drive_planned_stream(stream, *, plan: Callable, dispatch: Callable,
                         max_steps: Optional[int] = None) -> StreamDriveStats:
    """Consume a chunk stream whose items may carry migration plans.

    The async hot/cold placement's transform wraps each chunk as a
    ``PlannedChunk`` (``.chunk`` + ``.plans``) on the stream's worker
    thread -- planning overlaps the device step of the previous chunk, and
    the consumer's only host work is ``dispatch(plan, batch)`` per step.
    Raw chunks (no transform attached) are planned inline via
    ``plan(batch)`` -- the overlap-off reference path, bitwise identical
    because planning order is unchanged.

    ``max_steps`` may cut only *unplanned* chunks: a pre-planned step has
    already advanced the planner and registered write-backs, so dropping
    it would leave eviction handles unfillable -- the transform must carry
    the same budget (it ends the stream at the boundary instead).
    """
    n = 0
    stall = 0.0
    inline = False
    saw = False
    it = iter(stream)
    while max_steps is None or n < max_steps:
        t0 = time.perf_counter()
        item = next(it, _STREAM_END)
        stall += time.perf_counter() - t0
        if item is _STREAM_END:
            break
        plans = getattr(item, "plans", None)
        chunk = item.chunk if plans is not None else item
        k = chunk["labels"].shape[0]
        if max_steps is not None and n + k > max_steps:
            if plans is not None:
                raise ValueError(
                    f"stream planned {k} step(s) past max_steps={max_steps};"
                    " build the stream transform with the same step budget")
            k = max_steps - n
            chunk = {kk: v[:k] for kk, v in chunk.items()}
        if plans is None:
            inline = True
            plans = [plan({kk: v[i] for kk, v in chunk.items()})
                     for i in range(k)]
        saw = True
        for i in range(k):
            dispatch(plans[i], {kk: v[i] for kk, v in chunk.items()})
            n += 1
    return StreamDriveStats(n, stall, saw and not inline)


def _stack_aux(auxes: list) -> dict:
    return {name: torch.stack([a[name] for a in auxes]) for name in auxes[0]}


class _Capture(NamedTuple):
    """One captured chunk of ``k`` steps: the graph, its static input
    buffers and its per-step aux, stacked."""

    graph: torch.cuda.CUDAGraph
    inputs: dict
    aux: dict


class ChunkRunner:
    """``(params, opt_state, chunk) -> (params, opt_state, aux_stack)``
    over a capturable step; see ``make_chunk_runner``."""

    def __init__(self, scan_step: Callable):
        self.scan_step = scan_step
        self._captures: dict = {}

    @property
    def n_captures(self) -> int:
        """Graphs captured so far (one per distinct chunk geometry and
        state)."""
        return len(self._captures)

    def __call__(self, params, opt_state, chunk: dict):
        with spans.span("engine.chunk"):
            leaves = tree_leaves((params, opt_state))
            device = leaves[0].device
            if device.type != "cuda":
                return self._run_bodies(params, opt_state, chunk)
            chunk = {name: torch.as_tensor(v, device=device)
                     for name, v in chunk.items()}
            k = chunk["labels"].shape[0]
            key = (tuple((name, tuple(v.shape), v.dtype)
                         for name, v in chunk.items()),
                   tuple(t.data_ptr() for t in leaves))
            cap = self._captures.get(key)
            if cap is None:
                with spans.span("engine.capture"):
                    cap = self._capture(params, opt_state, chunk, k)
                spans.add("engine.captures")
                self._captures[key] = cap
            for name, buf in cap.inputs.items():
                buf.copy_(chunk[name], non_blocking=True)
            with spans.span("engine.replay"):
                cap.graph.replay()
            return params, opt_state, {n: v.clone()
                                       for n, v in cap.aux.items()}

    def _run_bodies(self, params, opt_state, chunk):
        """The CPU path: the k bodies in turn."""
        auxes = []
        for i in range(chunk["labels"].shape[0]):
            batch = {name: torch.as_tensor(v[i]) for name, v in chunk.items()}
            params, opt_state, aux = self.scan_step(params, opt_state, batch)
            auxes.append(aux)
        return params, opt_state, _stack_aux(auxes)

    def _capture(self, params, opt_state, chunk, k) -> _Capture:
        """Warm one step up on a side stream, over clones of the state (so
        the training state is not touched), then capture ``k`` steps on
        that stream over static copies of the chunk."""
        from ..kernels.extension import build

        build()
        inputs = {name: v.clone() for name, v in chunk.items()}
        stream = torch.cuda.Stream(inputs["labels"].device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            warm = tree_map(torch.clone, (params, opt_state))
            self.scan_step(*warm, {n: v[0] for n, v in inputs.items()})
            del warm
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()

        graph = torch.cuda.CUDAGraph()
        auxes = []
        before = tree_leaves((params, opt_state))
        with torch.cuda.graph(graph, stream=stream):
            p, s = params, opt_state
            for i in range(k):
                p, s, aux = self.scan_step(
                    p, s, {n: v[i] for n, v in inputs.items()})
                auxes.append(aux)
            aux = _stack_aux(auxes)
        after = tree_leaves((p, s))
        if len(after) != len(before) or any(
                a is not b for a, b in zip(after, before)):
            raise RuntimeError(
                "the scan engine captures steps that write their params and "
                "state in place; this step returned new tensors")
        return _Capture(graph, inputs, aux)


def make_chunk_runner(scan_step: Callable) -> ChunkRunner:
    """A runner ``(params, opt_state, chunk) -> (params, opt_state,
    aux_stack)``: ``chunk`` leaves are ``[k, ...]`` stacked batches (on the
    params' device), ``aux_stack`` the step's aux dict with a leading ``k``
    axis, and ``params``/``opt_state`` the same trees, updated in place.

    On the card ``scan_step`` must be capturable (``core.builders
    .StepFn``): each distinct chunk geometry (and params/state storage)
    is captured once into a CUDA graph, whose replays run the ``k``
    steps; a capture that fails raises. On the CPU the ``k`` bodies run
    in turn.
    """
    return ChunkRunner(scan_step)


def run_epoch(
    runner: Callable,
    params,
    opt_state,
    ds,
    batch_size: int,
    scan_steps: int,
    *,
    seed: int = 0,
    shuffle: bool = True,
    max_steps: Optional[int] = None,
    buffer_size: int = 2,
    on_chunk: Optional[Callable] = None,
) -> Tuple[object, object, int, Optional[dict]]:
    """One epoch of chunks through ``runner``, on the params' device.

    Returns ``(params, opt_state, steps_run, last_aux_stack)``. Respects
    ``max_steps`` (remaining budget for *this* epoch) by slicing the final
    chunk's leading axis, at most one more capture for the cut shape.
    ``on_chunk(k, aux_stack)``, when given, is called around each chunk
    of ``k`` steps: before it with ``aux_stack`` None, after it with its
    aux (the train loop's clock and loss record).
    """
    device = tree_leaves(params)[0].device
    steps_run = 0
    last_aux = None
    chunks = prefetch_lib.prefetch_chunks(
        ds, batch_size, scan_steps, shuffle=shuffle, seed=seed,
        buffer_size=buffer_size,
        device=device if device.type == "cuda" else None)
    try:
        for chunk in chunks:
            k = chunk["labels"].shape[0]
            if max_steps is not None and steps_run + k > max_steps:
                k = max_steps - steps_run
                if k <= 0:
                    break
                chunk = {name: v[:k] for name, v in chunk.items()}
            if on_chunk is not None:
                on_chunk(k, None)
            params, opt_state, last_aux = runner(params, opt_state, chunk)
            if on_chunk is not None:
                on_chunk(k, last_aux)
            steps_run += k
            if max_steps is not None and steps_run >= max_steps:
                break
    finally:
        chunks.close()
    return params, opt_state, steps_run, last_aux


def resolve_scan_step(step_bundle):
    """The capturable body of a bundle's step: its ``StepFn.scan_step``."""
    return step_bundle.step.scan_step
