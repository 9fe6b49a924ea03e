"""What a traced step costs one rank: its collectives, FLOPs, bytes and
live memory, as the dry-run reports them.

The port's counterpart of ``repro.launch.hlo_analysis``. There is no HLO
to parse: the dry-run runs the step once on fake tensors (``torch.
_subclasses.FakeTensorMode``: shapes and dtypes, no storage), sharded as
DTensors over a fake process group, under ``StepTrace``, a
``TorchDispatchMode`` that sees every aten and ``_c10d_functional`` op a
rank would run on its local blocks:

* **collectives**: every ``_c10d_functional`` collective DTensor's
  redistributions issue, as a record ``{"kind", "bytes", "phase"}``;
  ``collective_stats(records)`` sums them per kind, with the reference's
  five kind names and its bytes, the output buffer's size
  (``hlo_analysis.py:85-106``). The trace is unrolled (a Python loop over
  superblocks, not a ``while`` body), so ``count`` is the executed count
  and the reference's ``loop_scale`` is 1.
* **FLOPs**: ``torch.utils.flop_counter``'s formulas (those of
  ``FlopCounterMode``: mm, bmm, addmm, baddbmm, convolutions, attention)
  on each local op's shapes: per rank.
* **bytes accessed**: each op's operand and result bytes summed, views
  excluded: per rank. The port's own ops (the ``repro_torch`` library:
  the Mamba-2 scan, whose shape function stands in for its kernel) are
  counted as aten's are.
* **temp bytes**: the peak of the summed sizes of the storages made
  during the trace and still alive, per rank (the arguments were made
  before it).

DTensor works out an op's output sharding by running it once on fake
tensors of the *global* shape; those runs are not the rank's work, and
``StepTrace`` leaves them out (``_propagation_hidden``). The ops at the
DTensor level (global shapes) are passed on to DTensor unrecorded.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# ``_c10d_functional`` op name -> the reference's HLO kind
KIND_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}   # DTensor's redistributions issue no permute: "collective-permute"
    # keeps its place in the reference's list and stays empty


# the ops whose operand and result bytes are counted: PyTorch's and the
# port's own library's (``kernels/ssd/ops.py``)
BYTES_NAMESPACES = ("aten", "repro_torch")


def collective_stats(records) -> dict:
    """``{kind: {"count": n, "bytes": b}}`` over collective records
    (``StepTrace.collectives``), the reference's form. ``count`` is the
    number executed (the trace is unrolled; ``loop_scale`` 1) and
    ``bytes`` the summed output-buffer sizes."""
    stats: dict = defaultdict(lambda: {"count": 0, "bytes": 0})
    for rec in records:
        stats[rec["kind"]]["count"] += 1
        stats[rec["kind"]]["bytes"] += rec["bytes"]
    return dict(stats)


def total_collective_bytes(records) -> int:
    return sum(v["bytes"] for v in collective_stats(records).values())


# --------------------------------------------------------------------------
# DTensor's shape propagation, kept out of the counts
# --------------------------------------------------------------------------

_HIDDEN = threading.local()


class _PropagationFlag:
    """Stands in for ``ShardingPropagator._fake_mode_lock`` (a no-op
    context by default) around DTensor's fake run of an op at its global
    shape, so that ``StepTrace`` can tell those runs apart."""

    def __init__(self, inner):
        self.inner = inner

    def __enter__(self):
        _HIDDEN.depth = getattr(_HIDDEN, "depth", 0) + 1
        return self.inner.__enter__()

    def __exit__(self, *exc):
        _HIDDEN.depth -= 1
        return self.inner.__exit__(*exc)


def _propagation_hidden() -> bool:
    return getattr(_HIDDEN, "depth", 0) > 0


@contextlib.contextmanager
def _flag_propagation():
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:        # no DTensor: nothing to hide
        yield
        return
    old = getattr(ShardingPropagator, "_fake_mode_lock", None)
    if old is None:
        yield
        return
    ShardingPropagator._fake_mode_lock = _PropagationFlag(old)
    try:
        yield
    finally:
        ShardingPropagator._fake_mode_lock = old


# --------------------------------------------------------------------------
# the trace
# --------------------------------------------------------------------------


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepTrace(TorchDispatchMode):
    """Per-rank accounting of the ops run under it (see the module's
    docstring). ``phase`` labels what follows (the dry-run's
    ``"forward_backward"`` and ``"update"``); each phase keeps its own
    ``flops`` and collective records. Use as ``with StepTrace() as tr:``
    inside the fake mode; read ``flops``, ``bytes_accessed``,
    ``collectives``, ``peak_temp_bytes`` (and its peak within each phase,
    ``peak_by_phase``) after."""

    def __init__(self):
        super().__init__()
        self.phase = "step"
        self.flops: dict = defaultdict(int)
        self.flops_by_op: dict = defaultdict(int)
        self.bytes_accessed = 0
        self.collectives: list = []
        self.op_counts: dict = defaultdict(int)
        self.live_bytes = 0
        self.peak_temp_bytes = 0
        self.peak_by_phase: dict = defaultdict(int)
        self._seen: set = set()
        self._held: list = []
        self._stack = contextlib.ExitStack()

    def ignore(self, tensors) -> None:
        """Leave the storages of ``tensors`` (the step's arguments, made
        before the trace) out of the temp bytes."""
        for t in tensors:
            st = t.untyped_storage()
            self._held.append(st)
            self._seen.add(id(st))

    def __enter__(self):
        self._stack.enter_context(_flag_propagation())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()

    def total_flops(self) -> int:
        return sum(self.flops.values())

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        size = st.nbytes()
        self._seen.add(key)
        self.live_bytes += size
        self.peak_temp_bytes = max(self.peak_temp_bytes, self.live_bytes)
        self.peak_by_phase[self.phase] = max(
            self.peak_by_phase[self.phase], self.live_bytes)

        def free(key=key, size=size, trace=weakref.ref(self)):
            tr = trace()
            if tr is not None:
                tr._seen.discard(key)
                tr.live_bytes -= size

        weakref.finalize(st, free)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs it on the local blocks
        out = func(*args, **kwargs)
        if _propagation_hidden():
            return out
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "_c10d_functional" and name in KIND_OF:
            outs = _tensors(out)
            self.collectives.append({
                "kind": KIND_OF[name], "op": name, "phase": self.phase,
                "bytes": sum(_nbytes(t) for t in outs)})
        packet = func.overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops[self.phase] += n
            self.flops_by_op[str(packet)] += n
        if ns in BYTES_NAMESPACES and not func.is_view:
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors(args))
            self.bytes_accessed += sum(_nbytes(t) for t in _tensors(out))
        self.op_counts[f"{ns}.{name}"] += 1
        for t in _tensors(out):
            self._track(t)
        return out
