"""Kernel names and helpers the per-layer metric readers share."""

from __future__ import annotations

from . import trace

# the port's kernels, by the names the device trace gives them
FUSED = ("cowclip_adam_tile_kernel", "cowclip_adam_kernel")
SPARSE = ("sparse_catchup_kernel", "sparse_update_kernel")
EMBED_LEVELS = ("embedding_backward_level_kernel",)
WKV6_FORWARD = ("wkv6_segment_state_kernel", "wkv6_segment_carry_kernel",
                "wkv6_chunked_kernel")
WKV6_BACKWARD = ("wkv6_backward_kernel",)
SORT = ("RadixSort",)
FILL = ("FillFunctor", "Memset")


def per_step(record, names) -> float:
    """Device seconds a step of the kernels named ``names`` in the
    stretch."""
    s = record.stretch
    return trace.seconds_of(s.events, names) / s.steps


def ctr_tables(work: dict, touched: list):
    """``(vocab, touched rows, width)`` of every table of a CTR step: the
    fm tables, then the LR ones."""
    for dim in (work["emb_dim"], 1):
        for v, n in zip(work["vocabs"], touched):
            yield v, n, dim


def embedding_backward_s(record, own_sort: bool) -> float:
    """Device seconds a step of the embedding backward: its level kernels,
    the fill (of its output) that each run of them directly follows, and,
    when the backward sorts for itself, the step's sort kernels."""
    events = record.stretch.events
    total, prev = 0, None
    for e in trace.kernels_and_fills(events):
        name, a, b = e
        if any(k in name for k in EMBED_LEVELS):
            total += b - a
            if prev is not None and any(k in prev[0] for k in FILL):
                total += prev[2] - prev[1]
        prev = e
    if own_sort:
        total += sum(b - a for n, a, b in events
                     if any(k in n for k in SORT))
    return total / 1e9 / record.stretch.steps
