"""The port's embedding backward and the gather built on it.

``embedding_backward(keys, grad_out, rows)`` is the gradient of a gather:
``grad[r]`` sums the rows of ``grad_out`` whose key is ``r``, keys ``>=
rows`` dropped. It sorts the keys (``torch.sort``, stable), then sums each
key's segment in a fixed order: on a CUDA tensor by the kernel of
``csrc/embedding_backward.cu`` (or the call raises), on a CPU tensor by
its plain version (``ref.py``), which sums in the same order. So its
result repeats bit for bit, where PyTorch's CUDA ``embedding_dense_backward``
does not. ``.launches`` counts the kernel's runs (a run is one call of
its launcher: a launch per level of the sum).

``gather_fields(tables, ids)`` is the forward that uses it: ``out[b, f] =
tables[f][min(ids[b, f], V_f - 1)]``, ``[B, F, D]``, whose backward passes
nothing for an id ``>= V_f`` (the reference's clamping gather and
dropping scatter) and computes every table's gradient in one call over
all ``B * F`` rows: the tables' rows laid end to end in one buffer
(``FieldLayout``, which also lays out ``models.embedding.field_counts``),
each table's gradient a view of it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from ..extension import build
from . import ref
from .ref import embedding_backward_reference as reference

ALIGN_ROWS = 64


def embedding_backward(keys: torch.Tensor, grad_out: torch.Tensor,
                       rows: int) -> torch.Tensor:
    """``[rows, D]`` gradient of a gather whose output row i read row
    ``keys[i]``: ``keys`` [N] int32, ``grad_out`` [N, D] float (float32
    on the card). Deterministic: the same inputs give the same bits."""
    if not isinstance(keys, torch.Tensor) or keys.dim() != 1 \
            or keys.dtype != torch.int32:
        raise TypeError("keys must be a 1-D int32 torch.Tensor")
    if not isinstance(grad_out, torch.Tensor) or grad_out.dim() != 2 \
            or grad_out.shape[0] != keys.shape[0]:
        raise ValueError(f"grad_out must be [{keys.shape[0]}, D], got "
                         f"{tuple(getattr(grad_out, 'shape', ()))}")
    if grad_out.device != keys.device:
        raise ValueError(f"grad_out is on {grad_out.device}, keys on "
                         f"{keys.device}")
    if not 0 <= rows < 2**31:
        raise ValueError(f"rows {rows} outside [0, 2**31)")
    dev = keys.device
    if dev.type == "cpu":
        return reference(keys, grad_out, rows)
    if dev.type != "cuda":
        raise ValueError(f"no embedding backward kernel for device {dev}")
    if grad_out.dtype != torch.float32:
        raise TypeError(f"the kernel takes a float32 grad_out, got "
                        f"{grad_out.dtype}")
    grad_out = grad_out.contiguous()
    sorted_keys, perm = torch.sort(keys, stable=True)
    dim = grad_out.shape[1]
    grad = torch.zeros((rows, dim), dtype=torch.float32, device=dev)
    cap = ref.next_entries(keys.shape[0])
    scratch_keys = torch.empty((2, cap), dtype=torch.int32, device=dev)
    scratch_vals = torch.empty((2, cap, dim), dtype=torch.float32,
                               device=dev)
    build().embedding_backward(sorted_keys, perm, grad_out, grad,
                               scratch_keys, scratch_vals)
    embedding_backward.launches += 1
    return grad


embedding_backward.launches = 0


class FieldLayout(NamedTuple):
    """Per-field rows laid end to end in one buffer of ``rows`` rows (a
    lookup's gradient, a batch's id counts): field f's ``vocabs[f]`` rows at
    ``starts[f]``, a multiple of ALIGN_ROWS (256 bytes at one float a row,
    so the fused kernel's aligned path takes every field's view).
    ``vocab_t``, ``start_t``: the same as int64 tensors on the ids'
    device, made once per layout, so a step copies nothing to the card."""

    vocabs: tuple
    starts: tuple
    rows: int
    vocab_t: torch.Tensor
    start_t: torch.Tensor

    def keys(self, ids: torch.Tensor) -> torch.Tensor:
        """``[B * F]`` int32 rows of the buffer that ``[B, F]`` ids read,
        row-major; an id outside ``[0, V_f)`` gets ``rows`` (dropped)."""
        ids = ids.to(torch.int64)
        inside = (ids >= 0) & (ids < self.vocab_t)
        return torch.where(inside, ids + self.start_t,
                           self.rows).to(torch.int32).reshape(-1)

    def split(self, buf: torch.Tensor) -> list:
        """Each field's ``[V_f, ...]`` rows: a view of ``buf``."""
        return [buf[s:s + v] for s, v in zip(self.starts, self.vocabs)]


@functools.cache
def field_layout(vocabs: tuple, device: torch.device) -> FieldLayout:
    starts, end = [], 0
    for v in vocabs:
        start = -(-end // ALIGN_ROWS) * ALIGN_ROWS
        starts.append(start)
        end = start + v
    return FieldLayout(tuple(vocabs), tuple(starts), end,
                       torch.tensor(vocabs, dtype=torch.int64, device=device),
                       torch.tensor(starts, dtype=torch.int64, device=device))


class _GatherFields(torch.autograd.Function):
    """``out[b, f] = tables[f][min(ids[b, f], V_f - 1)]``; the backward is
    ``embedding_backward`` over all the fields at once."""

    @staticmethod
    def forward(ctx, ids, *tables):
        cols = [F.embedding(torch.clamp_max(ids[:, f], t.shape[0] - 1), t)
                for f, t in enumerate(tables)]
        ctx.save_for_backward(ids)
        ctx.vocabs = tuple(t.shape[0] for t in tables)
        return torch.stack(cols, dim=1)

    @staticmethod
    def backward(ctx, grad):
        if not any(ctx.needs_input_grad[1:]):
            return (None,) * (1 + len(ctx.vocabs))
        ids, = ctx.saved_tensors
        layout = field_layout(ctx.vocabs, ids.device)
        g = embedding_backward(layout.keys(ids),
                               grad.reshape(-1, grad.shape[-1]), layout.rows)
        return (None, *layout.split(g))


def gather_fields(tables: Sequence[torch.Tensor],
                  ids: torch.Tensor) -> torch.Tensor:
    """``[B, F, D]`` rows of ``F`` tables (``[V_f, D]`` each, one dtype
    and D) at ``[B, F]`` ids, column f from table f: an id ``>= V_f``
    reads the last row and passes no gradient back. The tables' gradients
    come from one ``embedding_backward`` call."""
    if ids.dim() != 2 or ids.shape[1] != len(tables):
        raise ValueError(f"ids must be [B, {len(tables)}], got "
                         f"{tuple(ids.shape)}")
    return _GatherFields.apply(ids, *tables)
