"""Plain PyTorch version of the deterministic embedding backward.

The same function as ``csrc/embedding_backward.cu``, summed in the same
order, for one or more groups of ``[N, D_g]`` cotangents read at the same
keys: the keys in a sorted order (each key's positions contiguous; a
stable sort, or a plan built from sorts already made), then a segmented
sum over the sorted positions in chunks of ``CHUNK``, each a sub-chunk of
``LANES`` at a time. Within a sub-chunk every run of equal keys is summed
by the same tree, an inclusive scan whose step ``o`` (1, 2, 4, 8, 16)
adds position ``i - o`` to position ``i`` where both lie in the run; the
sub-chunk's first run then adds the sum so far of the run it goes on from
(``carry + part``). A run inside a chunk is written; each chunk's first
and last runs go on to the next level (a chunk of one run passes ``-0.0``
as its last, which adds nothing), and the last level writes every run.
Keys outside ``[0, rows)`` pass no gradient. The order depends on the
sorted keys alone, not on D nor on the groups beside a column. It is the
CPU path of ``ops.embedding_backward_groups`` and the kernel's oracle on
the card (any float dtype; the kernel takes float32).
"""

from __future__ import annotations

import torch

CHUNK = 128       # csrc/embedding_backward.h: kEmbedBwdChunk
LANES = 32        # a sub-chunk: one warp's lanes
SUBS = CHUNK // LANES
MAX_GROUPS = 4    # csrc/embedding_backward.h: kEmbedBwdMaxGroups


def next_entries(n: int) -> int:
    """Entries of the level after one of ``n``: two a chunk."""
    return 2 * (-(-n // CHUNK))


def levels(n: int) -> int:
    """Level launches of one call over ``n`` sorted positions."""
    count = 0
    while n > 0:
        count += 1
        if n <= CHUNK:
            break
        n = next_entries(n)
    return count


def _scan(v, first, cont):
    """The kernel's sums of ``v`` ([chunks, SUBS, LANES, D]): each run's
    running sum at each of its positions, carried across sub-chunks."""
    lane = torch.arange(LANES, device=v.device)
    for o in (1, 2, 4, 8, 16):
        t = torch.zeros_like(v)
        t[:, :, o:] = v[:, :, :-o]
        v = torch.where((lane - o >= first)[..., None], v + t, v)
    lead = (first == 0) & cont[..., None]        # runs carried into a sub
    for s in range(1, SUBS):
        carry = v[:, s - 1, LANES - 1]
        v[:, s] = torch.where(lead[:, s, :, None], carry[:, None] + v[:, s],
                              v[:, s])
    return v.reshape(v.shape[0], CHUNK, -1)


def _level(keys, vals, rows, grads, last):
    """One level over ``n`` entries (int64 ``keys``; each group's ``[n,
    D_g]`` ``vals``): writes the runs it closes into ``grads`` and returns
    the next level's ``(keys, vals)``, or None at the last level."""
    n = keys.numel()
    chunks = -(-n // CHUNK)
    pad = chunks * CHUNK - n
    dev = keys.device
    valid = (torch.arange(chunks * CHUNK, device=dev) < n).view(chunks, CHUNK)
    k = torch.cat([keys, keys.new_zeros(pad)]).view(chunks, CHUNK)
    ks = k.view(chunks, SUBS, LANES)
    starts = torch.ones_like(ks, dtype=torch.bool)
    starts[..., 1:] = ks[..., 1:] != ks[..., :-1]
    lane = torch.arange(LANES, device=dev)
    first = torch.cummax(torch.where(starts, lane, 0), dim=-1).values
    cont = torch.zeros((chunks, SUBS), dtype=torch.bool, device=dev)
    cont[:, 1:] = (ks[:, 1:, 0] == ks[:, :-1, -1]) & valid.view(
        chunks, SUBS, LANES)[:, 1:, 0]
    end = valid.clone()
    end[:, :-1] &= (k[:, :-1] != k[:, 1:]) | ~valid[:, 1:]
    ar = torch.arange(chunks, device=dev)
    pos = torch.arange(CHUNK, device=dev)
    head_end = torch.argmax(end.to(torch.int8), 1)      # the head run's end
    tail_end = valid.sum(1) - 1                          # the last position
    write = end.clone()
    if not last:
        write &= (pos != head_end[:, None]) & (pos != tail_end[:, None])
    write &= (k >= 0) & (k < rows)
    out = []
    for vals_g, grad in zip(vals, grads):
        dim = vals_g.shape[1]
        v = torch.cat([vals_g, vals_g.new_zeros(pad, dim)]).view(
            chunks, SUBS, LANES, dim)
        acc = _scan(v, first, cont)
        grad[k[write]] = acc[write]
        if not last:
            tail = torch.where((head_end == tail_end)[:, None],
                               torch.full_like(acc[:, 0], -0.0),
                               acc[ar, tail_end])
            out.append(torch.stack([acc[ar, head_end], tail], 1)
                       .reshape(-1, dim))
    if last:
        return None
    return torch.stack([k[:, 0], k[ar, tail_end]], 1).reshape(-1), out


def segment_sum_sorted(sorted_keys, perm, grad_outs, grads):
    """Fill each of ``grads`` ([rows, D_g], zeros) with the segmented sum
    of its ``grad_outs``' rows ``perm`` under ``sorted_keys``, level by
    level as the kernel sums them. Returns ``grads``."""
    rows = grads[0].shape[0]
    n = sorted_keys.numel()
    keys = sorted_keys.to(torch.int64)
    vals = [g[perm] for g in grad_outs]
    while n:
        last = n <= CHUNK
        out = _level(keys, vals, rows, grads, last)
        if last:
            break
        keys, vals = out
        n = keys.numel()
    return grads


def embedding_backward_groups_reference(plan, grad_outs, rows: int) -> list:
    """Each group's ``[rows, D_g]`` gradient of a gather whose output row
    ``i`` read row ``keys[i]``, given the keys' sort ``plan`` (sorted keys,
    and the output row of each sorted position) and each group's ``[N,
    D_g]`` cotangent: the kernel's segmented sum; keys outside ``[0,
    rows)`` dropped."""
    grads = [torch.zeros((rows, g.shape[1]), dtype=g.dtype, device=g.device)
             for g in grad_outs]
    return segment_sum_sorted(plan[0], plan[1], grad_outs, grads)


def embedding_backward_reference(keys: torch.Tensor, grad_out: torch.Tensor,
                                 rows: int) -> torch.Tensor:
    """``[rows, D]`` gradient of a gather whose output row i read row
    ``keys[i]`` (``keys`` [N] int, ``grad_out`` [N, D]): the stable sort and
    the kernel's segmented sum; keys outside ``[0, rows)`` dropped."""
    return embedding_backward_groups_reference(
        torch.sort(keys, stable=True), [grad_out], rows)[0]
