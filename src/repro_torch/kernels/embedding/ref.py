"""Plain PyTorch version of the deterministic embedding backward.

The same function as ``csrc/embedding_backward.cu``, summed in the same
order: a stable sort of the keys, then a segmented sum over the sorted
positions in chunks of ``CHUNK``, each chunk's runs of equal keys summed
in ascending position, a run inside a chunk written, and each chunk's
first and last runs carried to the next level (the last level writes
every run). Keys ``>= rows`` pass no gradient. It is the CPU path of
``ops.embedding_backward`` and the kernel's oracle on the card (any float
dtype; the kernel takes float32).
"""

from __future__ import annotations

import torch

CHUNK = 32        # csrc/embedding_backward.h: kEmbedBwdChunk


def next_entries(n: int) -> int:
    """Entries of the level after one of ``n``: two a chunk."""
    return 2 * (-(-n // CHUNK))


def _level(keys, empty, vals, rows, grad, last):
    """One level over ``n`` entries (int64 ``keys``, bool ``empty``,
    ``[n, D]`` ``vals``): writes the runs it closes into ``grad`` and
    returns the next level's ``(keys, empty, vals)``, or None at the
    last level."""
    n, dim = vals.shape
    chunks = -(-n // CHUNK)
    pad = chunks * CHUNK - n
    dev = vals.device
    valid = (torch.arange(chunks * CHUNK, device=dev) < n).view(chunks, CHUNK)
    k = torch.cat([keys, keys.new_full((pad,), -1)]).view(chunks, CHUNK)
    e = torch.cat([empty, empty.new_zeros(pad)]).view(chunks, CHUNK)
    v = torch.cat([vals, vals.new_zeros(pad, dim)]).view(chunks, CHUNK, dim)
    start = valid.clone()
    start[:, 1:] &= k[:, 1:] != k[:, :-1]
    end = valid.clone()
    end[:, :-1] &= k[:, :-1] != k[:, 1:]
    # each run summed from its first entry in ascending position; an empty
    # entry adds nothing
    acc = torch.empty_like(v)
    run_sum = v[:, 0]
    for j in range(CHUNK):
        if j:
            run_sum = torch.where(e[:, j, None], run_sum, run_sum + v[:, j])
            run_sum = torch.where(start[:, j, None], v[:, j], run_sum)
        acc[:, j] = run_sum
    run = torch.cumsum(start.to(torch.int64), 1) - 1
    runs = start.sum(1, keepdim=True)
    write = end if last else end & (run != 0) & (run != runs - 1)
    write &= k < rows
    grad[k[write]] = acc[write]
    if last:
        return None
    ar = torch.arange(chunks, device=dev)
    head_end = torch.argmax(end.to(torch.int8), 1)       # run 0's end
    tail_end = valid.sum(1) - 1                           # the last run's
    one = runs[:, 0] == 1
    nkeys = torch.stack([k[ar, 0], k[ar, tail_end]], 1).reshape(-1)
    nempty = torch.stack([torch.zeros_like(one), one], 1).reshape(-1)
    tail = torch.where(one[:, None], torch.zeros_like(acc[:, 0]),
                       acc[ar, tail_end])
    nvals = torch.stack([acc[ar, head_end], tail], 1).reshape(-1, dim)
    return nkeys, nempty, nvals


def segment_sum_sorted(sorted_keys, perm, grad_out, grad):
    """Fill ``grad`` ([rows, D], zeros) with the segmented sum of
    ``grad_out``'s rows ``perm`` under ``sorted_keys`` (ascending), level
    by level as the kernel sums them. Returns ``grad``."""
    rows = grad.shape[0]
    n = sorted_keys.numel()
    if n == 0:
        return grad
    keys = sorted_keys.to(torch.int64)
    empty = torch.zeros(n, dtype=torch.bool, device=grad.device)
    vals = grad_out[perm]
    while True:
        last = n <= CHUNK
        out = _level(keys, empty, vals, rows, grad, last)
        if last:
            return grad
        keys, empty, vals = out
        n = keys.numel()


def embedding_backward_reference(keys: torch.Tensor, grad_out: torch.Tensor,
                                 rows: int) -> torch.Tensor:
    """``[rows, D]`` gradient of a gather whose output row i read row
    ``keys[i]`` (``keys`` [N] int, ``grad_out`` [N, D]): the stable sort and
    the kernel's segmented sum; keys ``>= rows`` dropped."""
    sorted_keys, perm = torch.sort(keys, stable=True)
    grad = torch.zeros((rows, grad_out.shape[1]), dtype=grad_out.dtype,
                       device=grad_out.device)
    return segment_sum_sorted(sorted_keys, perm, grad_out, grad)
