"""Peaks of the card and the least work of each operation the per-layer
metrics read.

Frozen here, beside the benchmark, so that a change to the program cannot
change the yardstick. Each count is of the operation's work at its
interface, the same whatever implements it: every input read once and
every output written once, from the shapes and, where the work depends on
the data, from the inputs (the rows a batch touches); nothing that only
one implementation keeps, fills or recomputes. A bound is the larger of
the bytes over the memory's rate and the operations over the peak of the
precision the configuration states. Copied from ``chip_smoke.py``'s
``update_bound``, ``embed_bound``, ``wkv_bound`` and ``wkv_bwd_bound``,
with the embedding backward's dense gradient and the scan's kept chunk
states taken out of the counts.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}


def bound_s(nbytes: float, flops: float, precision: str = "float32"):
    """``(seconds, "bytes" or "operations")``: the least time, and which
    of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS_PER_S[precision]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fused_update(vocab: int, touched: int, dim: int):
    """``(bytes, flops)`` of one fused CowClip + coupled-L2 + Adam update
    of a ``[vocab, dim]`` table: every row reads its count and reads and
    writes w (its interface decays every row's w each step); a touched row
    also reads g, m and v and writes m and v. About 21 f32 operations per
    touched element, one per absent element."""
    absent = vocab - touched
    nbytes = touched * 28 * dim + absent * 8 * dim + 4 * vocab
    flops = touched * dim * 21 + absent * dim
    return nbytes, flops


def sparse_pair(touched: int, dim: int):
    """``(bytes, flops)`` of the sparse update of one table's ``touched``
    rows (the catch-up and the update together): each touched row reads
    its id, count, last step, its gradient and w, m and v, and writes w,
    m, v and its last step. The rows the catch-up hands the update, and
    the static capacity's pad slots, are the implementation's. About 26
    f32 operations per element and 20 per row (the decay's power)."""
    nbytes = touched * (16 + 28 * dim)
    flops = touched * (26 * dim + 20)
    return nbytes, flops


def embedding_backward(n_keys: int, dims, touched: int):
    """``(bytes, flops)`` of the gradient of a gather of ``n_keys`` rows
    for each group of tables of a width in ``dims``: the keys read, each
    group's cotangent read, and the gradient of the ``touched`` distinct
    rows written, once each; one add per cotangent element. The zero rows
    of a dense ``[V, D]`` gradient are no part of it."""
    nbytes = 4 * n_keys + sum(4 * n_keys * d + 4 * touched * d for d in dims)
    return nbytes, n_keys * sum(dims)


def wkv6_forward(bh: int, seq: int, n: int, chunk: int = 16):
    """``(bytes, flops)`` of one chunked WKV6 forward: r, k, v, w read and
    y written, u read and the final state written (f32); 4 L^2 N + 4 L N^2
    operations per (bh, chunk). The chunk states a training call keeps for
    its backward are the implementation's."""
    nbytes = 4 * (5 * bh * seq * n + bh * n + bh * n * n)
    flops = bh * (seq // chunk) * (4 * chunk * chunk * n + 4 * chunk * n * n)
    return nbytes, flops


def wkv6_backward(bh: int, seq: int, n: int, chunk: int = 16):
    """``(bytes, flops)`` of one WKV6 backward: r, k, v, w and y's
    cotangent read and dr, dk, dv, dw written, u read and du written, the
    final state's cotangent read (f32); 8 L N^2 + 10 L^2 N operations per
    (bh, chunk). The chunk states kept by the forward are the
    implementation's."""
    nbytes = 4 * (9 * bh * seq * n + 2 * bh * n + bh * n * n)
    flops = bh * (seq // chunk) * (8 * chunk * n * n + 10 * chunk * chunk * n)
    return nbytes, flops


def ctr_model_flops(n_fields: int, emb_dim: int, n_dense: int,
                    mlp_dims) -> int:
    """A DeepFM row's model FLOPs, forward and backward: the deep tower's
    products (2 m k a row forward, twice that backward) and the FM term
    (the field sum, the squares and their sums: about 4 F D forward, twice
    that backward)."""
    dims = [n_fields * emb_dim + n_dense] + list(mlp_dims) + [1]
    tower = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    fm = 4 * n_fields * emb_dim
    return 3 * (tower + fm)


def share(bound: float, seconds: float):
    """A bound's share of a measured time, in %, or None with no time."""
    if seconds <= 0:
        return None
    return 100.0 * bound / seconds


def rwkv6_nonembedding_params(config: dict) -> int:
    """An RWKV-6 model's parameters outside its token table (the output
    head included), from the configuration's shapes."""
    d, f, r = config["d_model"], config["d_ff"], config["decay_rank"]
    vocab = -(-config["vocab_size"] // 256) * 256
    layer = (6 * d * d + 2 * d * r + 2 * d * f     # the products
             + 11 * d                               # mixes, w0, u, norms
             + d)                                   # ln_scale (H x N)
    return config["n_layers"] * layer + d + d * vocab


def lm_step_flops(config: dict, batch: int, seq: int) -> int:
    """An RWKV-6 step's model FLOPs: 6 per non-embedding parameter and
    token (forward and backward), and the scan's, three times its forward
    a layer."""
    tokens = batch * seq
    n = config["d_model"] // config["n_heads"]
    scan = wkv6_forward(batch * config["n_heads"], seq, n)[1]
    return (6 * rwkv6_nonembedding_params(config) * tokens
            + 3 * config["n_layers"] * scan)
