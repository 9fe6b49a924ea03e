"""The port's embedding backward (``repro_torch.kernels.embedding``)
against JAX's gather gradient and PyTorch's CPU ``F.embedding`` backward.

On the CPU ``embedding_backward`` is its plain version: a stable sort and
a segmented sum in the CUDA kernel's order (chunks of 32 sorted positions,
then the chunks' edge runs level by level). Inputs come from numpy with a
seed. Two kinds of values: dyadic ones (multiples of 1/64, every partial
sum exact in f32, so every order of addition gives the same bits and the
results must be equal) and normal ones, held at rtol 1e-6 with an atol
of 1e-7 (sums in another order differ by rounding; the segments here are
small enough for that bar). The kernel itself is held to this plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import embedding as jax_embedding
from repro_torch.kernels.embedding import (embedding_backward,
                                           gather_fields, field_layout)
from repro_torch.kernels.embedding import ref
from repro_torch.models import embedding

TOL = dict(rtol=1e-6, atol=1e-7)


def _values(rng, shape, kind):
    if kind == "dyadic":
        return (rng.integers(-8, 9, shape) / 64.0).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _zipf_ids(rng, n, vocab):
    return np.minimum(rng.zipf(1.3, n) - 1, vocab - 1).astype(np.int32)


def _jax_take_grad(vocab, ids, cot):
    table = jnp.zeros((vocab, cot.shape[1]), jnp.float32)
    _, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(ids), axis=0), table)
    return np.asarray(vjp(jnp.asarray(cot))[0])


def _torch_embedding_grad(vocab, ids, cot):
    table = torch.zeros((vocab, cot.shape[1]), dtype=torch.float32,
                        requires_grad=True)
    out = F.embedding(torch.from_numpy(ids).long(), table)
    return torch.autograd.grad(out, table, torch.from_numpy(cot))[0].numpy()


def _check(got, want, kind, what):
    if kind == "dyadic":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)


@pytest.mark.parametrize("dim", [1, 10, 16, 17])
@pytest.mark.parametrize("kind", ["dyadic", "normal"])
def test_torch_embedding_backward_matches_jax_and_torch(dim, kind):
    """The plain version's gradient equals JAX's ``jnp.take`` gradient and
    ``F.embedding``'s CPU backward: bitwise for dyadic values on a Zipf
    column (a few ids thousands of times, a long tail) and a uniform one;
    at rtol 1e-6 for normal values on a uniform column of a few rows an id
    (a Zipf id's sum of hundreds of normal values differs by its order of
    additions alone by more than 1e-6: the dyadic case covers those)."""
    rng = np.random.default_rng(dim)
    n, vocab = (6000, 300) if kind == "dyadic" else (700, 400)
    columns = [rng.integers(0, vocab, n).astype(np.int32)]
    if kind == "dyadic":
        columns.append(_zipf_ids(rng, n, vocab))
    for ids in columns:
        cot = _values(rng, (n, dim), kind)
        got = embedding_backward(torch.from_numpy(ids), torch.from_numpy(cot),
                                 vocab).numpy()
        _check(got, _jax_take_grad(vocab, ids, cot), kind, "vs jnp.take")
        _check(got, _torch_embedding_grad(vocab, ids, cot), kind,
               "vs F.embedding")


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1025, 40000])
def test_torch_embedding_backward_one_id_and_last_row(n):
    """A field of one id (one segment of n rows: at 40000 the sum runs over
    four levels) at row V - 1, beside a column of ids all at V - 1 and a
    column spread over the table; dyadic values, so the sums are exact:
    the gradient equals the exact per-row sums, bitwise."""
    rng = np.random.default_rng(n)
    vocab, dim = 7, 3
    for ids in (np.full(n, vocab - 1, np.int32),
                np.full(n, 2, np.int32),
                rng.integers(0, vocab, n).astype(np.int32)):
        cot = _values(rng, (n, dim), "dyadic")
        got = embedding_backward(torch.from_numpy(ids), torch.from_numpy(cot),
                                 vocab).numpy()
        want = np.zeros((vocab, dim), np.float64)
        np.add.at(want, ids, cot.astype(np.float64))
        np.testing.assert_array_equal(got, want.astype(np.float32))


def test_torch_embedding_backward_drops_ids_past_the_table():
    """Keys >= rows pass no gradient (the reference's dropping scatter):
    ids V, V + 5 and 2**31 - 1 beside in-range ones give the gradient of
    the in-range rows alone; every row no id names stays 0."""
    rng = np.random.default_rng(3)
    vocab, dim, n = 50, 4, 3000
    ids = _zipf_ids(rng, n, vocab)
    ids[::7] = vocab
    ids[1::11] = vocab + 5
    ids[2::13] = 2**31 - 1
    cot = _values(rng, (n, dim), "dyadic")
    got = embedding_backward(torch.from_numpy(ids), torch.from_numpy(cot),
                             vocab).numpy()
    keep = ids < vocab
    want = np.zeros((vocab, dim), np.float64)
    np.add.at(want, ids[keep], cot[keep].astype(np.float64))
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert not got[np.setdiff1d(np.arange(vocab), ids[keep])].any()


def test_torch_embedding_backward_levels_sum_in_the_kernel_order():
    """The plain version's order, written out: a segment of 70 rows in
    one chunk's tail, two whole chunks and a third's head is summed chunk
    by chunk in ascending position (32-row runs: 6, 32, 32 rows) and the
    three partials combined in chunk order at the next level; other
    segments are interior runs written at level 0."""
    rng = np.random.default_rng(5)
    keys = np.concatenate([np.arange(26), np.full(70, 26), [27]]).astype(
        np.int32)
    cot = _values(rng, (keys.size, 2), "normal")
    got = embedding_backward(torch.from_numpy(keys), torch.from_numpy(cot),
                             28).numpy()
    t = torch.from_numpy(cot)

    def seq(rows):
        acc = rows[0]
        for r in rows[1:]:
            acc = acc + r
        return acc

    parts = [seq(t[26:32]), seq(t[32:64]), seq(t[64:96])]
    np.testing.assert_array_equal(got[26], (parts[0] + parts[1]
                                            + parts[2]).numpy())
    np.testing.assert_array_equal(got[:26], cot[:26])
    np.testing.assert_array_equal(got[27], cot[96])
    assert ref.next_entries(97) == 8


def test_torch_embedding_backward_contract():
    """int32 keys only; a device with neither the kernel nor the plain
    version raises; the CPU path launches nothing."""
    cot = torch.ones(4, 2)
    with pytest.raises(TypeError):
        embedding_backward(torch.zeros(4, dtype=torch.int64), cot, 3)
    with pytest.raises(ValueError):
        embedding_backward(torch.zeros(4, dtype=torch.int32), cot[:3], 3)
    with pytest.raises(ValueError, match="no embedding backward kernel"):
        embedding_backward(torch.zeros(4, dtype=torch.int32, device="meta"),
                           torch.ones(4, 2, device="meta"), 3)
    before = embedding_backward.launches
    embedding_backward(torch.zeros(4, dtype=torch.int32), cot, 3)
    assert embedding_backward.launches == before


def test_torch_gather_fields_gradcheck_float64():
    """The autograd Function in float64: every field's gradient through one
    backward call, against finite differences (in-range ids: a dropped id
    still reads the last row, so its finite difference is not 0)."""
    rng = np.random.default_rng(7)
    vocabs = (5, 3, 8)
    tables = tuple(torch.from_numpy(rng.standard_normal((v, 2)))
                   .requires_grad_() for v in vocabs)
    ids = torch.from_numpy(np.stack([rng.integers(0, v, 40) for v in vocabs],
                                    axis=1).astype(np.int32))
    assert torch.autograd.gradcheck(lambda *t: gather_fields(t, ids), tables)


def test_torch_gather_fields_layout_views():
    """All fields' gradients are views of one buffer, each table's start a
    multiple of 64 rows; ids outside [0, V_f) are keyed past the buffer."""
    lay = field_layout((5, 70, 1), torch.device("cpu"))
    assert lay.starts == (0, 64, 192) and lay.rows == 193
    keys = lay.keys(torch.tensor([[4, 69, 0], [5, -1, 1]]))
    assert keys.tolist() == [4, 133, 192, 193, 193, 193]
    assert keys.dtype == torch.int32


def test_torch_lookup_matches_jax_and_bf16_cotangent_is_f32():
    """``models.embedding.lookup`` over 4 fields against JAX's, forward and
    table gradients, in f32 and under a bf16 compute dtype (the cast sits
    after the gather: the Function sees an f32 cotangent, the tables get
    f32 gradients); dyadic cotangents, so the sums are exact."""
    rng = np.random.default_rng(11)
    vocabs, dim, b = (40, 7, 300, 1), 10, 2000
    tabs = {f"field_{i}": (0.01 * rng.standard_normal((v, dim))).astype(
        np.float32) for i, v in enumerate(vocabs)}
    ids = np.stack([_zipf_ids(rng, b, v) for v in vocabs], axis=1)
    cot = _values(rng, (b, len(vocabs), dim), "dyadic")
    for dt_t, dt_j in ((None, None), (torch.bfloat16, jnp.bfloat16)):
        tt = {k: torch.from_numpy(v).requires_grad_() for k, v in tabs.items()}
        out = embedding.lookup(tt, torch.from_numpy(ids), dtype=dt_t)
        grads = torch.autograd.grad(out, list(tt.values()),
                                    torch.from_numpy(cot).to(out.dtype))
        out_j, vjp = jax.vjp(
            lambda t: jax_embedding.lookup(t, jnp.asarray(ids), dtype=dt_j),
            {k: jnp.asarray(v) for k, v in tabs.items()})
        grads_j = vjp(jnp.asarray(cot).astype(out_j.dtype))[0]
        np.testing.assert_array_equal(out.float().detach().numpy(),
                                      np.asarray(out_j.astype(jnp.float32)))
        for k, g in zip(tt, grads):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(grads_j[k]),
                                          err_msg=f"{dt_t} {k}")


def test_torch_lookup_rows_overflow_matches_jax_clamping_gather():
    """Three fields at a capacity that two of them overflow: the forward
    reads the last kept slot for a dropped id, as JAX's clamping gather,
    and the backward drops its gradient; the row gradients equal JAX's."""
    rng = np.random.default_rng(13)
    vocabs, b, cap = (60, 9, 400), 500, 8
    ids = np.stack([rng.integers(0, v, b) for v in vocabs],
                   axis=1).astype(np.int32)
    uniq = embedding.batch_unique(torch.from_numpy(ids), vocabs, cap)
    uniq_j = jax_embedding.batch_unique(jnp.asarray(ids), vocabs, cap)
    rows = {f: (0.1 * rng.standard_normal((u.capacity, 3))).astype(
        np.float32) for f, u in uniq.items()}
    assert [u.capacity for u in uniq.values()] == [8, 8, 8]
    cot = _values(rng, (b, len(vocabs), 3), "dyadic")
    rt = {f: torch.from_numpy(r).requires_grad_() for f, r in rows.items()}
    out = embedding.lookup_rows(rt, uniq)
    grads = torch.autograd.grad(out, list(rt.values()), torch.from_numpy(cot))
    out_j, vjp = jax.vjp(lambda r: jax_embedding.lookup_rows(r, uniq_j),
                         {f: jnp.asarray(r) for f, r in rows.items()})
    grads_j = vjp(jnp.asarray(cot))[0]
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    for f, g in zip(rt, grads):
        np.testing.assert_array_equal(g.numpy(), np.asarray(grads_j[f]))
    assert (uniq["field_0"].inv >= cap).any()      # some ids were dropped
