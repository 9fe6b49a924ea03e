"""The port's embedding backward (``repro_torch.kernels.embedding``)
against JAX's gather gradient and PyTorch's CPU ``F.embedding`` backward.

On the CPU ``embedding_backward`` is its plain version: a stable sort and
a segmented sum in the CUDA kernel's order (chunks of 128 sorted
positions, each run of a sub-chunk of 32 summed by one scan tree, then the
chunks' edge runs level by level), for one or more groups of tables read
at the same keys in one call. Inputs come from numpy with a
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
                                           embedding_backward_groups,
                                           field_layout, gather_fields,
                                           reference_groups, sort_plan)
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


def _tree(rows):
    """The kernel's sum of one run of a sub-chunk: an inclusive scan whose
    step o (1, 2, 4, 8, 16) adds element i - o to element i, read at the
    run's last element."""
    xs = list(rows)
    for o in (1, 2, 4, 8, 16):
        xs = [x + xs[i - o] if i >= o else x for i, x in enumerate(xs)]
    return xs[-1]


def test_torch_embedding_backward_levels_sum_in_the_kernel_order():
    """The plain version's order, written out: 320 sorted positions,
    chunks of 128 in sub-chunks of 32. Key 20's segment (positions 20 to
    300) is chunk 0's tail run: each sub-chunk's part summed by the scan
    tree, then carried left to right (carry + part); it fills chunk 1,
    a chunk of one run, whose tail entry is -0.0 under the same key; it
    is chunk 2's head run. Level 1 (6 entries, one chunk) sums its 4
    entries by the same tree. Other keys are runs of one row."""
    rng = np.random.default_rng(5)
    keys = np.concatenate([np.arange(20), np.full(281, 20),
                           np.arange(21, 40)]).astype(np.int32)
    cot = _values(rng, (keys.size, 2), "normal")
    got = embedding_backward(torch.from_numpy(keys), torch.from_numpy(cot),
                             40).numpy()
    t = torch.from_numpy(cot)

    def run(lo, hi):          # a run's parts a sub-chunk each, carried
        edges = [lo, *range(-(-lo // 32) * 32, hi, 32)][lo % 32 == 0:]
        acc = None
        for a, e in zip(edges, edges[1:] + [hi]):
            part = _tree(t[a:e])
            acc = part if acc is None else acc + part
        return acc

    tail0 = run(20, 128)      # chunk 0: lanes 20-31 of sub 0, subs 1-3
    head1 = run(128, 256)     # chunk 1: one run
    head2 = run(256, 301)     # chunk 2: sub 0, lanes 0-12 of sub 1
    want = _tree([tail0, head1, torch.full((2,), -0.0), head2])
    np.testing.assert_array_equal(got[20], want.numpy())
    np.testing.assert_array_equal(got[:20], cot[:20])
    np.testing.assert_array_equal(got[21:], cot[301:])
    assert ref.next_entries(320) == 6 and ref.levels(320) == 2
    assert ref.levels(131072 * 26) == 4


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
    before = embedding_backward_groups.launches
    embedding_backward(torch.zeros(4, dtype=torch.int32), cot, 3)
    assert embedding_backward_groups.launches == before


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
    assert torch.autograd.gradcheck(lambda *t: gather_fields([t], ids)[0],
                                    tables)


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
        out, = embedding.lookup([tt], torch.from_numpy(ids), dtype=dt_t)
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
    out, = embedding.lookup_rows([rt], uniq)
    grads = torch.autograd.grad(out, list(rt.values()), torch.from_numpy(cot))
    out_j, vjp = jax.vjp(lambda r: jax_embedding.lookup_rows(r, uniq_j),
                         {f: jnp.asarray(r) for f, r in rows.items()})
    grads_j = vjp(jnp.asarray(cot))[0]
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    for f, g in zip(rt, grads):
        np.testing.assert_array_equal(g.numpy(), np.asarray(grads_j[f]))
    assert (uniq["field_0"].inv >= cap).any()      # some ids were dropped


def _field_ids(rng, b, vocabs):
    return np.stack([_zipf_ids(rng, b, v) for v in vocabs],
                    axis=1).astype(np.int32)


@pytest.mark.parametrize("dims", [(10, 1), (10, 1, 16), (3, 64, 1, 17)])
def test_torch_embedding_backward_groups_equal_single_calls(dims):
    """One call over groups of tables read at the same keys (the fm and LR
    lookups: D = 10 and 1; then 3 and 4 groups, a D past 32 among them)
    gives each group the bits of its own single call: a column's order of
    additions depends on the sorted keys alone. Zipf fields (runs of
    hundreds of rows over chunk edges), normal values, dropped keys."""
    rng = np.random.default_rng(len(dims))
    vocabs, b = (300, 7, 2000), 1500
    layout = field_layout(vocabs, torch.device("cpu"))
    ids = _field_ids(rng, b, vocabs)
    ids[::9, 1] = 7                                    # past its table
    keys = layout.keys(torch.from_numpy(ids))
    cots = [torch.from_numpy(_values(rng, (keys.numel(), d), "normal"))
            for d in dims]
    before = sort_plan.sorts
    grouped = embedding_backward_groups(sort_plan(keys), cots, layout.rows)
    assert sort_plan.sorts == before + 1
    for d, g, cot in zip(dims, grouped, cots):
        assert g.shape == (layout.rows, d)
        single = embedding_backward(keys, cot, layout.rows)
        assert torch.equal(g, single), d


def test_torch_slot_plan_is_the_stable_sort_without_overflow():
    """The sparse step's plan, built from the 26-style per-field dedups by
    elementwise ops, equals ``torch.sort(stable=True)`` of the slot keys
    element for element when no field overflows (keys and permutation),
    so the gradient is the same bits as with a sort of its own; the
    lookup's backward then makes no sort."""
    rng = np.random.default_rng(17)
    vocabs, b = (40, 3, 900, 1), 3000
    ids = torch.from_numpy(_field_ids(rng, b, vocabs))
    uniq = embedding.batch_unique(ids, vocabs)
    fields = [uniq[f"field_{i}"] for i in range(len(vocabs))]
    layout = field_layout(tuple(u.capacity for u in fields),
                          torch.device("cpu"))
    inv = torch.stack([u.inv for u in fields], dim=1)
    plan = embedding.slot_plan(fields, layout)
    keys, perm = torch.sort(layout.keys(inv), stable=True)
    assert torch.equal(plan.keys, keys) and torch.equal(plan.perm, perm)
    rows = [{f"field_{i}": torch.from_numpy(_values(
        rng, (u.capacity, d), "normal")).requires_grad_()
        for i, u in enumerate(fields)} for d in (10, 1)]
    before = sort_plan.sorts
    outs = embedding.lookup_rows(rows, uniq)
    cots = [torch.from_numpy(_values(rng, tuple(o.shape), "normal"))
            for o in outs]
    grads = torch.autograd.grad(outs, [t for g in rows for t in g.values()],
                                cots)
    assert sort_plan.sorts == before
    want = reference_groups((keys, perm), [c.reshape(-1, c.shape[-1])
                                           for c in cots], layout.rows)
    for g, d in enumerate((10, 1)):
        for f, start in enumerate(layout.starts):
            got = grads[g * len(vocabs) + f]
            assert torch.equal(got, want[g][start:start + fields[f].capacity])


def test_torch_slot_plan_overflow_matches_plain_and_jax():
    """Under overflow the plan puts each field's dropped elements (keyed
    past the buffer) at the end of its own block; the fm and LR slot rows'
    gradients through ``lookup_rows`` equal the plain version on that plan
    bitwise and JAX's ``lookup_rows`` gradients within 1e-5."""
    rng = np.random.default_rng(19)
    vocabs, b, cap = (60, 6, 400), 700, 8
    ids = np.stack([rng.integers(0, v, b) for v in vocabs],
                   axis=1).astype(np.int32)
    uniq = embedding.batch_unique(torch.from_numpy(ids), vocabs, cap)
    uniq_j = jax_embedding.batch_unique(jnp.asarray(ids), vocabs, cap)
    fields = [uniq[f"field_{i}"] for i in range(len(vocabs))]
    layout = field_layout(tuple(u.capacity for u in fields),
                          torch.device("cpu"))
    plan = embedding.slot_plan(fields, layout)
    blocks = plan.keys.view(len(vocabs), b)
    dropped = blocks == layout.rows
    assert dropped[0].any() and dropped[2].any() and not dropped[1].any()
    for blk, drop in zip(blocks, dropped):       # dropped end each block
        n_keep = int((~drop).sum())
        assert not drop[:n_keep].any() and drop[n_keep:].all()
        assert torch.equal(blk[:n_keep], torch.sort(blk[:n_keep]).values)
    rows = [{f: (0.1 * rng.standard_normal((u.capacity, d))).astype(
        np.float32) for f, u in uniq.items()} for d in (10, 1)]
    rt = [{f: torch.from_numpy(r).requires_grad_() for f, r in g.items()}
          for g in rows]
    outs = embedding.lookup_rows(rt, uniq)
    cots = [_values(rng, tuple(o.shape), "normal") for o in outs]
    grads = torch.autograd.grad(outs, [t for g in rt for t in g.values()],
                                [torch.from_numpy(c) for c in cots])
    want = reference_groups(plan, [torch.from_numpy(c).reshape(-1, c.shape[-1])
                                   for c in cots], layout.rows)
    for g in range(2):
        for f, (name, start) in enumerate(zip(rows[g], layout.starts)):
            got = grads[g * len(vocabs) + f]
            assert torch.equal(got, want[g][start:start + fields[f].capacity]
                               ), (g, name)
            _, vjp = jax.vjp(
                lambda r: jax_embedding.lookup_rows(r, uniq_j),
                {k: jnp.asarray(v) for k, v in rows[g].items()})
            grad_j = vjp(jnp.asarray(cots[g]))[0][name]
            np.testing.assert_allclose(got.numpy(), np.asarray(grad_j),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("planned", [False, True])
def test_torch_gather_fields_grouped_gradcheck_float64(planned):
    """The grouped autograd Function in float64 (groups of D = 3 and 1,
    and a third of D = 2), with its own sort and with a plan given (the
    sparse step's, from the dedups): every table's gradient from one
    backward call, against finite differences."""
    rng = np.random.default_rng(23)
    vocabs, b = (5, 3, 8), 40
    ids = np.stack([rng.integers(0, v, b) for v in vocabs],
                   axis=1).astype(np.int32)
    plan = None
    if planned:
        uniq = embedding.batch_unique(torch.from_numpy(ids), vocabs)
        fields = [uniq[f"field_{i}"] for i in range(len(vocabs))]
        ids = torch.stack([u.inv for u in fields], dim=1).numpy()
        vocabs = tuple(u.capacity for u in fields)
        plan = embedding.slot_plan(fields, field_layout(vocabs,
                                                        torch.device("cpu")))
    tables = tuple(torch.from_numpy(rng.standard_normal((v, d)))
                   .requires_grad_() for d in (3, 1, 2) for v in vocabs)
    n = len(vocabs)

    def fn(*t):
        return gather_fields([t[:n], t[n:2 * n], t[2 * n:]],
                             torch.from_numpy(ids), plan=plan)

    assert torch.autograd.gradcheck(fn, tables)
