"""The port's sparse unique-id layer and its two kernels' plain versions
against the JAX package's.

On the CPU ``repro_torch.kernels.cowclip.sparse_gather_catchup`` and
``sparse_update_scatter`` run their plain PyTorch versions; the CUDA
kernels are held to those on the card by tests/test_torch_cuda.py and
chip_smoke.py. Here the plain versions meet the JAX jnp references
(``use_kernel=False``) and, at the tiny sizes where interpret mode is
cheap, the Pallas kernels themselves. Inputs come from NumPy with a seed
and go to both frameworks unchanged. Tolerances: rtol 1e-5 / atol 1e-7,
the JAX kernels' own bar, unless a test says otherwise; ``last_step`` and
the index structures must be equal.
"""

try:
    import hypothesis
    import hypothesis.strategies as st
except ImportError:  # fall back to deterministic parametrized sweeps
    from hypcompat import hypothesis, st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import optim as jax_optim
from repro.core.cowclip import cowclip_rows as jax_cowclip_rows
from repro.kernels.cowclip import ref as jax_ref
from repro.kernels.cowclip import sparse as jax_sparse
from repro.kernels.cowclip import sparse_gather_catchup as jax_catchup
from repro.kernels.cowclip import sparse_update_scatter as jax_update
from repro.models import embedding as jax_embedding
from repro.serve.engine import collapse_pending_decay as jax_collapse
from repro_torch.core import optim
from repro_torch.core.cowclip import cowclip_rows
from repro_torch.kernels.cowclip import (sparse_cowclip_adam_reference,
                                         sparse_gather_catchup,
                                         sparse_gather_catchup_tables,
                                         sparse_update_scatter,
                                         sparse_update_scatter_tables,
                                         step_scalars)
from repro_torch.kernels.cowclip.sparse import (MAX_TABLES, launches_for,
                                                safe_uids)
from repro_torch.models import embedding
from repro_torch.serve.engine import collapse_pending_decay

TOL = dict(rtol=1e-5, atol=1e-7)
KW = dict(lr=1e-3, l2=1e-4)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _slots(rng, vocab, cap, n_ids):
    """Sorted distinct uids padded with ``vocab`` to ``cap``, and counts."""
    ids = rng.integers(0, vocab, size=n_ids)
    uids, counts = np.unique(ids, return_counts=True)
    uids, counts = uids[:cap], counts[:cap]
    pad = cap - uids.shape[0]
    return (np.concatenate([uids, np.full(pad, vocab)]).astype(np.int32),
            np.concatenate([counts, np.zeros(pad)]).astype(np.float32))


def _tables(rng, vocab, dim, max_depth=5):
    return dict(
        w=(0.01 * rng.standard_normal((vocab, dim))).astype(np.float32),
        m=(0.001 * rng.standard_normal((vocab, dim))).astype(np.float32),
        v=(1e-4 * np.abs(rng.standard_normal((vocab, dim)))).astype(np.float32),
        ls=rng.integers(0, max_depth, size=vocab).astype(np.int32),
    )


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _j(a):
    return jnp.asarray(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# the two kernels' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [8, 1])
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["jax_reference", "jax_pallas_interpret"])
def test_torch_sparse_kernels_match_jax(dim, use_kernel):
    """Pad slots, per-row pending depths 0..4, step 7: catch-up rows on
    the real slots and the full tables after the update. dim 1 is the
    CowClip-exempt LR stream."""
    rng = np.random.default_rng(dim)
    vocab, cap, t = 50, 12, 7
    tb = _tables(rng, vocab, dim)
    uids, counts = _slots(rng, vocab, cap, 10)
    g_rows = (0.1 * rng.standard_normal((cap, dim))).astype(np.float32)
    n_real = int((counts > 0).sum())
    assert 0 < n_real < cap

    rows_t = sparse_gather_catchup(
        _t(tb["w"]), _t(tb["m"]), _t(tb["v"]), _t(tb["ls"]), _t(uids),
        _t(counts), step_scalars(t), **KW)
    rows_j = jax_catchup(
        _j(tb["w"]), _j(tb["m"]), _j(tb["v"]), _j(tb["ls"]), _j(uids),
        _j(counts), jnp.asarray(t, jnp.int32), use_kernel=use_kernel, **KW)
    for a, b, name in zip(rows_t, rows_j, "wmv"):
        np.testing.assert_allclose(_np(a)[:n_real], _np(b)[:n_real],
                                   err_msg=f"{name}_rows", **TOL)
        assert np.isfinite(_np(a)).all()

    tables_t = [_t(tb[k]) for k in ("w", "m", "v", "ls")]
    out_t = sparse_update_scatter(
        *tables_t, _t(uids), _t(counts), rows_t[0], _t(g_rows), rows_t[1],
        rows_t[2], step_scalars(t), **KW)
    assert all(a is b for a, b in zip(out_t, tables_t))   # in place
    # JAX on the same caught-up rows (the port's), so only the update differs
    out_j = jax_update(
        *(_j(tb[k]) for k in ("w", "m", "v", "ls")), _j(uids), _j(counts),
        _j(_np(rows_t[0])), _j(g_rows), _j(_np(rows_t[1])),
        _j(_np(rows_t[2])), jnp.asarray(t, jnp.int32), use_kernel=use_kernel,
        **KW)
    for a, b, name in zip(out_t[:3], out_j[:3], "wmv"):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=name, **TOL)
    np.testing.assert_array_equal(_np(out_t[3]), _np(out_j[3]))


def _table_case(rng, vocab, dim, cap, n_ids, off=0, extra_rows=0):
    """A table (or its shard ``[off, vocab)`` with ``extra_rows`` pad rows
    after it, as a row-sharded layout pads it) with pending depths 0..5,
    ``cap`` slots holding the distinct ids of ``n_ids`` draws from the
    shard's range (the smallest ``cap`` on overflow), pads holding the
    global ``vocab``, and a slot-row gradient."""
    tb = _tables(rng, vocab - off + extra_rows, dim, max_depth=6)
    uids, counts = _slots(rng, vocab - off, cap, n_ids)
    real = counts > 0
    uids[real] += off
    uids[~real] = vocab
    tb.update(uids=uids, counts=counts, off=off, g=(
        0.1 * rng.standard_normal((cap, dim))).astype(np.float32))
    return tb


def _mixed_cases(rng):
    """D = 8 and D = 1 with pads, a capacity of 1, a table with no real
    slot, a table full to its capacity and one past it (overflow), and a
    row shard whose pad uid lands in its range."""
    return [_table_case(rng, 50, 8, 12, 10), _table_case(rng, 50, 1, 12, 10),
            _table_case(rng, 9, 8, 1, 1), _table_case(rng, 30, 4, 6, 0),
            _table_case(rng, 6, 8, 6, 60), _table_case(rng, 40, 1, 5, 200),
            _table_case(rng, 64, 6, 10, 7, off=40, extra_rows=4)]


@pytest.mark.parametrize("case,use_kernel", [
    ("mixed", False), ("mixed", True), ("split", False)],
    ids=["mixed-jax_reference", "mixed-jax_pallas_interpret",
         "split-jax_reference"])
def test_torch_sparse_grouped_match_jax(case, use_kernel):
    """The grouped wrappers over a list of tables (on the CPU: the plain
    versions table by table) against JAX's per-table kernels at step 7:
    catch-up rows on the real slots, the tables after the update and
    ``last_step`` (equal), and the depth against the JAX step's formula.
    "split" is a list longer than one launch takes."""
    rng = np.random.default_rng(12)
    t = 7
    if case == "mixed":
        cases = _mixed_cases(rng)
    else:
        cases = [_table_case(rng, 40, (8, 1)[i % 2], 8, 6)
                 for i in range(MAX_TABLES + 6)]
        assert launches_for(len(cases)) == 2
    keys = ("w", "m", "v", "ls", "uids", "counts")
    lists = [[_t(c[k]) for c in cases] for k in keys]
    offs = [c["off"] for c in cases]
    rows, depth = sparse_gather_catchup_tables(*lists, step_scalars(t),
                                               row_offsets=offs, **KW)
    assert depth.dtype == torch.int32 and depth.shape == ()
    want_depth = max(int(np.max(np.where(
        c["counts"] > 0,
        (t - 1) - c["ls"][np.clip(c["uids"] - c["off"], 0,
                                  c["ls"].shape[0] - 1)], 0)))
        for c in cases)
    assert int(depth) == want_depth > 0

    tables = [[_t(c[k]) for c in cases] for k in ("w", "m", "v", "ls")]
    assert sparse_update_scatter_tables(
        *tables, lists[4], lists[5], [r[0] for r in rows],
        [_t(c["g"]) for c in cases], [r[1] for r in rows],
        [r[2] for r in rows], step_scalars(t), row_offsets=offs,
        **KW) is None
    for i, c in enumerate(cases):
        real = c["counts"] > 0
        args = [_j(c[k]) for k in keys]
        rows_j = jax_catchup(*args, jnp.asarray(t, jnp.int32),
                             use_kernel=use_kernel, row_offset=c["off"], **KW)
        for a, b, name in zip(rows[i], rows_j, "wmv"):
            np.testing.assert_allclose(_np(a)[real], _np(b)[real],
                                       err_msg=f"table {i} {name}_rows", **TOL)
            assert np.isfinite(_np(a)).all()
        out_j = jax_update(
            *args, *(_j(_np(r)) for r in rows[i][:1]), _j(c["g"]),
            *(_j(_np(r)) for r in rows[i][1:]), jnp.asarray(t, jnp.int32),
            use_kernel=use_kernel, row_offset=c["off"], **KW)
        for a, b, name in zip((x[i] for x in tables[:3]), out_j[:3], "wmv"):
            np.testing.assert_allclose(_np(a), _np(b),
                                       err_msg=f"table {i} {name}", **TOL)
        np.testing.assert_array_equal(_np(tables[3][i]), _np(out_j[3]))


def test_torch_sparse_grouped_rejects_bad_lists():
    w = torch.zeros(6, 3)
    ls = torch.zeros(6, dtype=torch.int32)
    uids = torch.tensor([1, 6], dtype=torch.int32)
    cnt = torch.tensor([2.0, 0.0])
    one = ([w], [w], [w], [ls], [uids], [cnt])
    step = step_scalars(1)
    with pytest.raises(ValueError):        # lists of two lengths
        sparse_gather_catchup_tables(*one[:5], [cnt, cnt], step)
    with pytest.raises(ValueError):        # no table
        sparse_gather_catchup_tables([], [], [], [], [], [], step)
    with pytest.raises(ValueError):        # a row offset per table
        sparse_gather_catchup_tables(*one, step, row_offsets=[0, 0])
    with pytest.raises(TypeError):
        sparse_gather_catchup_tables(*one[:3], [ls.long()], *one[4:], step)
    with pytest.raises(TypeError):         # a bare int for the step's block
        sparse_gather_catchup_tables(*one, 1)
    rows = torch.zeros(2, 3)
    with pytest.raises(ValueError):
        sparse_update_scatter_tables(*one, [rows], [rows[:1]], [rows],
                                     [rows], step)


@pytest.mark.parametrize("clip", [True, False])
def test_torch_sparse_update_untouched_rows_bitwise(clip):
    """Rows of absent ids and pad slots are never written: the tables
    outside the real slots stay byte-identical, and ``last_step`` moves
    only on the real slots."""
    rng = np.random.default_rng(11)
    vocab, dim, cap, t = 40, 4, 16, 3
    tb = _tables(rng, vocab, dim)
    uids, counts = _slots(rng, vocab, cap, 9)
    real = uids[counts > 0]
    rows = [_t((0.01 * rng.standard_normal((cap, dim))).astype(np.float32))
            for _ in range(4)]
    tables = [_t(tb[k]) for k in ("w", "m", "v", "ls")]
    sparse_update_scatter(*tables, _t(uids), _t(counts), *rows[:2],
                          rows[2], rows[3].abs(), step_scalars(t), clip=clip,
                          **KW)
    absent = np.setdiff1d(np.arange(vocab), real)
    for a, k in zip(tables, ("w", "m", "v", "ls")):
        np.testing.assert_array_equal(_np(a)[absent], tb[k][absent])
    assert (_np(tables[3])[real] == t).all()


def test_torch_sparse_kernels_row_offset():
    """The last shard ``[offset, offset + rows)`` of a table, padded past
    ``vocab`` as a row-sharded layout pads it, with global uids: the plain
    versions match JAX's with the same ``row_offset``, and the shard ends up
    as the same rows of the unsharded update. Pad uids (the global
    ``vocab``) land in the shard's range after the offset and must still
    be dropped."""
    rng = np.random.default_rng(5)
    vocab, dim, cap, t, off = 64, 6, 10, 9, 40
    tb = _tables(rng, vocab, dim, max_depth=8)
    ids = rng.integers(off, vocab, size=7)
    uids, counts = np.unique(ids, return_counts=True)
    pad = cap - uids.shape[0]
    uids = np.concatenate([uids, np.full(pad, vocab)]).astype(np.int32)
    counts = np.concatenate([counts, np.zeros(pad)]).astype(np.float32)
    g_rows = (0.1 * rng.standard_normal((cap, dim))).astype(np.float32)
    n_real = int((counts > 0).sum())
    extra = _tables(rng, 4, dim, max_depth=8)       # pad rows of the shard
    shard = {k: np.concatenate([a[off:], extra[k]]) for k, a in tb.items()}
    assert vocab - off < shard["w"].shape[0]        # the pad uid is in range

    rows = sparse_gather_catchup(
        *(_t(shard[k]) for k in ("w", "m", "v", "ls")), _t(uids),
        _t(counts), step_scalars(t), row_offset=off, **KW)
    rows_j = jax_ref.sparse_gather_catchup_reference(
        *(_j(shard[k]) for k in ("w", "m", "v", "ls")), _j(uids),
        jnp.asarray(t, jnp.int32), row_offset=off, **KW)
    full = sparse_gather_catchup(
        *(_t(tb[k]) for k in ("w", "m", "v", "ls")), _t(uids), _t(counts),
        step_scalars(t), **KW)
    for a, b, c in zip(rows, rows_j, full):
        np.testing.assert_allclose(_np(a)[:n_real], _np(b)[:n_real], **TOL)
        np.testing.assert_array_equal(_np(a)[:n_real], _np(c)[:n_real])

    shard_t = [_t(shard[k]) for k in ("w", "m", "v", "ls")]
    sparse_update_scatter(*shard_t, _t(uids), _t(counts), rows[0],
                          _t(g_rows), rows[1], rows[2], step_scalars(t),
                          row_offset=off, **KW)
    out_j = jax_ref.sparse_update_scatter_reference(
        *(_j(shard[k]) for k in ("w", "m", "v", "ls")), _j(uids),
        _j(counts), _j(_np(rows[0])), _j(g_rows), _j(_np(rows[1])),
        _j(_np(rows[2])), jnp.asarray(t, jnp.int32), row_offset=off, **KW)
    full_t = [_t(tb[k]) for k in ("w", "m", "v", "ls")]
    sparse_update_scatter(*full_t, _t(uids), _t(counts), *full[:1],
                          _t(g_rows), full[1], full[2], step_scalars(t),
                          **KW)
    for a, b, c, k in zip(shard_t, out_j, full_t, ("w", "m", "v", "ls")):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
        np.testing.assert_array_equal(_np(a)[:vocab - off], _np(c)[off:])
        np.testing.assert_array_equal(_np(a)[vocab - off:], extra[k])


def test_torch_sparse_cowclip_adam_reference_matches_jax():
    rng = np.random.default_rng(8)
    vocab, dim, cap, t = 30, 5, 8, 4
    tb = _tables(rng, vocab, dim)
    uids, counts = _slots(rng, vocab, cap, 6)
    g_rows = (0.1 * rng.standard_normal((cap, dim))).astype(np.float32)
    out_t = sparse_cowclip_adam_reference(
        *(_t(tb[k]) for k in ("w", "m", "v", "ls")), _t(uids), _t(counts),
        _t(g_rows), step_scalars(t), **KW)
    out_j = jax_ref.sparse_cowclip_adam_reference(
        *(_j(tb[k]) for k in ("w", "m", "v", "ls")), _j(uids), _j(counts),
        _j(g_rows), jnp.asarray(t, jnp.int32), **KW)
    for a, b in zip(out_t[:3], out_j[:3]):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    np.testing.assert_array_equal(_np(out_t[3]), _np(out_j[3]))


@pytest.mark.parametrize("ids,cap", [
    ([4, 9, 4, 2], 6),        # pads after the real slots
    ([4, 9, 4, 2], 3),        # no pads
    ([7], 5),                 # one real slot
])
def test_torch_safe_uids_matches_jax(ids, cap):
    vocab = 12
    uids, counts = np.unique(ids, return_counts=True)
    pad = cap - uids.shape[0]
    uids = np.concatenate([uids, np.full(pad, vocab)]).astype(np.int32)
    counts = np.concatenate([counts, np.zeros(pad)]).astype(np.float32)
    got = safe_uids(_t(uids), _t(counts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        _np(got), _np(jax_sparse.safe_uids(_j(uids), _j(counts))))
    assert (_np(got) < vocab).all()


def test_torch_sparse_wrappers_reject_bad_inputs():
    w = torch.zeros(6, 3)
    ls = torch.zeros(6, dtype=torch.int32)
    uids = torch.tensor([1, 6], dtype=torch.int32)
    cnt = torch.tensor([2.0, 0.0])
    step = step_scalars(1)
    with pytest.raises(TypeError):
        sparse_gather_catchup(w, w, w, ls.long(), uids, cnt, step)
    with pytest.raises(ValueError):
        sparse_gather_catchup(w, w, w, ls, uids, cnt[:1], step)
    with pytest.raises(ValueError):
        sparse_gather_catchup(w, w, w, ls, uids, cnt, step_scalars(0))
    with pytest.raises(TypeError):          # a bare int for the step's block
        sparse_gather_catchup(w, w, w, ls, uids, cnt, 1)
    rows = torch.zeros(2, 3)
    with pytest.raises(ValueError):
        sparse_update_scatter(w, w, w, ls, uids, cnt, rows, rows[:1], rows,
                              rows, step)


# ---------------------------------------------------------------------------
# catch-up math
# ---------------------------------------------------------------------------


def _rows(rng, n, dim, scale=1e-2):
    """Embedding-scale rows (the replay oracle drifts ~1 ulp per multiply,
    so its absolute gap at depth 10_000 is only small at these sizes)."""
    return rng.uniform(-1.5 * scale, 1.5 * scale,
                       size=(n, dim)).astype(np.float32)


@hypothesis.settings(max_examples=20, deadline=None)
@hypothesis.given(
    depth=st.integers(0, 3000),
    lr=st.floats(1e-5, 1e-1),
    l2=st.floats(0.0, 1e-1),
    dim=st.sampled_from([1, 4, 10]),
    seed=st.integers(0, 2**16),
)
def test_torch_closed_form_matches_replay_and_jax(depth, lr, l2, dim, seed):
    rng = np.random.default_rng(seed)
    n = 12
    w = _rows(rng, n, dim)
    m = rng.normal(size=(n, dim)).astype(np.float32)
    v = np.abs(rng.normal(size=(n, dim))).astype(np.float32)
    ls = rng.integers(0, depth + 1, size=n).astype(np.int32)
    ls[0] = 0

    w_cf, m_cf, v_cf = optim.decay_catchup_rows(
        _t(w), _t(m), _t(v), _t(ls), depth, lr=lr, l2=l2)
    w_rp = optim.decay_replay_reference(_t(w), _t(ls), depth, lr=lr, l2=l2)
    np.testing.assert_allclose(_np(w_cf), _np(w_rp), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(_np(m_cf), m)
    np.testing.assert_array_equal(_np(v_cf), v)
    w_j, _, _ = jax_optim.decay_catchup_rows(
        _j(w), _j(m), _j(v), _j(ls), jnp.asarray(depth, jnp.int32),
        lr=lr, l2=l2)
    np.testing.assert_allclose(_np(w_cf), _np(w_j), **TOL)


def test_torch_closed_form_matches_float64_geometric_at_depth_10000():
    rng = np.random.default_rng(3)
    lr, l2 = 1e-3, 1e-4
    w = _rows(rng, 16, 8)
    zeros = torch.zeros(16, 8)
    w_cf, _, _ = optim.decay_catchup_rows(
        _t(w), zeros, zeros, torch.zeros(16, dtype=torch.int32), 10_000,
        lr=lr, l2=l2)
    truth = w.astype(np.float64) * float(optim.decay_factor(lr, l2)) ** 10_000
    np.testing.assert_allclose(_np(w_cf), truth, atol=1e-7, rtol=1e-5)


def test_torch_zero_depth_and_zero_l2_are_exact_noops():
    rng = np.random.default_rng(7)
    w = _t(_rows(rng, 8, 4))
    zeros = torch.zeros_like(w)
    caught, _, _ = optim.decay_catchup_rows(
        w, zeros, zeros, torch.full((8,), 5000, dtype=torch.int32), 5000,
        lr=1e-3, l2=1e-4)
    assert torch.equal(caught, w)
    caught, _, _ = optim.decay_catchup_rows(
        w, zeros, zeros, torch.zeros(8, dtype=torch.int32), 5000,
        lr=1e-3, l2=0.0)
    assert torch.equal(caught, w)


def test_torch_catchup_mode_matches_jax():
    for lr, l2 in ((1e-3, 1e-4), (lambda s: 1e-3, 1e-4), (1e-3, lambda s: 0)):
        assert optim.catchup_mode(lr, l2) == jax_optim.catchup_mode(lr, l2)


@pytest.mark.parametrize("depth", [0, 1, 17, 60, 64, 90])
def test_torch_replay_window_varying_schedule(depth):
    """A genuinely varying lr schedule: the window replays pending steps
    exactly up to ``replay_window`` (64) and matches JAX's window at any
    depth, its geometric tail included."""
    rng = np.random.default_rng(depth)
    l2 = 1e-2
    w = _rows(rng, 10, 6)
    zeros = np.zeros_like(w)
    ls = rng.integers(0, depth + 1, size=10).astype(np.int32)
    lr_t = lambda s: 1e-3 * (1.0 + 0.5 * torch.sin(0.1 * s))   # noqa: E731
    lr_j = lambda s: 1e-3 * (1.0 + 0.5 * jnp.sin(0.1 * s))     # noqa: E731
    w_win, _, _ = optim.decay_catchup_rows(
        _t(w), _t(zeros), _t(zeros), _t(ls), depth, lr=lr_t, l2=l2,
        replay_window=64)
    w_j, _, _ = jax_optim.decay_catchup_rows(
        _j(w), _j(zeros), _j(zeros), _j(ls), jnp.asarray(depth, jnp.int32),
        lr=lr_j, l2=l2, replay_window=64)
    np.testing.assert_allclose(_np(w_win), _np(w_j), rtol=1e-5, atol=1e-8)
    if depth <= 64:
        w_rp = optim.decay_replay_reference(_t(w), _t(ls), depth, lr=lr_t,
                                            l2=l2)
        np.testing.assert_allclose(_np(w_win), _np(w_rp), rtol=1e-5,
                                   atol=1e-6)


def test_torch_sparse_adam_rows_and_cowclip_rows_match_jax():
    rng = np.random.default_rng(4)
    cap, dim = 9, 6
    g, w, m = (rng.standard_normal((cap, dim)).astype(np.float32) * s
               for s in (0.1, 0.01, 0.001))
    v = np.abs(rng.standard_normal((cap, dim))).astype(np.float32) * 1e-4
    counts = rng.integers(0, 3, size=cap).astype(np.float32)
    gc = cowclip_rows(_t(g), _t(w), _t(counts), r=1.0, zeta=1e-5)
    gc_j = jax_cowclip_rows(_j(g), _j(w), _j(counts), r=1.0, zeta=1e-5)
    np.testing.assert_allclose(_np(gc), _np(gc_j), **TOL)
    out = optim.sparse_adam_rows(gc, _t(w), _t(m), _t(v), 5, **KW)
    out_j = jax_optim.sparse_adam_rows(gc_j, _j(w), _j(m), _j(v),
                                       jnp.asarray(5, jnp.int32), **KW)
    for a, b in zip(out, out_j):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_torch_collapse_pending_decay_matches_jax():
    rng = np.random.default_rng(6)
    embed = {"fm": {"field_0": _rows(rng, 20, 4)},
             "lin": {"field_0": _rows(rng, 20, 1)}}
    last = {g: {"field_0": rng.integers(0, 30, size=20).astype(np.int32)}
            for g in embed}
    last["fm"]["field_0"][:3] = 30                  # already caught up
    got = collapse_pending_decay(
        {g: {f: _t(a) for f, a in t.items()} for g, t in embed.items()},
        {g: {f: _t(a) for f, a in t.items()} for g, t in last.items()},
        30, **KW)
    want = jax_collapse(jax.tree.map(_j, embed), jax.tree.map(_j, last), 30,
                        **KW)
    for g in embed:
        np.testing.assert_allclose(_np(got[g]["field_0"]),
                                   _np(want[g]["field_0"]), **TOL)
    np.testing.assert_array_equal(_np(got["fm"]["field_0"])[:3],
                                  embed["fm"]["field_0"][:3])


# ---------------------------------------------------------------------------
# unique-id layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ids,vocab,cap", [
    ([7, 3, 7, 7, 1, 3], 10, 6),           # pads
    ([1, 2, 3, 50, 51, 3, 50], 60, 3),     # overflow: 50 and 51 dropped
    ([0, 4, 4, 0, 4, 0, 0, 4], 5, 5),      # vocab < batch
    ([9], 10, 1),
])
def test_torch_unique_ids_match_jax(ids, vocab, cap):
    col = np.asarray(ids, np.int32)
    u = embedding.unique_ids(_t(col), vocab, cap)
    u_j = jax_embedding.unique_ids(_j(col), vocab, cap)
    assert u.uids.dtype == u.inv.dtype == torch.int32
    assert u.counts.dtype == torch.float32
    for a, b in zip(u, u_j):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert u.capacity == cap
    assert int(u.n_unique()) == int(u_j.n_unique())


def test_torch_batch_unique_capacity_rule():
    rng = np.random.default_rng(1)
    ids = np.stack([rng.integers(0, v, size=16) for v in (100, 5, 16)],
                   axis=1).astype(np.int32)
    for capacity in (0, 4, 40):
        got = embedding.batch_unique(_t(ids), (100, 5, 16), capacity)
        want = jax_embedding.batch_unique(_j(ids), (100, 5, 16), capacity)
        for f in want:
            assert got[f].capacity == want[f].capacity
            for a, b in zip(got[f], want[f]):
                np.testing.assert_array_equal(_np(a), _np(b))


def test_torch_lookup_rows_overflow_forward_clamps_backward_drops():
    """Past the capacity, the forward reads the last kept slot and the
    backward drops the gradient, as JAX's clamping gather does: slot 2's
    gradient carries only id 3's two occurrences."""
    col = np.array([1, 2, 3, 50, 51, 3, 50], np.int32)
    weights = np.arange(7, dtype=np.float32)[:, None]
    rows = np.arange(6, dtype=np.float32).reshape(3, 2)

    u = embedding.unique_ids(_t(col), 60, 3)
    rows_t = _t(rows).requires_grad_()
    emb, = embedding.lookup_rows([{"field_0": rows_t}], {"field_0": u})
    (emb[:, 0] * _t(weights)).sum().backward()

    u_j = jax_embedding.unique_ids(_j(col), 60, 3)
    fwd = lambda r: jax_embedding.lookup_rows(  # noqa: E731
        {"field_0": r}, {"field_0": u_j})
    grad_j = jax.grad(lambda r: (fwd(r)[:, 0] * _j(weights)).sum())(_j(rows))
    np.testing.assert_array_equal(_np(emb), _np(fwd(_j(rows))))
    np.testing.assert_array_equal(_np(rows_t.grad), _np(grad_j))
    np.testing.assert_array_equal(_np(rows_t.grad)[2], [7.0, 7.0])


def test_torch_gather_and_scatter_rows_match_jax():
    rng = np.random.default_rng(2)
    tables = {"field_0": _rows(rng, 12, 3), "field_1": _rows(rng, 4, 3)}
    ids = np.stack([rng.integers(0, 12, size=6), rng.integers(0, 4, size=6)],
                   axis=1).astype(np.int32)
    uniq = embedding.batch_unique(_t(ids), (12, 4))
    uniq_j = jax_embedding.batch_unique(_j(ids), (12, 4))
    tt = {f: _t(a) for f, a in tables.items()}
    rows = embedding.gather_rows(tt, uniq)
    rows_j = jax_embedding.gather_rows(jax.tree.map(_j, tables), uniq_j)
    for f in tables:   # pad slots read the last row on both sides
        np.testing.assert_array_equal(_np(rows[f]), _np(rows_j[f]))
    new = {f: r + 1.0 for f, r in rows.items()}
    out = embedding.scatter_rows(tt, uniq, new)
    out_j = jax_embedding.scatter_rows(
        jax.tree.map(_j, tables), uniq_j,
        {f: _j(_np(r)) for f, r in new.items()})
    for f in tables:
        np.testing.assert_array_equal(_np(out[f]), _np(out_j[f]))
        np.testing.assert_array_equal(_np(tt[f]), tables[f])   # not in place
