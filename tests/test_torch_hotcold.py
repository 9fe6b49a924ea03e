"""The port's hot/cold placement (``repro_torch.embed.hotcold``) against the
JAX package's, and its own guarantees.

Both sides start from the same JAX-initialised params (carried across as
NumPy, ``train.checkpoint.params_from_numpy``) and take the same NumPy
batches. The JAX side runs ``hotcold`` through its jnp reference, the port
its plain CPU versions of the two grouped sparse kernels. After a flush
the exported params agree within 1e-5 (f32, summation order only), and
everything residency decides is *exactly* equal: the resident id sets, the
frequencies, the hit and lookup rows, the evictions a step, and the
device-resident byte counts. Both admission policies, at a capacity that
evicts (4) and one that does not (100).

Within the port: runs at capacities 2, 4, 8, 16 and 100 export bitwise
identical params (capacity 1 too, held within 1e-7, the JAX package's
bar); the placement equals the sparse one within 1e-7 and the substrate
within 1e-5; no row is lost or double-resident; the hit rate is monotone
in capacity; pending decay is > 0 before a flush and 0 after; the flush is
bitwise idempotent. The selection, compaction and drop-scatter helpers
are held to their NumPy definitions. Runs are memoised: each capacity is
one run a side.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_train_step as jax_build_train_step
from repro.core import scale_hyperparams as jax_scale_hyperparams
from repro.embed import hotcold as jax_hotcold
from repro.models import ctr as jax_ctr
from repro_torch.core import build_train_step
from repro_torch.core.scaling import scale_hyperparams
from repro_torch.core.tree import flatten_with_paths, tree_leaves
from repro_torch.data import iterate_batches, make_ctr_dataset
from repro_torch.embed import hotcold
from repro_torch.embed.store import max_pending_depth
from repro_torch.models import ctr
from repro_torch.train.checkpoint import params_from_numpy

VOCABS = (60, 13, 5)
BATCH = 32
STEPS = 8
FIELDS = ("field_0", "field_1", "field_2")
AUX = ("loss", "catchup_depth_max", "hot_hit_rows", "hot_lookup_rows",
       "evictions")
HKW = dict(base_lr=1e-3, base_l2=1e-3, base_batch=BATCH, batch_size=BATCH,
           base_dense_lr=2e-3)
CFG = dict(name="deepfm", vocab_sizes=VOCABS, n_dense=3, emb_dim=8,
           mlp_dims=(16, 16, 16), emb_sigma=1e-2)


@functools.lru_cache(maxsize=None)
def _batches():
    ds = make_ctr_dataset(512, VOCABS, n_dense=3, zipf_a=1.2, seed=3)
    return [b for _, b in zip(range(STEPS), iterate_batches(ds, BATCH,
                                                            seed=1))]


@functools.lru_cache(maxsize=None)
def _params_np():
    return jax.tree.map(np.asarray, jax_ctr.init(
        jax.random.key(0), jax_ctr.CTRConfig(**CFG)))


def _store_kw(path, capacity, admission, half_life):
    if path != "hotcold":
        return {}
    return dict(hot_capacity=capacity, admission=admission,
                half_life=half_life)


@functools.lru_cache(maxsize=None)
def _jax_run(capacity, admission="cumulative", half_life=0):
    """STEPS JAX hotcold steps and a flush: (exported leaves, state with
    NumPy leaves, per-step aux, hot_tier_bytes, residency_map_bytes)."""
    cfg = jax_ctr.CTRConfig(**CFG)
    bundle = jax_build_train_step(
        cfg, jax_scale_hyperparams("cowclip", **HKW), path="hotcold",
        use_kernel=False, **_store_kw("hotcold", capacity, admission,
                                      half_life))
    params = bundle.prepare(jax.tree.map(jnp.asarray, _params_np()))
    state = bundle.init(params)
    auxes = []
    for b in _batches():
        params, state, aux = bundle.step(
            params, state, {k: jnp.asarray(v) for k, v in b.items()})
        auxes.append({k: float(v) for k, v in aux.items()})
    params, state = bundle.flush(params, state)
    leaves = flatten_with_paths(jax.tree.map(np.asarray,
                                             bundle.export(params)))
    return (leaves, jax.tree.map(np.asarray, state), auxes,
            jax_hotcold.hot_tier_bytes(state),
            jax_hotcold.residency_map_bytes(state))


@functools.lru_cache(maxsize=None)
def _run(path="hotcold", capacity=0, admission="cumulative", half_life=0):
    """STEPS port steps and a flush: (exported leaves as NumPy, final
    state, per-step aux, pending depth before the flush, the bundle, the
    flushed params)."""
    cfg = ctr.CTRConfig(**CFG)
    bundle = build_train_step(
        cfg, scale_hyperparams("cowclip", **HKW), path=path,
        **_store_kw(path, capacity, admission, half_life))
    params = bundle.prepare(params_from_numpy(_params_np(), "cpu"))
    state = bundle.init(params)
    auxes = []
    for b in _batches():
        params, state, aux = bundle.step(
            params, state, {k: torch.from_numpy(v) for k, v in b.items()})
        auxes.append({k: float(v) for k, v in aux.items()})
    depth = max_pending_depth(state)
    params, state = bundle.flush(params, state)
    leaves = {k: v.clone().numpy() for k, v in
              flatten_with_paths(bundle.export(params)).items()}
    return leaves, state, auxes, depth, bundle, params


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("capacity", [4, 100])
@pytest.mark.parametrize("admission,half_life",
                         [("cumulative", 0), ("decayed", 3)])
def test_torch_hotcold_matches_jax(capacity, admission, half_life):
    j_leaves, j_state, j_aux, j_hot, j_maps = _jax_run(
        capacity, admission, half_life)
    leaves, state, auxes, _, _, _ = _run("hotcold", capacity, admission,
                                         half_life)
    assert leaves.keys() == j_leaves.keys()
    for k in leaves:
        np.testing.assert_allclose(leaves[k], j_leaves[k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    for i, (a, b) in enumerate(zip(auxes, j_aux)):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5,
                                   err_msg=f"step {i + 1}")
        for k in AUX[1:]:
            assert a[k] == b[k], (i + 1, k, a[k], b[k])
    res = hotcold.resident_ids(state)
    for f in FIELDS:
        sid = j_state["hot"]["slot_ids"][f]
        np.testing.assert_array_equal(np.sort(res[f]),
                                      np.sort(sid[sid < VOCABS[int(f[-1])]]))
        np.testing.assert_array_equal(state["hot"]["freq"][f].numpy(),
                                      j_state["hot"]["freq"][f])
    assert hotcold.hot_tier_bytes(state) == j_hot
    assert hotcold.residency_map_bytes(state) == j_maps
    assert int(state["step"]) == int(j_state["step"]) == STEPS


@pytest.mark.parametrize("capacity", [2, 4, 8, 16])
def test_torch_hotcold_capacity_runs_bitwise_identical(capacity):
    """An evicted-then-readmitted row bit-matches one that stayed hot: a
    capacity-starved run exports the no-eviction run's params bit for
    bit."""
    _assert_bitwise(_run("hotcold", capacity)[0], _run("hotcold", 100)[0])


def test_torch_hotcold_decayed_capacity_runs_bitwise_identical():
    _assert_bitwise(_run("hotcold", 2, "decayed", 3)[0],
                    _run("hotcold", 100, "decayed", 3)[0])
    # the policy is real: its frequencies differ from cumulative's
    st_cum, st_dec = _run("hotcold", 2)[1], _run("hotcold", 2, "decayed",
                                                 3)[1]
    assert any(not torch.equal(st_cum["hot"]["freq"][f],
                               st_dec["hot"]["freq"][f]) for f in FIELDS)


def test_torch_hotcold_capacity_one_within_rounding():
    one, big = _run("hotcold", 1)[0], _run("hotcold", 100)[0]
    for k in one:
        np.testing.assert_allclose(one[k], big[k], atol=1e-7, rtol=0,
                                   err_msg=k)


def test_torch_hotcold_matches_sparse_and_substrate():
    hc = _run("hotcold", 4)[0]
    sp, sub = _run("sparse")[0], _run("substrate")[0]
    for k, v in hc.items():
        np.testing.assert_allclose(v, sp[k], atol=1e-7, rtol=0, err_msg=k)
        np.testing.assert_allclose(v, sub[k], atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("capacity", [1, 2, 4, 16, 100])
def test_torch_hotcold_no_row_lost_or_double_resident(capacity):
    """slot_ids and slot_of stay a bijection between occupied slots and
    resident ids, bounded by the capacity."""
    state = _run("hotcold", capacity)[1]
    for f, vocab in zip(FIELDS, VOCABS):
        sid = state["hot"]["slot_ids"][f].numpy()
        so = state["hot"]["slot_of"][f].numpy()
        res = sid[sid < vocab]
        assert len(res) == len(np.unique(res)), f
        assert len(res) <= min(capacity, vocab)
        for s, i in enumerate(sid):
            if i < vocab:
                assert so[i] == s
        assert (so[np.setdiff1d(np.arange(vocab), res)] == -1).all()


@pytest.mark.parametrize("admission,half_life",
                         [("cumulative", 0), ("decayed", 3)])
def test_torch_hotcold_frequencies_capacity_independent(admission,
                                                        half_life):
    small = _run("hotcold", 2, admission, half_life)[1]
    big = _run("hotcold", 100, admission, half_life)[1]
    for f in FIELDS:
        assert torch.equal(small["hot"]["freq"][f], big["hot"]["freq"][f])


def test_torch_hotcold_hit_rate_monotone_in_capacity():
    rates = []
    for cap in (1, 2, 4, 8, 16, 100):
        auxes = _run("hotcold", cap)[2]
        hits = sum(a["hot_hit_rows"] for a in auxes)
        total = sum(a["hot_lookup_rows"] for a in auxes)
        assert hits <= total
        rates.append(hits / total)
    assert all(b >= a - 1e-12 for a, b in zip(rates, rates[1:])), rates
    assert rates[0] < rates[-1]
    assert sum(a["evictions"] for a in _run("hotcold", 2)[2]) > 0
    assert sum(a["evictions"] for a in _run("hotcold", 100)[2]) == 0


def test_torch_hotcold_pending_depth_and_flush():
    _, state, auxes, depth, _, _ = _run("hotcold", 4)
    assert depth > 0
    assert max(a["catchup_depth_max"] for a in auxes) > 0
    assert max_pending_depth(state) == 0
    for ls in tree_leaves(state["last_step"]):
        assert (ls == int(state["step"])).all()


def test_torch_hotcold_flush_is_bitwise_idempotent():
    leaves, state, _, _, bundle, params = _run("hotcold", 4)
    hot = {k: v.clone() for k, v in flatten_with_paths(state["hot"]).items()}
    params, state = bundle.flush(params, state)
    _assert_bitwise(leaves, {k: v.numpy() for k, v in flatten_with_paths(
        bundle.export(params)).items()})
    _assert_bitwise({k: v.numpy() for k, v in hot.items()},
                    {k: v.numpy() for k, v in
                     flatten_with_paths(state["hot"]).items()})


def test_torch_hotcold_bytes_scale_with_capacity_not_vocab():
    small, big = _run("hotcold", 2)[1], _run("hotcold", 100)[1]
    assert hotcold.hot_tier_bytes(small) < hotcold.hot_tier_bytes(big)
    maps = hotcold.residency_map_bytes(small)
    assert maps == hotcold.residency_map_bytes(big) == 2 * 4 * sum(VOCABS)


@pytest.mark.parametrize("seed", range(4))
def test_torch_hotcold_selection_helpers(seed):
    """``_top_c_mask`` picks lexsort's top c under (prio desc, id asc),
    ties in prio included; ``_compact`` is ``nonzero`` padded with the
    length; ``_put_rows`` is the drop-mode scatter of a compacted list."""
    rng = np.random.default_rng(seed)
    n, vocab = 40, 50
    ids = rng.permutation(vocab)[:n].astype(np.int32)
    ids[rng.random(n) < 0.3] = vocab
    prio = rng.integers(0, 4, n).astype(np.float32)   # many ties
    valid = ids < vocab
    for c in (1, 5, 17, n - 1):
        kept = hotcold._top_c_mask(torch.from_numpy(prio),
                                   torch.from_numpy(ids),
                                   torch.from_numpy(valid), c).numpy()
        order = np.lexsort((ids, -np.where(valid, prio, 0)))
        order = order[valid[order]][:c]
        want = np.zeros(n, bool)
        want[order] = True
        np.testing.assert_array_equal(kept, want)
        got = hotcold._compact(torch.from_numpy(kept), c).numpy()
        pos = np.flatnonzero(kept)
        np.testing.assert_array_equal(got[:len(pos)], pos)
        assert (got[len(pos):] == n).all()
    table = torch.from_numpy(rng.normal(size=(vocab, 3)).astype(np.float32))
    for n_real in (0, 1, 6):
        idx = np.full(8, vocab)
        idx[:n_real] = rng.permutation(vocab)[:n_real]
        rows = rng.normal(size=(8, 3)).astype(np.float32)
        want = table.numpy().copy()
        want[idx[:n_real]] = rows[:n_real]
        got = table.clone()
        hotcold._put_rows(got, torch.from_numpy(idx), torch.from_numpy(rows),
                          vocab)
        np.testing.assert_array_equal(got.numpy(), want)
