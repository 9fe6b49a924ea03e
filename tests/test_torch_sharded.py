"""The port's sharded placements against the JAX package, in one process.

* The row-shard plan (``RowShardPlan`` mappings, the layout permutations,
  pad/unpad), the placement rule (``ctr_param_spec``) and the per-shard
  dedup (``unique_owned_ids``, ``shard_unique_sets`` with its per-shard
  overflow, ``slice_unique_counts``, ``shard_capacity``) equal JAX's
  bitwise; the staged dedup equals the single-stage one.
* ``shard_update`` (kernel 1's plain version) and the port's
  ``update_phases`` (both branches: the sparse one through the sparse pair's
  plain versions, the dense fallback through kernel 1's) against JAX's
  ``shard_update`` and ``update_phase(use_kernel=False)`` at rtol 1e-5 /
  atol 1e-7.
* Whole steps on a gloo world of one rank: ``sharded`` against JAX's
  ``make_sharded_train_step`` on a 1x1 mesh (params and state after each
  of 3 steps within rtol 1e-5 and an atol of 1e-6 of each leaf's largest
  magnitude, div and mod, with and without the clip), and
  ``sharded_sparse`` against JAX's substrate step, at an L2 large enough
  that a step's decay moves a row far past that bar; the staged dedup's
  refusal of a batch the data axis does not divide.

The multi-rank grids are ``test_torch_sharded_grids.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.core import build_optimizer as jax_build_optimizer
from repro.core import build_train_step as jax_build_train_step
from repro.core import scale_hyperparams as jax_scale_hyperparams
from repro.embed import sharded as jax_shard
from repro.embed import sharded_sparse as jax_hybrid
from repro.models import ctr as jax_ctr
from repro.models import embedding as jax_embedding
from repro.sharding.specs import ctr_param_spec as jax_ctr_param_spec
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch.core.scaling import scale_hyperparams
from repro_torch.core.tree import flatten_with_paths, tree_map
from repro_torch.embed import sharded as shard_lib
from repro_torch.embed import sharded_sparse as hybrid_lib
from repro_torch.embed import store_for
from repro_torch.kernels.cowclip import step_scalars
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import ctr
from repro_torch.models import embedding
from repro_torch.train.checkpoint import params_from_numpy, params_to_numpy

VOCABS = (57, 13, 5)
TOL = dict(rtol=1e-5, atol=1e-7)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the plan, the layout, the placement rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["div", "mod"])
@pytest.mark.parametrize("vocab,n_shards", [(57, 4), (13, 4), (5, 2),
                                            (8, 8), (100, 1)])
def test_torch_shard_plan_matches_jax(vocab, n_shards, scheme):
    """The parameters of the JAX package's
    ``test_plan_id_mapping_bijective``: shard and local row of every id,
    the padded sizes and both permutations, bitwise."""
    plan = shard_lib.RowShardPlan(vocab, n_shards, scheme)
    ref = jax_shard.RowShardPlan(vocab, n_shards, scheme)
    assert (plan.rows_per_shard, plan.padded_vocab,
            plan.is_identity_layout) == (ref.rows_per_shard,
                                         ref.padded_vocab,
                                         ref.is_identity_layout)
    ids = np.arange(vocab, dtype=np.int32)
    for name in ("shard_of", "local_row"):
        np.testing.assert_array_equal(
            _np(getattr(plan, name)(torch.from_numpy(ids))),
            np.asarray(getattr(ref, name)(jnp.asarray(ids))))
    for name in ("logical_of_physical", "physical_of_logical"):
        np.testing.assert_array_equal(getattr(plan, name)(),
                                      getattr(ref, name)())
    # each shard's block is the physical layout's slice
    blocks = np.concatenate([plan.shard_rows(s) for s in range(n_shards)])
    np.testing.assert_array_equal(blocks, ref.logical_of_physical())


@pytest.mark.parametrize("scheme", ["div", "mod"])
def test_torch_shard_layout_and_pads_match_jax(scheme):
    """Padding, the physical layout (each shard's rows ``shard_rows``, as
    ``prepare`` keeps them) and its inverse against JAX's tree functions,
    bitwise."""
    plans = shard_lib.make_plans(VOCABS, 4, scheme)
    jplans = jax_shard.make_plans(VOCABS, 4, scheme)
    rng = np.random.default_rng(0)
    embed = {"fm": {f"field_{i}": rng.normal(size=(v, 3)).astype(np.float32)
                    for i, v in enumerate(VOCABS)}}
    jpadded = jax_shard.pad_embed_tree(jax.tree.map(jnp.asarray, embed),
                                       jplans)
    jphys = jax_shard.to_physical(jpadded, jplans)
    for f, w in embed["fm"].items():
        plan = plans[f]
        padded = shard_lib.pad_rows(torch.from_numpy(w), plan.padded_vocab)
        np.testing.assert_array_equal(_np(padded),
                                      np.asarray(jpadded["fm"][f]))
        phys = torch.cat([padded[torch.from_numpy(plan.shard_rows(s))]
                          for s in range(4)])
        np.testing.assert_array_equal(_np(phys), np.asarray(jphys["fm"][f]))
        back = phys[torch.from_numpy(plan.physical_of_logical())]
        np.testing.assert_array_equal(
            _np(shard_lib.unpad_rows(back, plan.vocab)), w)


@pytest.mark.parametrize("path,shape", [
    ("embed/fm/field_0", (60, 10)), ("embed/fm/field_0", (57, 10)),
    ("m/fm/field_3", (1000, 10)), ("last_step/lin/field_1", (16,)),
    ("last_step/lin/field_1", (15,)), ("dense/mlp/w0", (80, 400)),
    ("dense/cross/w1", (80, 80)), ("dense/lin_bias", ())])
def test_torch_ctr_param_spec_matches_jax(path, shape):
    try:
        mesh = AbstractMesh((2, 4), ("data", "model"))
    except TypeError:
        mesh = AbstractMesh((("data", 2), ("model", 4)))
    assert shard_lib.ctr_param_spec(path, shape, 4) == tuple(
        jax_ctr_param_spec(path, shape, mesh))


# ---------------------------------------------------------------------------
# the per-shard dedup
# ---------------------------------------------------------------------------


def test_torch_shard_capacity_matches_jax():
    for vocab, shards, batch, cap in [(57, 4, 32, 0), (57, 4, 8, 0),
                                      (57, 4, 32, 3), (57, 4, 8, 100),
                                      (57, 4, 0, 0), (13, 2, 64, 5)]:
        assert hybrid_lib.shard_capacity(
            shard_lib.RowShardPlan(vocab, shards), batch, cap) == \
            jax_hybrid.shard_capacity(jax_shard.RowShardPlan(vocab, shards),
                                      batch, cap)


@pytest.mark.parametrize("capacity", [2, 4, 9])
def test_torch_unique_owned_ids_matches_jax(capacity):
    rng = np.random.default_rng(capacity)
    ids = rng.integers(0, 13, size=40).astype(np.int32)
    owned = rng.random(40) < 0.5
    got = embedding.unique_owned_ids(torch.from_numpy(ids),
                                     torch.from_numpy(owned), 13, capacity)
    want = jax_embedding.unique_owned_ids(jnp.asarray(ids),
                                          jnp.asarray(owned), 13, capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


@pytest.mark.parametrize("scheme", ["div", "mod"])
@pytest.mark.parametrize("capacity", [2, 4])
def test_torch_shard_unique_sets_match_jax(scheme, capacity):
    """Every shard's slots, counts and overflow flag, div and mod, with a
    capacity that overflows some shards (2) and a roomier one (4)."""
    seen = False
    for ids in ([0, 1, 5, 5, 9, 12, 12, 12, 1, 0],
                [1, 2, 3, 50, 51, 7, 7, 44],
                [0, 4, 8, 12, 16, 20, 24, 28]):
        ids = np.asarray(ids, np.int32)
        plan = shard_lib.RowShardPlan(57, 4, scheme)
        got = hybrid_lib.shard_unique_sets(torch.from_numpy(ids), plan,
                                           capacity)
        want = jax_hybrid.shard_unique_sets(
            jnp.asarray(ids), jax_shard.RowShardPlan(57, 4, scheme),
            capacity)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        seen |= bool(got.overflow.any())
    assert seen


@pytest.mark.parametrize("scheme", ["div", "mod"])
def test_torch_staged_dedup_equals_single_stage(scheme):
    """``slice_unique_counts`` equals JAX's; its slices gathered end to end
    and deduplicated per shard (``owned_unique_weighted``) give the slots,
    counts and flag of ``owned_unique_local`` on the whole batch, and the
    fallback's full counts equal ``counts_partial`` of the whole batch."""
    rng = np.random.default_rng(3)
    plan = shard_lib.RowShardPlan(57, 4, scheme)
    ids = rng.choice([1, 2, 3, 4, 5, 20, 33, 50, 51], size=48).astype(
        np.int32)
    slices = np.split(ids, 4)
    sets = [hybrid_lib.slice_unique_counts(torch.from_numpy(s), 57,
                                           min(12, 57)) for s in slices]
    for s, (u, c) in zip(slices, sets):
        ju, jc = jax_hybrid.slice_unique_counts(jnp.asarray(s), 57, 12)
        np.testing.assert_array_equal(_np(u), np.asarray(ju))
        np.testing.assert_array_equal(_np(c), np.asarray(jc))
    gids = torch.cat([u for u, _ in sets])
    gcnts = torch.cat([c for _, c in sets])
    for shard in range(4):
        for cap in (2, 5, 15):
            got = hybrid_lib.owned_unique_weighted(gids, gcnts, plan, cap,
                                                   shard)
            want = hybrid_lib.owned_unique_local(torch.from_numpy(ids), plan,
                                                 cap, shard)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_np(g), _np(w))
        np.testing.assert_array_equal(
            _np(hybrid_lib.full_counts_from_gathered(gids, gcnts, plan,
                                                     shard)),
            _np(shard_lib.counts_partial(torch.from_numpy(ids), plan,
                                         shard)))


@pytest.mark.parametrize("scheme", ["div", "mod"])
def test_torch_rowgrad_slots_equal_full_rows_at_the_slots(scheme):
    """The slot-level row gradient equals the full-row one at the slots
    (no overflow), and the full-row one sums the owned cotangents."""
    rng = np.random.default_rng(4)
    plan = shard_lib.RowShardPlan(13, 2, scheme)
    ids = torch.from_numpy(rng.integers(0, 13, size=30).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(30, 4)).astype(np.float32))
    for shard in range(2):
        uloc, counts, ovf = hybrid_lib.owned_unique_local(
            ids, plan, plan.rows_per_shard, shard)
        assert not bool(ovf)
        full = shard_lib.rowgrad_partial(g, ids, plan, shard)
        slots = hybrid_lib.rowgrad_slots(g, ids, plan, uloc, shard)
        real = counts > 0
        torch.testing.assert_close(slots[real],
                                   full[uloc[real].to(torch.int64)],
                                   rtol=0, atol=0)
        mine = plan.shard_of(ids) == shard
        want = torch.zeros(plan.rows_per_shard, 4).index_add_(
            0, plan.local_row(ids)[mine].to(torch.int64), g[mine])
        torch.testing.assert_close(full, want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the per-shard updates
# ---------------------------------------------------------------------------


def _shard_state(rng, rows, dim, depth=5):
    w = (0.05 * rng.normal(size=(rows, dim))).astype(np.float32)
    m = (0.01 * rng.normal(size=(rows, dim))).astype(np.float32)
    v = (0.001 * np.abs(rng.normal(size=(rows, dim)))).astype(np.float32)
    ls = rng.integers(0, depth, size=rows).astype(np.int32)
    return w, m, v, ls


ADAM = dict(lr=0.05, l2=0.01, b1=0.9, b2=0.999, eps=1e-8)


@pytest.mark.parametrize("dim", [4, 1])
@pytest.mark.parametrize("clip", [True, False])
def test_torch_shard_update_matches_jax(dim, clip):
    rng = np.random.default_rng(dim)
    w, m, v, _ = _shard_state(rng, 15, dim)
    g = rng.normal(size=(15, dim)).astype(np.float32)
    cnt = rng.integers(0, 3, size=15).astype(np.float32)
    t = 7
    want = jax_shard.shard_update(*map(jnp.asarray, (w, g, cnt, m, v)),
                                  jnp.int32(t), clip=clip, r=1.0, zeta=1e-5,
                                  **ADAM)
    tw, tm, tv = (torch.from_numpy(x.copy()) for x in (w, m, v))
    shard_lib.shard_update(tw, torch.from_numpy(g), torch.from_numpy(cnt),
                           tm, tv, step_scalars(t), clip=clip, r=1.0,
                           zeta=1e-5, **ADAM)
    for got, ref in zip((tw, tm, tv), want):
        np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)


@pytest.mark.parametrize("branch", ["sparse", "fallback_idle",
                                    "fallback_taken"])
@pytest.mark.parametrize("dim", [4, 1])
def test_torch_update_phase_matches_jax(branch, dim):
    """The port's plain ``update_phases`` on one table against JAX's
    ``update_phase`` (its jnp branch): the
    sparse branch (no fallback traced), a field that can overflow but did
    not (both branches run, the flag keeps the sparse one), and one that
    did (the dense fallback kept)."""
    rng = np.random.default_rng(11 + dim)
    rows, cap, t = 15, 4, 6
    w, m, v, ls = _shard_state(rng, rows, dim)
    uloc = np.array([1, 4, 9, rows], np.int32)
    counts = np.array([2, 1, 3, 0], np.float32)
    g_slots = rng.normal(size=(cap, dim)).astype(np.float32)
    g_full = rng.normal(size=(rows, dim)).astype(np.float32)
    cnt_full = np.zeros(rows, np.float32)
    cnt_full[[1, 4, 9, 11]] = [2, 1, 3, 1]
    g_full[cnt_full == 0] = 0.0
    overflow = {"sparse": None, "fallback_idle": False,
                "fallback_taken": True}[branch]
    kw = dict(clip=True, r=1.0, zeta=1e-5, **ADAM)

    jargs = [jnp.asarray(x) for x in (w, m, v, ls, uloc, counts)]
    if overflow is None:
        want = jax_hybrid.update_phase(
            *jargs, False, jnp.asarray(g_slots), None, None, jnp.int32(t),
            use_kernel=False, interpret=True, **kw)
    else:
        want = jax_hybrid.update_phase(
            *jargs, jnp.asarray(overflow), None, jnp.asarray(g_full),
            jnp.asarray(cnt_full), jnp.int32(t), use_kernel=False,
            interpret=True, **kw)

    tw, tm, tv, tls = (torch.from_numpy(x.copy()) for x in (w, m, v, ls))
    hybrid_lib.update_phases([hybrid_lib.ShardTable(
        tw, tm, tv, tls, torch.from_numpy(uloc), torch.from_numpy(counts),
        None if overflow is None else torch.tensor(overflow),
        torch.from_numpy(g_slots) if overflow is None else None,
        None if overflow is None else torch.from_numpy(g_full),
        None if overflow is None else torch.from_numpy(cnt_full))],
        step_scalars(t), **kw)
    for got, ref in zip((tw, tm, tv), want[:3]):
        np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(_np(tls), np.asarray(want[3]))


def test_torch_decayed_lookup_equals_catchup_rows():
    """The forward's inline decay and the catch-up's rows agree on the CPU
    (the card's bitwise check is chip_smoke.py phase 34 and
    test_torch_cuda.py)."""
    from repro_torch.kernels.cowclip import ref as cc_ref

    rng = np.random.default_rng(5)
    plan = shard_lib.RowShardPlan(57, 4, "div")
    w, m, v, ls = _shard_state(rng, plan.rows_per_shard, 4, depth=6)
    tw, tm, tv, tls = map(torch.from_numpy, (w, m, v, ls))
    ids = torch.from_numpy(rng.integers(0, 15, size=20).astype(np.int32))
    t = torch.tensor(8, dtype=torch.int32)
    factor = 0.999
    got = shard_lib.decayed_lookup_partial(tw, tls, ids, plan, 0, t, factor)
    lr, l2 = 0.1, 0.01        # decay_factor(0.1, 0.01) == f32(0.999)
    rows, _, _ = cc_ref.sparse_gather_catchup_reference(
        tw, tm, tv, tls, ids, step_scalars(8), lr=lr, l2=l2)
    torch.testing.assert_close(got, rows, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# whole steps on a gloo world of one rank
# ---------------------------------------------------------------------------


@pytest.fixture
def world1():
    """A gloo process group of one rank, destroyed after the test."""
    with mesh_lib.process_group("cpu"):
        yield mesh_lib.make_ctr_mesh(1, 1, device_type="cpu")


def _cfgs(**kw):
    common = dict(name="deepfm", vocab_sizes=VOCABS, n_dense=3, emb_dim=4,
                  mlp_dims=(16, 16, 16), emb_sigma=1e-2, **kw)
    return jax_ctr.CTRConfig(**common), ctr.CTRConfig(**common)


def _hps():
    # l2 large enough that a step's decay moves a row far past the bar
    kw = dict(base_lr=1e-3, base_l2=1.0, base_batch=64, batch_size=64,
              base_dense_lr=2e-3)
    return jax_scale_hyperparams("cowclip", **kw), scale_hyperparams(
        "cowclip", **kw)


# each field's ids a step, in turn: a row skips a step or first appears
# after step 1, so later forwards read rows with pending lazy decay
POOLS = (([1, 2, 3], np.arange(6), [0]),
         ([50, 51], np.arange(6, 13), [4]),
         ([1, 2, 3, 20, 50, 51], np.arange(13), [0, 4]))


def _batches(n_steps, batch=32, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_steps):
        ids = np.stack([rng.choice(p, size=batch)
                        for p in POOLS[i % len(POOLS)]], axis=1)
        out.append({"ids": ids.astype(np.int32),
                    "dense": rng.normal(size=(batch, 3)).astype(np.float32),
                    "labels": (rng.random(batch) < 0.3).astype(np.float32)})
    return out


def _close(got, want, what):
    """Every leaf within rtol 1e-5 and an atol of 1e-6 of the leaf's
    largest magnitude: a bar scaled to each leaf, so Adam's v (~1e-9 here)
    and the decay's pull on a row are held as tightly as the weights."""
    ft, fj = flatten_with_paths(got), flatten_with_paths(want)
    assert ft.keys() == fj.keys(), what
    for k in ft:
        w = np.asarray(fj[k])
        atol = 1e-6 * float(np.max(np.abs(w))) if w.size else 0.0
        np.testing.assert_allclose(np.asarray(ft[k]), w, rtol=1e-5,
                                   atol=atol, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("scheme,clip", [("div", True), ("mod", True),
                                         ("div", False)])
def test_torch_sharded_1x1_matches_jax_sharded_step(world1, scheme, clip):
    """``sharded`` on a gloo world of one rank against JAX's
    ``make_sharded_train_step`` on a 1x1 mesh: params, moments and the
    tower's state after each of 3 steps (``_close``)."""
    cfg_j, cfg_t = _cfgs(placement="sharded")
    hp_j, hp_t = _hps()
    clip_kind = "adaptive_column" if clip else "none"
    jbundle = jax_build_train_step(
        cfg_j, hp_j, path="sharded", partition=scheme, clip_kind=clip_kind,
        mesh=jax.make_mesh((1, 1), ("data", "model")), warmup_steps=0)
    tbundle = store_for(cfg_t, mesh=world1, partition=scheme).make_bundle(
        cfg_t, hp_t, clip_kind=clip_kind, warmup_steps=0)
    params_j = jax_ctr.init(jax.random.key(0), cfg_j)
    params_t = tbundle.prepare(
        params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu"))
    params_j = jbundle.prepare(params_j)
    state_j, state_t = jbundle.init(params_j), tbundle.init(params_t)
    for b in _batches(3):
        params_j, state_j, aux_j = jbundle.step(
            params_j, state_j, jax.tree.map(jnp.asarray, b))
        params_t, state_t, aux_t = tbundle.step(
            params_t, state_t, tree_map(torch.from_numpy, b))
        assert float(aux_t["loss"]) == pytest.approx(float(aux_j["loss"]),
                                                     rel=1e-5)
        _close(params_to_numpy(tbundle.export(params_t)),
               jax.tree.map(np.asarray, jbundle.export(params_j)), "params")
        _close(params_to_numpy({k: state_t[k] for k in ("m", "v", "dense")}),
               jax.tree.map(np.asarray,
                            {k: state_j[k] for k in ("m", "v", "dense")}),
               "state")
        assert int(state_t["step"]) == int(state_j["step"])


@pytest.mark.parametrize("scheme", ["div", "mod"])
def test_torch_sharded_sparse_1x1_matches_jax_substrate(world1, scheme):
    """``sharded_sparse`` on one rank, flushed after each of 3 steps (on a
    copy), against JAX's substrate step (``_close``); then the live state
    flushed and exported equals the flushed copy bitwise."""
    cfg_j, cfg_t = _cfgs(placement="sharded_sparse")
    hp_j, hp_t = _hps()
    tx = jax_build_optimizer(hp_j, warmup_steps=0)
    jstep = jax_make_train_step(cfg_j, tx)
    tbundle = store_for(cfg_t, mesh=world1, partition=scheme).make_bundle(
        cfg_t, hp_t, warmup_steps=0)
    params_j = jax_ctr.init(jax.random.key(0), cfg_j)
    state_j = tx.init(params_j)
    params_t = tbundle.prepare(
        params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu"))
    state_t = tbundle.init(params_t)
    for b in _batches(3):
        params_j, state_j, aux_j = jstep(params_j, state_j,
                                         jax.tree.map(jnp.asarray, b))
        params_t, state_t, aux_t = tbundle.step(
            params_t, state_t, tree_map(torch.from_numpy, b))
        assert int(aux_t["overflow_shards"]) == 0
        p, s = tbundle.flush(*tree_map(torch.clone, (params_t, state_t)))
        flushed = params_to_numpy(tbundle.export(p))
        _close(flushed, jax.tree.map(np.asarray, params_j), "params")
    p, _ = tbundle.flush(params_t, state_t)
    for k, x in flatten_with_paths(params_to_numpy(tbundle.export(p))).items():
        np.testing.assert_array_equal(x, flatten_with_paths(flushed)[k])


@pytest.mark.parametrize("placement", ["sharded", "sharded_sparse"])
def test_torch_sharded_store_needs_a_mesh(placement):
    """A sharded store is built on a grid the caller made: without one it
    refuses, before any collective (it never makes a grid itself)."""
    _, cfg = _cfgs(placement=placement)
    with pytest.raises(ValueError, match="placement needs mesh="):
        store_for(cfg)


def test_torch_sharded_refuses_a_batch_the_data_axis_does_not_divide():
    """The reference's error, raised before any collective; a world of one
    rank cannot have a data axis of 2, so the grid is a stand-in."""
    from repro_torch.train.loop import _data_slice

    grid = mesh_lib.CtrMesh(2, 1, 0, 0, None, None)
    b = {"ids": torch.zeros(31, 3, dtype=torch.int32)}
    with pytest.raises(ValueError, match="not divisible by data axis 2"):
        _data_slice(b, grid)
    assert _data_slice({"ids": torch.arange(8)}, mesh_lib.CtrMesh(
        2, 1, 1, 0, None, None))["ids"].tolist() == [4, 5, 6, 7]


def test_torch_sharded_sparse_train_ctr_reports_overflow(world1, caplog):
    """``train_ctr`` on a world of one rank with a capped capacity: the
    scan engine equals the eager one bitwise, both count the same dense
    fallbacks (read with an epoch's losses, warned through logging), and
    the eval runs on the exported tables."""
    from repro_torch.data import make_ctr_dataset
    from repro_torch.train import train_ctr

    _, cfg = _cfgs(placement="sharded_sparse", unique_capacity=2)
    _, hp = _hps()
    tr, te = make_ctr_dataset(6 * 64 + 40, VOCABS, n_dense=3,
                              seed=3).split(0.9)
    params0 = ctr.init(cfg, seed=1, device="cpu")
    runs = {}
    for engine in ("eager", "scan"):
        bundle = store_for(cfg, mesh=world1).make_bundle(cfg, hp,
                                                         warmup_steps=2)
        params = bundle.prepare(tree_map(torch.clone, params0))
        with caplog.at_level("WARNING"):
            runs[engine] = train_ctr(
                cfg, None, tr, te, batch_size=64, step_bundle=bundle,
                engine=engine, scan_steps=4,
                init_state=(params, bundle.init(params)), device="cpu")
    a, b = runs["eager"], runs["scan"]
    assert a.steps == b.steps == 5 and a.losses == b.losses
    assert a.overflow_shards == b.overflow_shards > 0
    assert caplog.text.count("unique capacity overflow on "
                             f"{a.overflow_shards} field-shard") == 2
    fa, fb = flatten_with_paths(a.params), flatten_with_paths(b.params)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k
    assert a.final_eval["auc"] == b.final_eval["auc"]
