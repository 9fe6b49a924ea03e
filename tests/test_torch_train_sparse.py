"""The port's sparse-placement training slice against the JAX package's.

Both sides start from the same JAX-initialised params and consume the same
NumPy batches in the same ``iterate_batches`` shuffle order. The JAX side
runs ``sparse`` through its jnp reference (``use_kernel=False``), the port
its plain CPU versions of the two sparse kernels. Params, Adam moments and
``last_step`` after every step, and the final eval AUC, must agree to 1e-5
(rtol 1e-5, atol 1e-5: float32 on the CPU, differing in summation order
only), the loss to rel 1e-5, ``last_step`` and ``catchup_depth_max``
exactly. The port's flushed sparse placement is held to its fused one, and
a JAX sparse run hands off mid-run to the port through a checkpoint.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_train_step as jax_build_train_step
from repro.core import scale_hyperparams as jax_scale_hyperparams
from repro.data import iterate_batches as jax_iterate_batches
from repro.embed.store import max_pending_depth as jax_max_pending_depth
from repro.models import ctr as jax_ctr
from repro.train import checkpoint as jax_checkpoint
from repro.train import train_ctr as jax_train_ctr
from repro_torch.core.scaling import scale_hyperparams
from repro_torch.core.tree import flatten_with_paths, tree_leaves, tree_map
from repro_torch.data import iterate_batches, make_ctr_dataset
from repro_torch.embed import store_for
from repro_torch.embed.store import max_pending_depth, serving_snapshot
from repro_torch.models import ctr
from repro_torch.serve.engine import collapse_pending_decay
from repro_torch.train import checkpoint, train_ctr
from repro_torch.train.checkpoint import params_from_numpy, params_to_numpy

VOCABS = (2000, 700, 120, 30, 5)
K = 5
BATCH = 512
WARMUP = 3
TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(name="deepfm", base_l2=1e-3, unique_capacity=0):
    """Configs, hypers and data. ``base_l2`` 1e-3 makes the per-step decay
    factor ``fl32(1 - lr*l2)`` differ from 1.0, so the catch-up has work."""
    common = dict(name=name, vocab_sizes=VOCABS, n_dense=4, emb_dim=8,
                  mlp_dims=(32, 32, 32), emb_sigma=1e-2,
                  unique_capacity=unique_capacity)
    cfg_j = jax_ctr.CTRConfig(sparse=True, **common)
    cfg_t = ctr.CTRConfig(placement="sparse", **common)
    hkw = dict(base_lr=1e-3, base_l2=base_l2, base_batch=256,
               batch_size=BATCH, base_dense_lr=2e-3)
    hp_j = jax_scale_hyperparams("cowclip", **hkw)
    hp_t = scale_hyperparams("cowclip", **hkw)
    ds = make_ctr_dataset(2 * K * BATCH * 10 // 9 + 64, VOCABS, n_dense=4,
                          zipf_a=1.1, seed=2)
    return cfg_j, cfg_t, hp_j, hp_t, ds


def _bundles(cfg_j, cfg_t, hp_j, hp_t):
    bundle_j = jax_build_train_step(cfg_j, hp_j, path="sparse",
                                    warmup_steps=WARMUP, use_kernel=False)
    bundle_t = store_for(cfg_t).make_bundle(cfg_t, hp_t, warmup_steps=WARMUP)
    return bundle_j, bundle_t


def _flat_np(tree):
    if any(isinstance(x, torch.Tensor) for x in tree_leaves(tree)):
        return flatten_with_paths(params_to_numpy(tree))
    return flatten_with_paths(jax.tree.map(np.asarray, tree))


def _assert_close(tree_t, tree_j, what, exact=False):
    flat_t, flat_j = _flat_np(tree_t), _flat_np(tree_j)
    assert flat_t.keys() == flat_j.keys()
    for k in flat_j:
        if exact:
            np.testing.assert_array_equal(flat_t[k], flat_j[k],
                                          err_msg=f"{what}: {k}")
        else:
            np.testing.assert_allclose(flat_t[k], flat_j[k],
                                       err_msg=f"{what}: {k}", **TOL)


def _assert_equal(tree_a, tree_b, what):
    flat_a, flat_b = _flat_np(tree_a), _flat_np(tree_b)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k],
                                      err_msg=f"{what}: {k}")


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _clone(tree):
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                    else x, tree)


def _run_both(cfg_j, cfg_t, hp_j, hp_t, ds, n_steps, seed):
    """``n_steps`` sparse steps on both sides from the same params; checks
    every step and returns the final (params, state) of each."""
    tr, _ = ds.split(0.9)
    bundle_j, bundle_t = _bundles(cfg_j, cfg_t, hp_j, hp_t)
    params_j = jax_ctr.init(jax.random.key(seed), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    state_j = bundle_j.init(params_j)
    state_t = bundle_t.init(params_t)
    batches = list(iterate_batches(tr, BATCH, seed=0))[:n_steps]
    batches_j = list(jax_iterate_batches(tr, BATCH, seed=0))[:n_steps]
    assert len(batches) == n_steps
    depths = []
    for i, (bt, bj) in enumerate(zip(batches, batches_j)):
        params_j, state_j, aux_j = bundle_j.step(params_j, state_j,
                                                 _jax_batch(bj))
        params_t, state_t, aux_t = bundle_t.step(params_t, state_t,
                                                 _torch_batch(bt))
        np.testing.assert_allclose(float(aux_t["loss"]),
                                   float(aux_j["loss"]), rtol=1e-5)
        assert aux_t["catchup_depth_max"].dtype == torch.int32
        assert (int(aux_t["catchup_depth_max"])
                == int(aux_j["catchup_depth_max"])), i
        depths.append(int(aux_t["catchup_depth_max"]))
        _assert_close(params_t, params_j, f"step {i + 1}")
    # the step's rows really had pending decay to catch up
    assert n_steps < 3 or max(depths) > 0
    assert state_t["step"] == int(state_j["step"]) == n_steps
    for g in ("m", "v"):
        _assert_close(state_t[g], state_j[g], f"state {g}")
    _assert_close(state_t["last_step"], state_j["last_step"], "last_step",
                  exact=True)
    return (params_t, state_t, bundle_t), (params_j, state_j, bundle_j)


@pytest.mark.parametrize("name", ["deepfm", "dcnv2"])
def test_torch_sparse_steps_match_jax(name):
    """K sparse steps, then flush on both sides: params, moments and
    ``last_step`` agree, and the pending depth matches before the flush."""
    cfg_j, cfg_t, hp_j, hp_t, ds = _setup(name)
    (params_t, state_t, bundle_t), (params_j, state_j, bundle_j) = _run_both(
        cfg_j, cfg_t, hp_j, hp_t, ds, K, seed=3)
    assert max_pending_depth(state_t) == jax_max_pending_depth(state_j) > 0
    params_t, state_t = bundle_t.flush(params_t, state_t)
    params_j, state_j = bundle_j.flush(params_j, state_j)
    _assert_close(params_t, params_j, "after flush")
    assert max_pending_depth(state_t) == 0


def test_torch_sparse_overflow_matches_jax():
    """``unique_capacity`` 3, far below every field's distinct ids: the
    forward clamps, the backward drops and dropped ids get no update, the
    same as JAX's sparse placement."""
    cfg_j, cfg_t, hp_j, hp_t, ds = _setup(unique_capacity=3)
    (params_t, state_t, _), _ = _run_both(cfg_j, cfg_t, hp_j, hp_t, ds, 3,
                                          seed=4)
    # overflow really happened: most ids a batch touched were dropped
    ls = state_t["last_step"]["fm"]["field_0"]
    assert 0 < int((ls > 0).sum()) <= 3 * 3
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(params_t))


def test_torch_train_ctr_sparse_matches_jax_auc():
    """The whole training loop, ``train_ctr``: K steps, flush, one eval;
    final params and AUC agree to 1e-5."""
    cfg_j, cfg_t, hp_j, hp_t, ds = _setup()
    tr, te = ds.split(0.9)
    bundle_j, bundle_t = _bundles(cfg_j, cfg_t, hp_j, hp_t)
    params_j = jax_ctr.init(jax.random.key(5), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    res_j = jax_train_ctr(cfg_j, None, tr, te, batch_size=BATCH, seed=0,
                          step_bundle=bundle_j, max_steps=K, engine="eager",
                          init_state=(params_j, bundle_j.init(params_j)))
    res_t = train_ctr(cfg_t, None, tr, te, batch_size=BATCH, seed=0,
                      step_bundle=bundle_t, max_steps=K,
                      init_state=(params_t, bundle_t.init(params_t)))
    assert res_t.steps == res_j.steps == K
    _assert_close(res_t.params, res_j.params, "train_ctr")
    for key in ("auc", "logloss"):
        assert abs(res_t.final_eval[key] - res_j.final_eval[key]) <= 1e-5, key


@pytest.mark.parametrize("base_l2", [1e-3, 0.0])
def test_torch_sparse_flushed_matches_fused(base_l2):
    """Torch sparse, flushed, against torch fused over K steps: the closed
    form ``w * f**k`` against the fused path's repeated ``w * f``, within
    1e-5."""
    _, cfg_t, _, hp_t, ds = _setup(base_l2=base_l2)
    tr, _ = ds.split(0.9)
    params0 = ctr.init(cfg_t, seed=1, device="cpu")
    out = {}
    for path in ("sparse", "fused"):
        bundle = store_for(cfg_t, path=path).make_bundle(
            cfg_t, hp_t, warmup_steps=WARMUP)
        params = _clone(params0)
        state = bundle.init(params)
        for b in list(iterate_batches(tr, BATCH, seed=0))[:K]:
            params, state, _ = bundle.step(params, state, _torch_batch(b))
        out[path], _ = bundle.flush(params, state)
    flat_s, flat_f = _flat_np(out["sparse"]), _flat_np(out["fused"])
    for k in flat_f:
        np.testing.assert_allclose(flat_s[k], flat_f[k], err_msg=k, **TOL)


def test_torch_sparse_flush_idempotent_and_untouched_rows():
    """Absent ids' rows stay byte-identical until ``flush`` (decay is
    deferred, recorded in ``last_step``); a second flush is a bitwise
    no-op; ``serving_snapshot`` is the flushed params."""
    _, cfg_t, _, hp_t, ds = _setup()
    tr, _ = ds.split(0.9)
    bundle = store_for(cfg_t).make_bundle(cfg_t, hp_t, warmup_steps=WARMUP)
    params = ctr.init(cfg_t, seed=2, device="cpu")
    state = bundle.init(params)
    before = params["embed"]["fm"]["field_0"].clone()
    batches = list(iterate_batches(tr, BATCH, seed=0))[:2]
    for b in batches:
        params, state, _ = bundle.step(params, state, _torch_batch(b))
    touched = np.unique(np.concatenate([b["ids"][:, 0] for b in batches]))
    absent = np.setdiff1d(np.arange(VOCABS[0]), touched)
    assert absent.size > 0
    after = params["embed"]["fm"]["field_0"]
    assert torch.equal(after[absent], before[absent])
    ls = state["last_step"]["fm"]["field_0"]
    assert (ls[absent] == 0).all() and (ls[touched] > 0).all()
    assert max_pending_depth(state) == 2

    snap = serving_snapshot(bundle, _clone(params), _clone(state))
    params, state = bundle.flush(params, state)
    _assert_equal(snap, params, "serving_snapshot")
    assert not torch.equal(params["embed"]["fm"]["field_0"][absent],
                           before[absent])      # the decay landed
    once = _clone(params)
    params, state = bundle.flush(params, state)
    _assert_equal(params, once, "second flush")
    assert max_pending_depth(state) == 0


def test_torch_collapse_pending_decay_equals_flush():
    """A raw sparse state with no live bundle: ``collapse_pending_decay``
    settles it to exactly what ``flush`` gives."""
    _, cfg_t, _, hp_t, ds = _setup()
    tr, _ = ds.split(0.9)
    bundle = store_for(cfg_t).make_bundle(cfg_t, hp_t)
    params = ctr.init(cfg_t, seed=6, device="cpu")
    state = bundle.init(params)
    for b in list(iterate_batches(tr, BATCH, seed=0))[:3]:
        params, state, _ = bundle.step(params, state, _torch_batch(b))
    collapsed = collapse_pending_decay(
        params["embed"], state["last_step"], state["step"], lr=hp_t.emb_lr,
        l2=hp_t.emb_l2)
    flushed, _ = bundle.flush(params, state)
    _assert_equal(collapsed, flushed["embed"], "collapse vs flush")


def test_torch_sparse_handoff_from_jax_checkpoint(tmp_path):
    """K steps of JAX sparse, its params and full optimizer state (step, m,
    v, int32 last_step, dense) saved as a JAX checkpoint npz, restored by
    the port, and K more steps on each side from there: they agree to
    1e-5."""
    cfg_j, cfg_t, hp_j, hp_t, ds = _setup()
    tr, _ = ds.split(0.9)
    bundle_j, bundle_t = _bundles(cfg_j, cfg_t, hp_j, hp_t)
    params_j = jax_ctr.init(jax.random.key(7), cfg_j)
    state_j = bundle_j.init(params_j)
    batches = list(iterate_batches(tr, BATCH, seed=0))[:2 * K]
    batches_j = list(jax_iterate_batches(tr, BATCH, seed=0))[:2 * K]
    for b in batches_j[:K]:
        params_j, state_j, _ = bundle_j.step(params_j, state_j, _jax_batch(b))
    assert jax_max_pending_depth(state_j) > 0
    path = str(tmp_path / "jax_sparse.npz")
    jax_checkpoint.save(path, {"params": params_j, "opt_state": state_j})

    params_t = ctr.init(cfg_t, seed=0, device="cpu")
    template = {"params": params_t, "opt_state": bundle_t.init(params_t)}
    back = checkpoint.restore(path, template)
    params_t, state_t = back["params"], back["opt_state"]
    assert state_t["step"] == K and isinstance(state_t["step"], int)
    assert state_t["last_step"]["fm"]["field_0"].dtype == torch.int32
    _assert_close(params_t, params_j, "restored params", exact=True)

    for bt, bj in zip(batches[K:], batches_j[K:]):
        params_j, state_j, aux_j = bundle_j.step(params_j, state_j,
                                                 _jax_batch(bj))
        params_t, state_t, aux_t = bundle_t.step(params_t, state_t,
                                                 _torch_batch(bt))
        np.testing.assert_allclose(float(aux_t["loss"]),
                                   float(aux_j["loss"]), rtol=1e-5)
    _assert_close(params_t, params_j, "continued")
    _assert_close(state_t["last_step"], state_j["last_step"], "last_step",
                  exact=True)


def test_torch_sparse_state_checkpoint_roundtrip(tmp_path):
    """The port's full sparse state (dicts, tuples, NamedTuples, int
    counters, int32 ``last_step``) round-trips through save/restore bit
    for bit, into a JAX template too."""
    cfg_j, cfg_t, hp_j, hp_t, ds = _setup()
    tr, _ = ds.split(0.9)
    bundle_j, bundle_t = _bundles(cfg_j, cfg_t, hp_j, hp_t)
    params = ctr.init(cfg_t, seed=0, device="cpu")
    state = bundle_t.init(params)
    for b in list(iterate_batches(tr, BATCH, seed=0))[:2]:
        params, state, _ = bundle_t.step(params, state, _torch_batch(b))
    tree = {"params": params, "opt_state": state}
    path = str(tmp_path / "state.npz")
    checkpoint.save(path, tree)
    fresh = ctr.init(cfg_t, seed=9, device="cpu")
    back = checkpoint.restore(path, {"params": fresh,
                                     "opt_state": bundle_t.init(fresh)})
    assert back["opt_state"]["step"] == 2
    _assert_equal(back, tree, "roundtrip")

    params_j = jax_ctr.init(jax.random.key(0), cfg_j)
    template_j = {"params": params_j, "opt_state": bundle_j.init(params_j)}
    back_j = jax_checkpoint.restore(path, template_j)
    assert int(back_j["opt_state"]["step"]) == 2
    _assert_close(back["opt_state"]["last_step"],
                  back_j["opt_state"]["last_step"], "jax restore", exact=True)


def test_torch_sparse_store_contract():
    """The sparse bundle's clip_kind rule (as the reference's), the cfg
    ``sparse`` knob's routing, and the nonfinite guard."""
    _, cfg_t, _, hp_t, ds = _setup()
    with pytest.raises(ValueError, match="clip_kind"):
        store_for(cfg_t).make_bundle(cfg_t, hp_t, clip_kind="global_norm")
    legacy = dataclasses.replace(cfg_t, placement=None, sparse=True)
    assert store_for(legacy).path == "sparse"

    tr, _ = ds.split(0.9)
    batch = _torch_batch(next(iterate_batches(tr, BATCH, seed=0)))
    bad = dict(batch, dense=batch["dense"].clone())
    bad["dense"][0, 0] = float("nan")
    guarded = store_for(cfg_t).make_bundle(cfg_t, hp_t, nonfinite_guard=True)
    params = ctr.init(cfg_t, seed=0, device="cpu")
    p, s = _clone(params), guarded.init(_clone(params))
    p2, s2, aux = guarded.step(p, s, bad)
    assert aux["skipped_steps"] == 1 and s2["step"] == 0
    _assert_equal(p2, params, "guarded")

    plain = store_for(cfg_t).make_bundle(cfg_t, hp_t)
    pg, _, aux = guarded.step(_clone(params), guarded.init(_clone(params)),
                              batch)
    pp, _, _ = plain.step(_clone(params), plain.init(_clone(params)), batch)
    assert aux["skipped_steps"] == 0
    _assert_equal(pg, pp, "guard on a clean batch")


def test_torch_sparse_unclipped_matches_jax():
    """``clip_kind="none"``: the update skips CowClip on both sides."""
    cfg_j, cfg_t, hp_j, hp_t, ds = _setup()
    tr, _ = ds.split(0.9)
    bundle_j = jax_build_train_step(cfg_j, hp_j, path="sparse",
                                    clip_kind="none", use_kernel=False)
    bundle_t = store_for(cfg_t).make_bundle(cfg_t, hp_t, clip_kind="none")
    params_j = jax_ctr.init(jax.random.key(8), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    state_j, state_t = bundle_j.init(params_j), bundle_t.init(params_t)
    b = next(iterate_batches(tr, BATCH, seed=0))
    params_j, _, _ = bundle_j.step(params_j, state_j, _jax_batch(b))
    params_t, _, _ = bundle_t.step(params_t, state_t, _torch_batch(b))
    _assert_close(params_t, params_j, "unclipped")
