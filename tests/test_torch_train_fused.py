"""The port's fused-placement training slice against the JAX package's.

Both sides start from the same JAX-initialised params and consume the
same NumPy batches in the same ``iterate_batches`` shuffle order; the JAX
side runs ``make_fused_train_step`` through its jnp reference
(``use_kernel=False``), the port its plain CPU version. Params after every
step and the final eval AUC must agree to 1e-5 (rtol 1e-5, atol 1e-5:
float32 on the CPU, differing in summation order only). Checkpoints
interchange in both directions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import build_train_step as jax_build_train_step
from repro.core import scale_hyperparams as jax_scale_hyperparams
from repro.data import iterate_batches as jax_iterate_batches
from repro.models import ctr as jax_ctr
from repro.train import checkpoint as jax_checkpoint
from repro.train import train_ctr as jax_train_ctr
from repro.train.loop import make_eval_fn as jax_make_eval_fn
from repro_torch.core.scaling import scale_hyperparams
from repro_torch.core.tree import flatten_with_paths, tree_map
from repro_torch.data import iterate_batches, make_ctr_dataset
from repro_torch.embed import store_for
from repro_torch.models import ctr
from repro_torch.train import checkpoint, train_ctr
from repro_torch.train.checkpoint import params_from_numpy, params_to_numpy
from repro_torch.train.loop import make_eval_fn

VOCABS = (2000, 700, 120, 30, 5)
K = 5
BATCH = 512
WARMUP = 3
TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(name="deepfm"):
    common = dict(name=name, vocab_sizes=VOCABS, n_dense=4, emb_dim=8,
                  mlp_dims=(32, 32, 32), emb_sigma=1e-2)
    cfg_j = jax_ctr.CTRConfig(**common)
    cfg_t = ctr.CTRConfig(**common)
    hkw = dict(base_lr=1e-3, base_l2=1e-5, base_batch=256, batch_size=BATCH,
               base_dense_lr=2e-3)
    hp_j = jax_scale_hyperparams("cowclip", **hkw)
    hp_t = scale_hyperparams("cowclip", **hkw)
    ds = make_ctr_dataset(K * BATCH * 10 // 9 + 64, VOCABS, n_dense=4,
                          zipf_a=1.1, seed=2)
    return cfg_j, cfg_t, hp_j, hp_t, ds


def _assert_params_close(params_t, params_j, what):
    flat_t = flatten_with_paths(params_to_numpy(params_t))
    flat_j = flatten_with_paths(jax.tree.map(np.asarray, params_j))
    assert flat_t.keys() == flat_j.keys()
    for k in flat_j:
        np.testing.assert_allclose(flat_t[k], flat_j[k],
                                   err_msg=f"{what}: {k}", **TOL)


@pytest.mark.parametrize("name", ["deepfm", "dcnv2"])
def test_torch_fused_steps_match_jax(name):
    cfg_j, cfg_t, hp_j, hp_t, ds = _setup(name)
    tr, _ = ds.split(0.9)
    bundle_j = jax_build_train_step(cfg_j, hp_j, path="fused",
                                    warmup_steps=WARMUP, use_kernel=False)
    bundle_t = store_for(cfg_t, path="fused").make_bundle(
        cfg_t, hp_t, warmup_steps=WARMUP)

    params_j = jax_ctr.init(jax.random.key(3), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    state_j = bundle_j.init(params_j)
    state_t = bundle_t.init(params_t)

    batches_t = list(iterate_batches(tr, BATCH, seed=0))[:K]
    batches_j = list(jax_iterate_batches(tr, BATCH, seed=0))[:K]
    assert len(batches_t) == K
    for i, (bt, bj) in enumerate(zip(batches_t, batches_j)):
        params_j, state_j, aux_j = bundle_j.step(
            params_j, state_j, {k: jnp.asarray(v) for k, v in bj.items()})
        params_t, state_t, aux_t = bundle_t.step(
            params_t, state_t, {k: torch.from_numpy(v) for k, v in bt.items()})
        np.testing.assert_allclose(float(aux_t["loss"]),
                                   float(aux_j["loss"]), **TOL)
        _assert_params_close(params_t, params_j, f"step {i + 1}")
    assert state_t["step"] == int(state_j["step"]) == K
    for g in ("m", "v"):
        _assert_params_close(state_t[g], state_j[g], f"state {g}")


def test_torch_train_ctr_matches_jax_auc():
    """The whole epoch driver: K steps then one eval, from the same params
    and data; final params and AUC agree to 1e-5."""
    cfg_j, cfg_t, hp_j, hp_t, ds = _setup()
    tr, te = ds.split(0.9)
    bundle_j = jax_build_train_step(cfg_j, hp_j, path="fused",
                                    warmup_steps=WARMUP, use_kernel=False)
    bundle_t = store_for(cfg_t, path="fused").make_bundle(
        cfg_t, hp_t, warmup_steps=WARMUP)
    params_j = jax_ctr.init(jax.random.key(4), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")

    res_j = jax_train_ctr(cfg_j, None, tr, te, batch_size=BATCH, seed=0,
                          step_bundle=bundle_j, max_steps=K, engine="eager",
                          init_state=(params_j, bundle_j.init(params_j)))
    res_t = train_ctr(cfg_t, None, tr, te, batch_size=BATCH, seed=0,
                      step_bundle=bundle_t, max_steps=K,
                      init_state=(params_t, bundle_t.init(params_t)))
    assert res_t.steps == res_j.steps == K
    assert len(res_t.losses) == K and np.all(np.isfinite(res_t.losses))
    _assert_params_close(res_t.params, res_j.params, "train_ctr")
    for key in ("auc", "logloss"):
        assert abs(res_t.final_eval[key] - res_j.final_eval[key]) <= 1e-5, key
    # the eval paths themselves score identically on identical params
    ev_t = make_eval_fn(cfg_t)(res_t.params, te, batch_size=256)
    ev_j = jax_make_eval_fn(cfg_j)(
        jax.tree.map(jnp.asarray, params_to_numpy(res_t.params)), te,
        batch_size=256)
    assert abs(ev_t["auc"] - ev_j["auc"]) <= 1e-5


@pytest.mark.parametrize("placement", ["fused", "sparse"])
def test_torch_train_ctr_losses_read_once_per_epoch(placement):
    """``train_ctr`` keeps each step's loss on the device and reads an
    epoch's losses at once: over 2 epochs its ``losses`` and final eval
    equal, bit for bit, a replay of the same steps that reads every loss on
    the host as it comes (the loop before the repair), with one
    ``step_seconds`` per step."""
    _, cfg, _, hp, ds = _setup()
    cfg = dataclasses.replace(cfg, placement=placement)
    tr, te = ds.split(0.9)
    bundle = store_for(cfg).make_bundle(cfg, hp, warmup_steps=WARMUP)
    params0 = ctr.init(cfg, seed=6, device="cpu")

    def fresh():
        params = tree_map(torch.clone, params0)
        return params, bundle.init(params)

    res = train_ctr(cfg, None, tr, te, batch_size=BATCH, epochs=2, seed=0,
                    step_bundle=bundle, init_state=fresh())
    params, state = fresh()
    losses, evaluate = [], make_eval_fn(cfg)
    for epoch in range(2):
        for b in iterate_batches(tr, BATCH, seed=epoch):
            batch = {k: torch.as_tensor(x) for k, x in b.items()}
            params, state, aux = bundle.step(params, state, batch)
            losses.append(float(aux["loss"]))
        params, state = bundle.flush(params, state)
        ev = evaluate(params, te)
    assert res.steps == len(losses) > 2
    assert res.losses == losses
    assert len(res.step_seconds) == res.steps
    assert all(sec > 0 for sec in res.step_seconds)
    for key in ("auc", "logloss"):
        assert res.final_eval[key] == ev[key], key


class _ScalarReads(TorchDispatchMode):
    """Counts the host's reads of a tensor's scalar (``float``, ``int``,
    ``bool``, ``.item()``: ``aten::_local_scalar_dense``) while active."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.count += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("placement", ["fused", "sparse"])
def test_torch_train_ctr_reads_no_scalar_in_a_step(placement):
    """No step of ``train_ctr`` reads a scalar on the host: over 2 epochs
    without eval it makes no read at all (the epoch's losses come back by
    one ``tolist``), while the same run with a step that reads its loss,
    as the loop did before the repair, shows one read a step."""
    _, cfg, _, hp, ds = _setup()
    cfg = dataclasses.replace(cfg, placement=placement)
    tr, _ = ds.split(0.9)
    bundle = store_for(cfg).make_bundle(cfg, hp, warmup_steps=WARMUP)
    params0 = ctr.init(cfg, seed=6, device="cpu")

    def reading_step(params, state, batch):
        out = bundle.step(params, state, batch)
        float(out[2]["loss"])
        return out

    counts = []
    for b in (bundle, bundle._replace(step=reading_step)):
        params = tree_map(torch.clone, params0)
        state = b.init(params)
        with _ScalarReads() as reads:
            res = train_ctr(cfg, None, tr, None, batch_size=BATCH, epochs=2,
                            seed=0, step_bundle=b, init_state=(params, state))
        counts.append(reads.count)
        assert len(res.losses) == res.steps > 2
    assert counts == [0, res.steps]


def test_torch_loads_jax_checkpoint_and_back(tmp_path):
    """A JAX checkpoint .npz (run_ctr's layout) loads through the port, and
    a port checkpoint restores in JAX, leaf for leaf."""
    cfg_j, cfg_t, _, _, _ = _setup()
    params_j = jax_ctr.init(jax.random.key(5), cfg_j)
    path_j = str(tmp_path / "jax.npz")
    jax_checkpoint.save(path_j, {"params": params_j,
                                 "final_eval": {"auc": jnp.asarray(0.5)}})
    params_t = params_from_numpy(path_j, device="cpu")
    _assert_params_close(params_t, params_j, "jax -> torch")

    # and back: the port's save restores into a JAX template exactly
    path_t = str(tmp_path / "torch.npz")
    checkpoint.save(path_t, params_t)
    back = jax_checkpoint.restore(path_t, params_j)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params_j)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_torch_checkpoint_roundtrip_full_state(tmp_path):
    """Params and optimizer state (dicts, tuples, NamedTuples, ints) round
    trip through the port's own save/restore bit for bit."""
    _, cfg_t, _, hp_t, ds = _setup()
    tr, _ = ds.split(0.9)
    bundle = store_for(cfg_t, path="fused").make_bundle(cfg_t, hp_t,
                                                        warmup_steps=WARMUP)
    params = ctr.init(cfg_t, seed=0, device="cpu")
    state = bundle.init(params)
    batch = next(iterate_batches(tr, BATCH, seed=0))
    params, state, _ = bundle.step(
        params, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    tree = {"params": params, "opt_state": tree_map(
        lambda x: torch.as_tensor(x), state)}
    path = str(tmp_path / "state.npz")
    checkpoint.save(path, tree)
    template = tree_map(torch.zeros_like, tree)
    back = checkpoint.restore(path, template)
    for k, a in flatten_with_paths(tree).items():
        assert torch.equal(flatten_with_paths(back)[k], a), k


def test_torch_nonfinite_guard_skips_poisoned_batch():
    """A NaN batch leaves params, moments and the step counter untouched;
    a clean batch through the guarded step equals the unguarded step."""
    _, cfg_t, _, hp_t, ds = _setup()
    tr, _ = ds.split(0.9)
    store = store_for(cfg_t, path="fused")
    plain = store.make_bundle(cfg_t, hp_t)
    guarded = store.make_bundle(cfg_t, hp_t, nonfinite_guard=True)
    batch = {k: torch.from_numpy(v)
             for k, v in next(iterate_batches(tr, BATCH, seed=0)).items()}
    params = ctr.init(cfg_t, seed=0, device="cpu")
    clone = lambda t: tree_map(lambda x: x.clone(), t)  # noqa: E731

    bad = dict(batch, dense=batch["dense"].clone())
    bad["dense"][0, 0] = float("nan")
    p, s = clone(params), guarded.init(clone(params))
    p2, s2, aux = guarded.step(p, s, bad)
    assert aux["skipped_steps"] == 1 and s2["step"] == 0
    for k, a in flatten_with_paths(params).items():
        assert torch.equal(flatten_with_paths(p2)[k], a), k

    pg, _, aux = guarded.step(clone(params), guarded.init(clone(params)),
                              batch)
    pp, _, _ = plain.step(clone(params), plain.init(clone(params)), batch)
    assert aux["skipped_steps"] == 0
    for k, a in flatten_with_paths(pp).items():
        assert torch.equal(flatten_with_paths(pg)[k], a), k
