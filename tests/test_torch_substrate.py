"""The port's substrate placement and the rest of ``core`` against the JAX
package's.

Each gradient transformation (``lazy_coupled_adam``, the six Table-7
clips, ``global_norm``, ``clip_by_global_norm``, ``partition``, ``sgd``,
``adam``, ``cosine_decay``, ``two_group``) runs on the same numpy inputs in
both packages, its updates and state within 1e-6 (f32 on the CPU, the
same op order; sums of a whole table in another order). Then the
substrate train step (``make_train_step`` through ``build_optimizer``)
over 5 steps from the same params and batches, for the four models, the
clip kinds and the ``cfg.sparse`` forward, within 1e-5 (the reference's
exactness bar); ``train_ctr`` with a bare optimizer; the on-device AUC.
Within the port: substrate == fused == flushed sparse (rtol 1e-5 / atol
1e-8, as the JAX package's ``test_fused_train_step_matches_substrate``,
rows absent from every batch bitwise); the scan engine == the eager one
bit for bit; the guard's skip; the CLI.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_optimizer as jax_build_optimizer
from repro.core import optim as jax_optim
from repro.core import scale_hyperparams as jax_scale_hyperparams
from repro.core import schedules as jax_schedules
from repro.core.builders import label_params as jax_label_params
from repro.core.builders import two_group as jax_two_group
from repro.core.cowclip import make_clip_transform as jax_make_clip
from repro.models import ctr as jax_ctr
from repro.train import metrics as jax_metrics
from repro.train import train_ctr as jax_train_ctr
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch.core import (build_optimizer, build_train_step, label_params,
                              make_clip_transform, optim, schedules,
                              two_group)
from repro_torch.core.cowclip import CLIP_KINDS
from repro_torch.core.scaling import scale_hyperparams
from repro_torch.core.tree import flatten_with_paths, tree_map
from repro_torch.data import iterate_batches, make_ctr_dataset
from repro_torch.data.prefetch import chunk_epoch
from repro_torch.embed import store_for
from repro_torch.models import ctr
from repro_torch.train import engine as engine_lib
from repro_torch.train import metrics, train_ctr
from repro_torch.train.checkpoint import params_from_numpy
from repro_torch.train.loop import make_train_step

REPO = Path(__file__).resolve().parents[1]
VOCABS = (2000, 700, 120, 30, 5)
BATCH = 512
K = 5
WARMUP = 3
TOL6 = dict(rtol=1e-6, atol=1e-6)
TOL5 = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _assert_trees_close(tree_t, tree_j, what, tol=TOL6):
    flat_t = flatten_with_paths(tree_map(_np, tree_t))
    flat_j = flatten_with_paths(jax.tree.map(np.asarray, tree_j))
    assert flat_t.keys() == flat_j.keys(), what
    for k in flat_j:
        np.testing.assert_allclose(flat_t[k], flat_j[k], err_msg=f"{what}: {k}",
                                   **tol)


def _to_t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_j(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# the transforms, one by one
# ---------------------------------------------------------------------------


def _tables(seed, zero_rows=True):
    """Embedding-like params, grads and counts: two fields' [vocab, 4]
    tables and a 1-dim LR table, some rows absent (count 0, gradient 0)."""
    rng = np.random.default_rng(seed)
    shapes = {"f0": (20, 4), "f1": (7, 4), "lin": (9, 1)}
    params = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()}
    counts = {k: (rng.integers(0, 4, s[0])
                  * (rng.random(s[0]) < 0.6)).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: (0.05 * rng.standard_normal(s)).astype(np.float32)
             for k, s in shapes.items()}
    if zero_rows:
        grads = {k: g * (counts[k] > 0)[:, None] for k, g in grads.items()}
    return params, grads, counts


def _run_tx(tx_t, tx_j, steps, seed, with_counts=True):
    """``steps`` updates of both transforms on the same inputs (new grads
    each step, params moved by the updates): updates and state within
    1e-6 after every step."""
    params, _, counts = _tables(seed)
    p_t, p_j = _to_t(params), _to_j(params)
    s_t, s_j = tx_t.init(p_t), tx_j.init(p_j)
    for i in range(steps):
        _, grads, _ = _tables(seed + 100 + i)
        grads = {k: g * (counts[k] > 0)[:, None] for k, g in grads.items()}
        extra_t = dict(counts=_to_t(counts)) if with_counts else {}
        extra_j = dict(counts=_to_j(counts)) if with_counts else {}
        u_t, s_t = tx_t.update(_to_t(grads), s_t, p_t, **extra_t)
        u_j, s_j = tx_j.update(_to_j(grads), s_j, p_j, **extra_j)
        _assert_trees_close(u_t, u_j, f"updates, step {i + 1}")
        _assert_trees_close(s_t, s_j, f"state, step {i + 1}")
        p_t, p_j = optim.apply_updates(p_t, u_t), jax_optim.apply_updates(
            p_j, u_j)
    return p_t, s_t


@pytest.mark.parametrize("lr", ["constant", "schedule"])
def test_torch_lazy_coupled_adam_matches_jax(lr):
    """3 steps with absent rows: touched rows take coupled-L2 Adam, absent
    rows w * (1 - lr*l2) with m, v held (bitwise fl(w * factor) after
    ``apply_updates``, the fused kernel's value); the counter a 0-dim
    int32 tensor."""
    lr_t = (1e-2 if lr == "constant"
            else schedules.linear_warmup(1e-2, 4))
    lr_j = (1e-2 if lr == "constant"
            else jax_schedules.linear_warmup(1e-2, 4))
    tx_t = optim.lazy_coupled_adam(lr_t, 1e-2)
    tx_j = jax_optim.lazy_coupled_adam(lr_j, 1e-2)
    params, _, counts = _tables(1)
    p_t, s_t = _run_tx(tx_t, tx_j, 3, seed=1)
    assert s_t.count.dtype == torch.int32 and s_t.count.dim() == 0
    assert int(s_t.count) == 3
    if lr == "constant":
        factor = np.float32(optim.decay_factor(1e-2, 1e-2))
        for k, w in params.items():
            absent = counts[k] == 0
            want = w[absent]
            for _ in range(3):
                want = (want * factor).astype(np.float32)
            np.testing.assert_array_equal(_np(p_t[k])[absent], want)
    with pytest.raises(ValueError, match="counts"):
        tx_t.update(_to_t(params), tx_t.init(_to_t(params)), _to_t(params))


@pytest.mark.parametrize("kind", CLIP_KINDS)
def test_torch_clip_kinds_match_jax(kind):
    """The six Table-7 clips (clip_t 0.05, so the constant ones clip)."""
    tx_t = make_clip_transform(kind, r=1.0, zeta=1e-3, clip_t=0.05)
    tx_j = jax_make_clip(kind, r=1.0, zeta=1e-3, clip_t=0.05)
    _run_tx(tx_t, tx_j, 1, seed=2)


def test_torch_global_norm_and_clip_by_global_norm_match_jax():
    _, grads, _ = _tables(3, zero_rows=False)
    np.testing.assert_allclose(
        _np(optim.global_norm(_to_t(grads))),
        np.asarray(jax_optim.global_norm(_to_j(grads))), **TOL6)
    assert float(optim.global_norm({})) == 0.0
    for max_norm in (0.1, 100.0):          # clips, then does not
        _run_tx(optim.clip_by_global_norm(max_norm),
                jax_optim.clip_by_global_norm(max_norm), 1, seed=3,
                with_counts=False)


@pytest.mark.parametrize("which", ["sgd", "sgd_l2", "adam", "adam_l2_sched"])
def test_torch_sgd_and_adam_match_jax(which):
    make = {
        "sgd": lambda o, s: o.sgd(0.1),
        "sgd_l2": lambda o, s: o.sgd(0.1, l2=1e-2),
        "adam": lambda o, s: o.adam(1e-2),
        "adam_l2_sched": lambda o, s: o.adam(
            s.cosine_decay(1e-2, 6, warmup_steps=2, floor=0.1), l2=1e-3),
    }[which]
    _run_tx(make(optim, schedules), make(jax_optim, jax_schedules), 3,
            seed=4, with_counts=False)


def test_torch_partition_matches_jax():
    """Two labelled groups (embed: sgd, dense: adam with L2) over
    ``label_params``' split, 3 steps."""
    rng = np.random.default_rng(5)
    params = {"embed": {"f0": rng.standard_normal((6, 3)).astype(np.float32)},
              "dense": {"w": rng.standard_normal((3, 2)).astype(np.float32),
                        "b": np.zeros(2, np.float32)}}
    assert label_params(_to_t(params)) == jax_label_params(params)
    tx_t = optim.partition({"embed": optim.sgd(0.1),
                            "dense": optim.adam(1e-2, l2=1e-3)},
                           label_params)
    tx_j = jax_optim.partition({"embed": jax_optim.sgd(0.1),
                                "dense": jax_optim.adam(1e-2, l2=1e-3)},
                               jax_label_params)
    p_t, p_j = _to_t(params), _to_j(params)
    s_t, s_j = tx_t.init(p_t), tx_j.init(p_j)
    for i in range(3):
        g = jax.tree.map(
            lambda a, i=i: (np.cos(a * (i + 1))).astype(np.float32), params)
        u_t, s_t = tx_t.update(_to_t(g), s_t, p_t)
        u_j, s_j = tx_j.update(_to_j(g), s_j, p_j)
        _assert_trees_close(u_t, u_j, f"partition updates, step {i + 1}")
        p_t = optim.apply_updates(p_t, u_t)
        p_j = jax_optim.apply_updates(p_j, u_j)
    adam_t = s_t.inner_states["dense"][1]
    assert int(adam_t.count) == 3 and adam_t.mu["embed"]["f0"] is None


def test_torch_cosine_decay_matches_jax():
    for args in ((1e-2, 10, 0, 0.0), (3e-3, 50, 7, 0.1), (1.0, 1, 3, 0.5)):
        s_t = schedules.cosine_decay(*args)
        s_j = jax_schedules.cosine_decay(*args)
        for c in range(0, 60, 3):
            got = s_t(torch.tensor(c, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(
                _np(got), np.asarray(s_j(jnp.asarray(c, jnp.int32))),
                **TOL6, err_msg=f"{args} at {c}")


def test_torch_two_group_routes_counts_to_the_embed_group():
    """``counts`` reach the embed group's chain (CowClip + lazy Adam) and
    never the dense one (a dense transform that refuses them); updates and
    state equal JAX's two_group."""
    def no_counts(mod):
        def update(u, s, p=None, **extras):
            assert "counts" not in extras
            return u, s
        return mod.GradientTransformation(lambda p: mod.EmptyState(), update)

    def build(mod, cc_mod, tg):
        embed = mod.chain(cc_mod("adaptive_column", zeta=1e-3),
                          mod.lazy_coupled_adam(1e-2, 1e-3))
        return tg(embed, mod.chain(no_counts(mod), mod.adam(1e-2)))

    tx_t = build(optim, make_clip_transform, two_group)
    tx_j = build(jax_optim, jax_make_clip, jax_two_group)
    params, _, counts = _tables(6)
    rng = np.random.default_rng(6)
    tree = {"embed": params, "dense": {"w": rng.standard_normal(
        (4, 3)).astype(np.float32)}}
    p_t, p_j = _to_t(tree), _to_j(tree)
    s_t, s_j = tx_t.init(p_t), tx_j.init(p_j)
    for i in range(2):
        g = jax.tree.map(lambda a: (0.1 * np.sin(a + i)).astype(np.float32),
                         tree)
        u_t, s_t = tx_t.update(_to_t(g), s_t, p_t, counts=_to_t(counts))
        u_j, s_j = tx_j.update(_to_j(g), s_j, p_j, counts=_to_j(counts))
        _assert_trees_close(u_t, u_j, f"two_group updates, step {i + 1}")
        _assert_trees_close(s_t, s_j, f"two_group state, step {i + 1}")
        p_t = optim.apply_updates(p_t, u_t)
        p_j = jax_optim.apply_updates(p_j, u_j)


# ---------------------------------------------------------------------------
# the substrate train step against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset():
    return make_ctr_dataset(K * BATCH * 10 // 9 + 64, VOCABS, n_dense=4,
                            zipf_a=1.1, seed=2)


def _common(name, sparse=False):
    return dict(name=name, vocab_sizes=VOCABS, n_dense=4, emb_dim=8,
                mlp_dims=(32, 32, 32), emb_sigma=1e-2, sparse=sparse)


def _hkw(l2=1e-5):
    return dict(base_lr=1e-3, base_l2=l2, base_batch=256, batch_size=BATCH,
                base_dense_lr=2e-3)


SUBSTRATE_CASES = [(m, "adaptive_column", False) for m in ctr.MODEL_NAMES] \
    + [(m, "none", False) for m in ctr.MODEL_NAMES] \
    + [("deepfm", k, False) for k in ("global", "field", "column",
                                      "adaptive_field")] \
    + [("deepfm", "adaptive_column", True), ("wd", "none", True)]


@pytest.mark.parametrize("name,clip,sparse", SUBSTRATE_CASES)
def test_torch_substrate_steps_match_jax(dataset, name, clip, sparse):
    """5 substrate steps (``build_optimizer`` + ``make_train_step``, dense
    warmup on) from the same params over the same batches: losses and
    params within 1e-5 after every step."""
    cfg_j = jax_ctr.CTRConfig(**_common(name, sparse))
    cfg_t = ctr.CTRConfig(**_common(name, sparse))
    okw = dict(clip_kind=clip, zeta=1e-5, clip_t=0.5, warmup_steps=WARMUP)
    tx_j = jax_build_optimizer(jax_scale_hyperparams("cowclip", **_hkw()),
                               **okw)
    tx_t = build_optimizer(scale_hyperparams("cowclip", **_hkw()), **okw)
    step_j, step_t = jax_make_train_step(cfg_j, tx_j), make_train_step(
        cfg_t, tx_t)
    params_j = jax_ctr.init(jax.random.key(3), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    state_j, state_t = tx_j.init(params_j), tx_t.init(params_t)
    tr, _ = dataset.split(0.9)
    batches = list(iterate_batches(tr, BATCH, seed=0))[:K]
    assert len(batches) == K
    for i, b in enumerate(batches):
        params_j, state_j, aux_j = step_j(
            params_j, state_j, {k: jnp.asarray(v) for k, v in b.items()})
        params_t, state_t, aux_t = step_t(
            params_t, state_t, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(aux_t["loss"]),
                                   float(aux_j["loss"]), **TOL5)
        _assert_trees_close(params_t, params_j, f"step {i + 1}", TOL5)
    assert int(state_t[0][-1].count) == K


def test_torch_train_ctr_bare_tx_matches_jax(dataset):
    """``train_ctr(cfg, tx, ...)`` with no bundle (the substrate) from the
    same params: final params, AUC and logloss within 1e-5."""
    cfg_j = jax_ctr.CTRConfig(**_common("deepfm"))
    cfg_t = ctr.CTRConfig(**_common("deepfm"))
    tx_j = jax_build_optimizer(jax_scale_hyperparams("cowclip", **_hkw()),
                               warmup_steps=WARMUP)
    tx_t = build_optimizer(scale_hyperparams("cowclip", **_hkw()),
                           warmup_steps=WARMUP)
    tr, te = dataset.split(0.9)
    # JAX's train_ctr draws its own params from the seed; start the port
    # from the same ones
    params_j = jax_ctr.init(jax.random.key(0), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    res_j = jax_train_ctr(cfg_j, tx_j, tr, te, batch_size=BATCH, seed=0,
                          max_steps=K, engine="eager")
    res_t = train_ctr(cfg_t, tx_t, tr, te, batch_size=BATCH, seed=0,
                      max_steps=K,
                      init_state=(params_t, tx_t.init(params_t)))
    assert res_t.steps == res_j.steps == K
    _assert_trees_close(res_t.params, res_j.params, "train_ctr", TOL5)
    for key in ("auc", "logloss"):
        assert abs(res_t.final_eval[key] - res_j.final_eval[key]) <= 1e-5, key
    # without init_state it draws and trains its own params
    res = train_ctr(cfg_t, tx_t, tr, te, batch_size=BATCH, seed=0,
                    max_steps=2, device="cpu")
    assert res.steps == 2 and np.isfinite(res.final_eval["logloss"])


def test_torch_metrics_auc_matches_jax_and_numpy():
    """The on-device AUC (midranks for ties) against JAX's ``auc`` and
    ``auc_numpy``, at the bar of the JAX package's
    ``test_auc_jnp_vs_numpy_agree`` (abs 1e-6), ties injected; a 0-dim
    tensor on the scores' device."""
    rng = np.random.default_rng(0)
    for n in (500, 4097):
        scores = rng.normal(size=n)
        scores[::7] = scores[0]
        scores[1::13] = scores[5]
        labels = rng.integers(0, 2, n).astype(np.float64)
        got = metrics.auc(torch.from_numpy(scores.astype(np.float32)),
                          torch.from_numpy(labels))
        assert got.dim() == 0
        want_np = metrics.auc_numpy(scores.astype(np.float32), labels)
        want_j = float(jax_metrics.auc(jnp.asarray(scores, jnp.float32),
                                       jnp.asarray(labels)))
        assert float(got) == pytest.approx(want_np, abs=1e-6)
        assert float(got) == pytest.approx(want_j, abs=1e-6)
    assert float(metrics.auc(torch.ones(4), torch.ones(4))) == 0.0


# ---------------------------------------------------------------------------
# within the port: placements, engines, guard, CLI
# ---------------------------------------------------------------------------


def _placement_run(cfg, hp, path, params0, batches, steps):
    bundle = build_train_step(dataclasses.replace(
        cfg, placement=path, sparse=path == "sparse"), hp, path=path)
    p = tree_map(torch.clone, params0)
    s = bundle.init(p)
    for b in batches[:steps]:
        p, s, _ = bundle.step(p, s, b)
    p, _ = bundle.flush(p, s)
    return p


@pytest.mark.parametrize("steps", [1, 3])
def test_torch_substrate_fused_sparse_agree(dataset, steps):
    """Substrate, fused and flushed sparse from the same params over the
    same batches, embedding l2 on: every embedding table within rtol 1e-5 /
    atol 1e-8; the rows no batch touched are fl(w * factor) per step,
    bitwise equal in substrate and fused (and in sparse after one step;
    after more its closed-form catch-up w * factor**k rounds once, not
    per step)."""
    cfg = ctr.CTRConfig(**_common("deepfm"))
    hp = scale_hyperparams("cowclip", **_hkw(l2=1e-3))
    params0 = ctr.init(cfg, seed=5, device="cpu")
    tr, _ = dataset.split(0.9)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in list(iterate_batches(tr, BATCH, seed=9))[:steps]]
    runs = {path: _placement_run(cfg, hp, path, params0, batches, steps)
            for path in ("substrate", "fused", "sparse")}
    touched = [torch.zeros(v, dtype=torch.bool) for v in VOCABS]
    for b in batches:
        for i, t in enumerate(touched):
            t[b["ids"][:, i].long()] = True
    n_absent = 0
    for group in ("fm", "lin"):
        for i in range(len(VOCABS)):
            f = f"field_{i}"
            sub = runs["substrate"]["embed"][group][f]
            for other in ("fused", "sparse"):
                got = runs[other]["embed"][group][f]
                np.testing.assert_allclose(_np(got), _np(sub), rtol=1e-5,
                                           atol=1e-8,
                                           err_msg=f"{other} {group}/{f}")
            absent = ~touched[i]     # none in the smallest fields
            n_absent += int(absent.sum())
            assert torch.equal(runs["fused"]["embed"][group][f][absent],
                               sub[absent])
            if steps == 1:
                assert torch.equal(runs["sparse"]["embed"][group][f][absent],
                                   sub[absent])


@pytest.mark.parametrize("max_steps", [None, 7])
def test_torch_substrate_scan_equals_eager(dataset, max_steps):
    """``train_ctr`` through the substrate over 2 epochs at scan_steps 3 (a
    tail chunk each epoch), and with a max_steps cut inside a chunk: the
    scan engine's params, state, losses and eval equal the eager engine's
    bit for bit."""
    cfg = dataclasses.replace(ctr.CTRConfig(**_common("deepfm")),
                              placement="substrate")
    hp = scale_hyperparams("cowclip", **_hkw())
    tr, te = dataset.split(0.9)
    params0 = ctr.init(cfg, seed=4, device="cpu")
    results = {}
    for eng in ("eager", "scan"):
        bundle = store_for(cfg).make_bundle(cfg, hp, warmup_steps=WARMUP)
        params = tree_map(torch.clone, params0)
        results[eng] = train_ctr(
            cfg, None, tr, te, batch_size=BATCH, epochs=2, seed=0,
            step_bundle=bundle, max_steps=max_steps, engine=eng,
            scan_steps=3, init_state=(params, bundle.init(params)))
    a, b = results["eager"], results["scan"]
    assert a.steps == b.steps == (max_steps or 2 * (len(tr) // BATCH))
    assert a.losses == b.losses
    fa = flatten_with_paths((a.params, a.opt_state))
    fb = flatten_with_paths((b.params, b.opt_state))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k
    assert a.final_eval["auc"] == b.final_eval["auc"]


def test_torch_substrate_guard_skips_and_replays(dataset):
    """Under nonfinite_guard a chunk of 4 batches, the second poisoned,
    through the runner equals the same guarded steps one by one, bit for
    bit; the poisoned step leaves every leaf as it was (step counters
    included); over clean batches the guarded step equals the unguarded
    one."""
    cfg = ctr.CTRConfig(**_common("deepfm"))
    hp = scale_hyperparams("cowclip", **_hkw())
    make = lambda guard: build_train_step(  # noqa: E731
        cfg, hp, path="substrate", warmup_steps=2, nonfinite_guard=guard)
    chunk = next(chunk_epoch(dataset, BATCH, 4, seed=5))
    params0 = ctr.init(cfg, seed=3, device="cpu")

    def eager(bundle, chunk):
        p = tree_map(torch.clone, params0)
        s = bundle.init(p)
        skipped, unchanged = [], True
        for i in range(4):
            before = flatten_with_paths(tree_map(torch.clone, (p, s)))
            p, s, aux = bundle.step(
                p, s, {k: torch.from_numpy(v[i]) for k, v in chunk.items()})
            skipped.append(int(aux.get("skipped_steps", 0)))
            if skipped[-1]:
                after = flatten_with_paths((p, s))
                unchanged = all(torch.equal(before[k], after[k])
                                for k in before)
        return flatten_with_paths((p, s)), skipped, unchanged

    clean_plain, _, _ = eager(make(False), chunk)
    clean_guard, skipped, _ = eager(make(True), chunk)
    assert skipped == [0, 0, 0, 0]
    for k in clean_plain:
        assert torch.equal(clean_plain[k], clean_guard[k]), k

    chunk["dense"][1, 0, 0] = np.nan
    bundle = make(True)
    want, skipped, unchanged = eager(bundle, chunk)
    assert skipped == [0, 1, 0, 0] and unchanged
    p = tree_map(torch.clone, params0)
    s = bundle.init(p)
    runner = engine_lib.make_chunk_runner(engine_lib.resolve_scan_step(bundle))
    p, s, aux = runner(p, s, chunk)
    assert int(aux["skipped_steps"].sum()) == 1
    got = flatten_with_paths((p, s))
    for k in want:
        assert torch.equal(want[k], got[k]), k
    counts = [v for k, v in got.items() if k.endswith("count")]
    assert counts and all(int(c) == 3 for c in counts)


def test_torch_cli_substrate_on_cpu():
    """``--placement substrate --device cpu`` trains through the CLI, with
    each engine, without importing JAX."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "runpy.run_module('repro_torch.launch.train', "
            "run_name='__main__')")
    for engine in ("scan", "eager"):
        out = subprocess.run(
            [sys.executable, "-c", code, "--task", "ctr", "--placement",
             "substrate", "--device", "cpu", "--samples", "4096", "--batch",
             "512", "--steps", "3", "--engine", engine, "--scan-steps", "2"],
            env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
        assert out.returncode == 0, out.stderr
        assert "embedding store dense(substrate)" in out.stdout
        assert "[train] done: 3 steps" in out.stdout
