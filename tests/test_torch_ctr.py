"""The port's four CTR models against the JAX package's.

Params are initialised by JAX and carried over with
``params_from_numpy``; the same NumPy batch goes through both forwards.
Logits, loss and every gradient leaf must agree to 1e-5 (absolute, with
rtol 1e-5): both sides compute in float32 on the CPU and differ only in
summation order. The bf16 bar is the JAX package's own
(tests/test_engine.py): final AUC within 2e-3 of float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ctr as jax_ctr
from repro.models import embedding as jax_embedding
from repro.train import metrics as jax_metrics
from repro_torch.core.scaling import scale_hyperparams
from repro_torch.core.tree import flatten_with_paths, tree_map
from repro_torch.data import make_ctr_dataset
from repro_torch.embed import store_for
from repro_torch.models import ctr, embedding
from repro_torch.train import metrics, train_ctr
from repro_torch.train.checkpoint import params_from_numpy

VOCABS = (300, 1000, 50, 20, 7)
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(name, **kw):
    common = dict(name=name, vocab_sizes=VOCABS, n_dense=4, emb_dim=8,
                  mlp_dims=(32, 32, 32), emb_sigma=1e-2, **kw)
    return jax_ctr.CTRConfig(**common), ctr.CTRConfig(**common)


def _batch(n=256, seed=0):
    ds = make_ctr_dataset(n, VOCABS, n_dense=4, zipf_a=1.1, seed=seed)
    return ds.ids, ds.dense, ds.labels


@pytest.mark.parametrize("name", ctr.MODEL_NAMES)
def test_torch_ctr_forward_backward_matches_jax(name):
    cfg_j, cfg_t = _cfgs(name)
    params_j = jax_ctr.init(jax.random.key(1), cfg_j)
    params_t = params_from_numpy(jax.tree.map(np.asarray, params_j),
                                 device="cpu")
    ids, dense, labels = _batch()

    def loss_j(p):
        logits = jax_ctr.apply(p, cfg_j, jnp.asarray(ids), jnp.asarray(dense))
        return jax_metrics.logloss(logits, jnp.asarray(labels)), logits

    (l_j, logits_j), g_j = jax.value_and_grad(loss_j, has_aux=True)(params_j)

    view = tree_map(lambda p: p.clone().requires_grad_(), params_t)
    logits_t = ctr.apply(view, cfg_t, torch.from_numpy(ids),
                         torch.from_numpy(dense))
    l_t = metrics.logloss(logits_t, torch.from_numpy(labels))
    l_t.backward()

    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), **TOL)
    np.testing.assert_allclose(float(l_t.detach()), float(l_j), **TOL)
    grads_t = flatten_with_paths(tree_map(lambda p: p.grad.numpy(), view))
    grads_j = flatten_with_paths(jax.tree.map(np.asarray, g_j))
    assert grads_t.keys() == grads_j.keys()
    for k in grads_j:
        np.testing.assert_allclose(grads_t[k], grads_j[k], err_msg=k, **TOL)


@pytest.mark.parametrize("name", ctr.MODEL_NAMES)
def test_torch_ctr_init_tree_matches_jax(name):
    """The port's own init draws other numbers but builds the same tree:
    same keys, shapes and dtypes, and the same init scales."""
    cfg_j, cfg_t = _cfgs(name)
    flat_j = flatten_with_paths(
        jax.tree.map(np.asarray, jax_ctr.init(jax.random.key(0), cfg_j)))
    flat_t = flatten_with_paths(ctr.init(cfg_t, seed=0, device="cpu"))
    assert flat_t.keys() == flat_j.keys()
    for k, a in flat_j.items():
        t = flat_t[k].numpy()
        assert t.shape == a.shape and t.dtype == a.dtype, k
        if a.size > 100:
            assert t.std() == pytest.approx(a.std(), rel=0.2), k


def test_torch_ctr_bf16_logits_and_grads_stay_f32():
    _, cfg = _cfgs("deepfm", compute_dtype="bfloat16")
    params = ctr.init(cfg, seed=0, device="cpu")
    ids, dense, _ = _batch(64)
    view = tree_map(lambda p: p.clone().requires_grad_(), params)
    logits = ctr.apply(view, cfg, torch.from_numpy(ids),
                       torch.from_numpy(dense))
    assert logits.dtype == torch.float32
    logits.sum().backward()
    assert all(p.grad.dtype == torch.float32
               for p in flatten_with_paths(view).values())


def test_torch_ctr_bf16_auc_within_tolerance():
    """bf16 training matches f32 final AUC within 2e-3 (fused placement,
    two epochs, the JAX package's harness sizes)."""
    ds = make_ctr_dataset(12_000, (300, 1000, 50), n_dense=4, zipf_a=1.15,
                          seed=0)
    tr, te = ds.split(0.9)
    hp = scale_hyperparams("cowclip", base_lr=1e-3, base_l2=1e-5,
                           base_batch=512, batch_size=512,
                           base_dense_lr=2e-3)
    aucs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = ctr.CTRConfig(name="deepfm", vocab_sizes=(300, 1000, 50),
                            n_dense=4, emb_dim=8, mlp_dims=(32, 32, 32),
                            emb_sigma=1e-2, compute_dtype=dtype)
        bundle = store_for(cfg, path="fused").make_bundle(cfg, hp)
        res = train_ctr(cfg, None, tr, te, batch_size=512, epochs=2, seed=0,
                        step_bundle=bundle, device="cpu")
        aucs[dtype] = res.final_eval["auc"]
    assert aucs["float32"] > 0.55, aucs   # it learned something
    assert abs(aucs["bfloat16"] - aucs["float32"]) <= 2e-3, aucs


@pytest.mark.parametrize("case", ["in_range", "out_of_range"])
def test_torch_field_counts_match_jax(case):
    """The fused step's per-field counts equal JAX's ``segment_sum`` bit for
    bit: ids outside ``[0, vocab)`` (``vocab``, ``vocab + 5``, ``-1``) are
    dropped, not counted in a longer vector; in range they equal
    ``bincount``. Every field's counts are contiguous and 16-byte aligned
    (the fused kernel's fast path)."""
    rng = np.random.default_rng(3)
    ids = np.stack([rng.integers(0, v, size=64) for v in VOCABS], axis=1)
    if case == "out_of_range":
        ids[:3] = np.stack([VOCABS, np.add(VOCABS, 5), np.full(5, -1)])
        ids[3:6, 1] = [-1, VOCABS[1], VOCABS[1] + 5]
    ids = ids.astype(np.int32)
    got = embedding.field_counts(torch.from_numpy(ids), VOCABS)
    want = jax_embedding.field_counts(jnp.asarray(ids), VOCABS)
    assert got.keys() == want.keys()
    for i, (f, c) in enumerate(got.items()):
        assert c.dtype == torch.float32 and c.shape == (VOCABS[i],)
        assert c.is_contiguous() and c.data_ptr() % 16 == 0
        np.testing.assert_array_equal(c.numpy(), np.asarray(want[f]))
        if case == "in_range":
            assert torch.equal(c, torch.bincount(
                torch.from_numpy(ids[:, i]), minlength=VOCABS[i]).float())
    assert sum(float(c.sum()) for c in got.values()) == (
        64 * len(VOCABS) if case == "in_range" else 64 * len(VOCABS) - 18)
